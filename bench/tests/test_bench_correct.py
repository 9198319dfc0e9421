"""``correct`` at smoke size on the CPU: a sound run passes; the control
(the reference in fp8 in the program's place) and each fault that a cell
can have, planted under the timed path, fail."""
import pytest

from bench_support import smoke_root  # noqa: F401 (fixture)
from benchkit import harness
from benchkit.spec import Spec
from calibration.faults import planted

SEEDS = (2**31 + 11, 77)


def _run(root, cell, seed):
    return harness.execute(cell, seed, 0.2, False, root=root, device="cpu")


@pytest.mark.parametrize("cell", ["smoke.smoke_train", "smoke.smoke_prefill"])
def test_sound_runs_are_correct(smoke_root, cell):
    for seed in SEEDS:
        out = _run(smoke_root, cell, seed)
        assert out["line"]["correct"] is True, out["line"]["checks"]


@pytest.mark.parametrize("cell", ["smoke.smoke_train", "smoke.smoke_prefill"])
def test_the_control_fails(smoke_root, cell):
    lim = harness.context(Spec(smoke_root), cell, 0, "cpu").limits
    for seed in SEEDS:
        ctx = harness.context(Spec(smoke_root), cell, seed, "cpu")
        numbers = dict(harness.driver_of(ctx).control())
        assert any(v > lim[n] for n, v in numbers.items()), numbers


@pytest.mark.parametrize("cell,fault", [("smoke.smoke_train", "unchanged"),
                                        ("smoke.smoke_train", "half_batch"),
                                        ("smoke.smoke_train", "half_sequence"),
                                        ("smoke.smoke_prefill", "token")])
def test_each_fault_fails(smoke_root, cell, fault):
    with planted(Spec(smoke_root), fault):
        for seed in SEEDS:
            out = _run(smoke_root, cell, seed)
            assert out["line"]["correct"] is False, (fault, out["line"]["checks"])


def test_every_seed_sends_the_same_prompt_lengths(smoke_root):
    lengths = []
    for seed in SEEDS:
        drv = harness.driver_of(harness.context(Spec(smoke_root), "smoke.smoke_prefill",
                                                seed, "cpu"))
        lengths.append([drv.next_length() for _ in range(7)])
    assert lengths[0] == lengths[1] == [16, 48, 16, 16, 48, 16, 16]


def test_half_sequence_sends_half_of_every_row(smoke_root):
    """The fault keeps every row and cuts its positions, where
    ``half_batch`` cuts the rows."""
    spec = Spec(smoke_root)
    train = spec.module("drivers", "train")
    seen = []
    real = train.make_program

    def recording(arch, opt):
        step = real(arch, opt)
        return lambda p, s, batch: seen.append(batch["tokens"].shape) or step(p, s, batch)

    train.make_program = recording
    try:
        for fault in ("half_sequence", "half_batch"):
            with planted(spec, fault):
                _run(smoke_root, "smoke.smoke_train", 5)
    finally:
        train.make_program = real
    assert seen[0] == (4, 32) and seen[-1] == (2, 64)


def test_an_unknown_fault_is_refused(smoke_root):
    with pytest.raises(ValueError, match="half_sequence"):
        with planted(Spec(smoke_root), "half_sequnce"):
            pass
