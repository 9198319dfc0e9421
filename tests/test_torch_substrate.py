"""The port's training substrate against the JAX package's, on the CPU:
the data pipeline, AdamW and its schedule, the checkpoint store (each
package restoring what the other wrote) and the runtime (fault-tolerant
loop, heartbeats, stragglers, elastic re-meshing, gradient compression).

The same numpy inputs go to both packages. Tolerances, with their
reasons: data batches, checkpoints, bf16 AdamW steps, schedules and
compression payloads must be equal; fp32 AdamW steps agree to 1e-6
relative (and 1e-7 absolute, for moments near 0), the two packages'
fp32 arithmetic fusing or ordering a few products differently
(observed one ulp).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenDataset as RefDataset
from repro.data import make_batch_iterator as ref_batches
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw as ref_adamw
from repro.runtime import compress_gradients as ref_compress
from repro.runtime import plan_remesh as ref_plan_remesh
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.store import latest_step_of
from repro_torch.data import DataConfig, SyntheticTokenDataset, make_batch_iterator
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.runtime import (
    ErrorFeedbackState,
    FaultTolerantLoop,
    HeartbeatMonitor,
    StragglerMitigator,
    WorkerState,
    compress_gradients,
    decompress_gradients,
    plan_remesh,
)
from repro_torch.runtime.compression import compression_ratio
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

F32_STEP_REL = 1e-6


def _bits(x):
    """A tensor or array as comparable host bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,coherence,hosts", [
    (97, 16, 8, 0, 0.9, 1), (256, 64, 8, 3, 0.9, 2), (100352, 33, 4, 7, 1.0, 4),
])
def test_data_batches_are_the_reference_bit_for_bit(vocab, seq, batch, seed,
                                                    coherence, hosts):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
              coherence=coherence)
    for host in range(hosts):
        ours = SyntheticTokenDataset(DataConfig(**kw), host, hosts)
        ref = RefDataset(RefDataConfig(**kw), host, hosts)
        for step in (0, 1, 29, 1000):
            got, want = ours.batch(step), ref.batch(step)
            assert sorted(got) == sorted(want)
            for key in got:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key])
    it, ref_it = (make_batch_iterator(DataConfig(**kw), start_step=5),
                  ref_batches(RefDataConfig(**kw), start_step=5))
    for _ in range(3):
        (s, got), (rs, want) = next(it), next(ref_it)
        assert s == rs
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_labels_are_next_tokens_and_data_is_learnable():
    b = SyntheticTokenDataset(DataConfig(vocab=64, seq_len=64, global_batch=8,
                                         coherence=1.0)).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert ((31 * b["tokens"] + 7) % 64 == b["labels"]).mean() > 0.95


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_cosine_schedule_equals_reference():
    kw = dict(lr_peak=1.0, lr_min=0.1, warmup_steps=10, total_steps=100)
    cfg, ref_cfg = AdamWConfig(**kw), RefAdamWConfig(**kw)
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 1000):
        got = cosine_schedule(cfg, step)
        assert got.dtype == torch.float32
        assert got.item() == float(ref_adamw.cosine_schedule(ref_cfg, step))
    stepped = cosine_schedule(cfg, torch.tensor(55, dtype=torch.int32))
    assert stepped.item() == float(ref_adamw.cosine_schedule(ref_cfg, 55))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Four steps on a nested tree with a matrix, a vector and a scalar
    leaf, clipping active on the first step; bf16 leaves round their
    update and (at micro_batches 1) their clipped gradient to bf16."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 4), "b": (4,), "blocks": [{"s": ()}, {"s": (3, 2)}]}
    cfg_kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    cfg, ref_cfg = AdamWConfig(**cfg_kw), RefAdamWConfig(**cfg_kw)
    host = jax.tree_util.tree_map(
        lambda s: np.asarray(rng.normal(size=s), np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    ref_p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), host)
    ours = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), host)
    ref_s, state = ref_adamw.adamw_init(ref_p), adamw_init(ours)
    for i in range(4):
        g = jax.tree_util.tree_map(
            lambda a: np.asarray(rng.normal(size=a.shape)
                                 * (5.0 if i == 0 else 0.1), np.float32), host)
        ref_p, ref_s, ref_m = ref_adamw.adamw_update(
            ref_p, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g),
            ref_s, ref_cfg)
        ours, state, m = adamw_update(
            ours, jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), g),
            state, cfg)
        assert m["lr"].item() == float(ref_m["lr"])
        assert m["grad_norm"].item() == pytest.approx(float(ref_m["grad_norm"]),
                                                      rel=F32_STEP_REL)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 4
    for tree, ref_tree in ((ours, ref_p), (state["m"], ref_s["m"]),
                           (state["v"], ref_s["v"])):
        paths, got, _ = flatten_with_paths(tree)
        flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
        assert paths == ["/".join(str(k) for k in p) for p, _ in flat]
        for g, (_, w) in zip(got, flat):
            assert g.dtype == (tdt if tree is ours else torch.float32)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(_bits(g), _bits(w))
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=F32_STEP_REL, atol=1e-7)


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor(1.0)}
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=300,
                      weight_decay=0.0)
    state = adamw_init(params)
    lossf = lambda p: torch.sum(p["w"] ** 2) + p["b"] ** 2
    for _ in range(300):
        g = {k: 2 * v for k, v in params.items()}
        params, state, _ = adamw_update(params, g, state, cfg)
    assert float(lossf(params)) < 1e-6


def test_grad_clipping_reports_the_norm_and_decay_follows_its_mask():
    cfg = AdamWConfig(clip_norm=1.0, lr_peak=1e-3, warmup_steps=0,
                      total_steps=10, weight_decay=0.5)
    params = {"w": torch.ones(4), "m": torch.ones(2, 2)}
    huge = {"w": torch.full((4,), 1e9), "m": torch.zeros(2, 2)}
    _, _, metrics = adamw_update(params, huge, adamw_init(params), cfg)
    assert metrics["grad_norm"].item() == pytest.approx(2e9, rel=1e-6)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    by_ndim, _, _ = adamw_update(params, zero, adamw_init(params), cfg)
    assert torch.equal(by_ndim["w"], params["w"])  # a vector: not decayed
    assert (by_ndim["m"] < 1).all()
    masked, _, _ = adamw_update(params, zero, adamw_init(params), cfg,
                                decay={"w": True, "m": False})
    assert (masked["w"] < 1).all() and torch.equal(masked["m"], params["m"])
    assert global_norm(huge).item() == pytest.approx(2e9, rel=1e-6)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state():
    return {
        "p": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "h": torch.arange(4, dtype=torch.float32).to(torch.bfloat16)},
        "layers": [{"g": torch.ones(3)}, {"g": torch.full((3,), 2.0)}],
        "step": torch.tensor(3, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path):
    root = str(tmp_path)
    st = _state()
    save_checkpoint(root, 7, st)
    assert latest_step(root) == 7
    rest = restore_checkpoint(root, 7, st)
    for (p, a), (_, b) in zip(*(zip(*flatten_with_paths(t)[:2]) for t in (rest, st))):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_checkpoint_atomicity(tmp_path):
    """Uncommitted directories are invisible to latest_step."""
    root = str(tmp_path)
    save_checkpoint(root, 5, _state())
    os.makedirs(os.path.join(root, "step_000000009"))  # no COMMITTED marker
    assert latest_step(root) == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(root, 9, _state())


def test_checkpoint_structure_mismatch_fails_loud(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _state())
    other = dict(_state(), p={"DIFFERENT": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(root, 1, other)


def test_manager_retention_and_resume(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, every=2, keep=2)
    st = _state()
    for step in range(1, 9):
        mgr.maybe_save(step, st)
    kept = sorted(n for n in os.listdir(root) if n.startswith("step_"))
    assert len(kept) == 2 and kept[-1].endswith("8")
    step, _ = mgr.restore_latest(st)
    assert step == 8
    empty = CheckpointManager(str(tmp_path / "none"), every=1)
    step0, same = empty.restore_latest(st)
    assert step0 == 0 and same is st
    assert latest_step_of("step_000000042") == 42 and latest_step_of("x") is None


def _nested_numpy(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                   "emb": rng.normal(size=(5, 2)).astype(np.float32)},
        "blocks": [{"norm": rng.normal(size=(4,)).astype(np.float32)},
                   {"norm": rng.normal(size=(4,)).astype(np.float32)}],
        "step": np.array(12, np.int32),
        "ids": rng.integers(-5, 5, size=(6,)).astype(np.int32),
    }


def _as_ref(tree):
    """The reference's leaves: "emb" and the norms in bf16."""
    def leaf(path, a):
        bf16 = any(getattr(k, "key", None) in ("emb", "norm") for k in path)
        return jnp.asarray(a, jnp.bfloat16 if bf16 else a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _as_port(tree):
    ref = _as_ref(tree)
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(_bits(a).view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)), ref)


def test_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    ref_state = _as_ref(_nested_numpy(1))
    ref_save(str(tmp_path), 12, ref_state)
    like = jax.tree_util.tree_map(torch.zeros_like, _as_port(_nested_numpy(2)))
    got = restore_checkpoint(str(tmp_path), 12, like)
    paths, leaves, _ = flatten_with_paths(got)
    flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert paths == ["/".join(str(k) for k in p) for p, _ in flat]
    for g, (_, w) in zip(leaves, flat):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_port_checkpoint_restores_bit_equal_in_the_reference(tmp_path):
    ours = _as_port(_nested_numpy(3))
    save_checkpoint(str(tmp_path), 4, ours)
    like = _as_ref(_nested_numpy(4))
    got = ref_restore(str(tmp_path), 4, like)
    _, leaves, _ = flatten_with_paths(ours)
    for (_, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], leaves):
        assert str(g.dtype) == str(w.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the manifest is the one the reference writes for the same state
    ref_save(str(tmp_path / "ref"), 4, _as_ref(_nested_numpy(3)))
    import json
    metas = [json.load(open(os.path.join(r, "step_000000004", "meta.json")))
             for r in (str(tmp_path), str(tmp_path / "ref"))]
    assert metas[0] == metas[1]
    mgr, ref_mgr = CheckpointManager(str(tmp_path)), RefCheckpointManager(str(tmp_path))
    assert mgr.restore_latest(ours)[0] == ref_mgr.restore_latest(like)[0] == 4


# ---------------------------------------------------------------------------
# runtime: fault tolerance
# ---------------------------------------------------------------------------
def _step_fn(step, state):
    return {"x": state["x"] + step, "rng": state["rng"] * 31 % 10007}


def test_ft_loop_recovers_and_matches_clean_run(tmp_path):
    init = {"x": torch.tensor(0), "rng": torch.tensor(7)}
    clean, _ = FaultTolerantLoop(CheckpointManager(str(tmp_path / "clean"), every=3),
                                 _step_fn).run(init, 20)
    fail_at, seen = {5, 11, 17}, set()

    def hook(step):
        if step in fail_at and step not in seen:
            seen.add(step)
            return True
        return False

    mgr = CheckpointManager(str(tmp_path / "faulty"), every=3)
    state, report = FaultTolerantLoop(mgr, _step_fn, failure_hook=hook).run(init, 20)
    assert report.restarts == 3 and report.failures_seen == 3
    assert report.resumed_from == [3, 9, 15]
    assert int(state["x"]) == int(clean["x"]) == sum(range(20))
    assert int(state["rng"]) == int(clean["rng"])


def test_ft_loop_gives_up_after_max_restarts(tmp_path):
    loop = FaultTolerantLoop(CheckpointManager(str(tmp_path), every=100), _step_fn,
                             failure_hook=lambda s: s == 0, max_restarts=2)
    with pytest.raises(RuntimeError):
        loop.run({"x": torch.tensor(0), "rng": torch.tensor(1)}, 5)


def test_heartbeat_state_machine():
    t = [0.0]
    mon = HeartbeatMonitor(["w0", "w1"], suspect_after=5, dead_after=15,
                           clock=lambda: t[0])
    t[0] = 4.0
    assert mon.sweep()["w0"] is WorkerState.HEALTHY
    t[0] = 6.0
    assert mon.sweep()["w0"] is WorkerState.SUSPECT
    mon.beat("w0")
    assert mon.sweep()["w0"] is WorkerState.HEALTHY
    t[0] = 25.0
    assert mon.sweep()["w1"] is WorkerState.DEAD
    assert mon.dead() and mon.healthy_count() == 0


# ---------------------------------------------------------------------------
# runtime: stragglers and elastic re-meshing
# ---------------------------------------------------------------------------
def test_straggler_detection_escalation_and_recovery():
    m = StragglerMitigator(["a", "b", "c", "d"], threshold=1.5, miss_budget=3)
    for _ in range(10):
        for w in "abc":
            m.observe(w, 1.0)
        m.observe("d", 3.0)
    r1 = m.assess()
    assert r1.stragglers == ["d"] and r1.actions["d"] == "backup"
    m.assess()
    assert m.assess().actions["d"] == "exclude"
    m = StragglerMitigator(["a", "b", "c"], threshold=1.5, ewma=1.0)
    for w in "ab":
        m.observe(w, 1.0)
    m.observe("c", 5.0)
    assert m.assess().stragglers == ["c"]
    m.observe("c", 1.0)
    assert m.assess().stragglers == []


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("global_batch", [64, 256])
def test_elastic_plans_equal_reference(tp, global_batch):
    for chips in (1, 3, 7, 16, 33, 100, 200, 512):
        for old_dp in (1, 2, 8, 16):
            kw = dict(model_parallel=tp, global_batch=global_batch,
                      old_data_parallel=old_dp)
            plan = plan_remesh(chips, **kw)
            assert plan.__dict__ == ref_plan_remesh(chips, **kw).__dict__
            if plan.valid:
                assert plan.chips_used <= chips and global_batch % plan.data_parallel == 0
                assert plan.data_parallel * plan.grad_accumulation >= old_dp


# ---------------------------------------------------------------------------
# runtime: gradient compression
# ---------------------------------------------------------------------------
def test_compression_payload_equals_reference():
    rng = np.random.default_rng(5)
    g = {"w": np.linspace(-3, 3, 256).astype(np.float32).reshape(16, 16),
         "b": [rng.normal(size=(7,)).astype(np.float32)]}
    ef = {"w": (rng.normal(size=(16, 16)) * 1e-2).astype(np.float32),
          "b": [(rng.normal(size=(7,)) * 1e-2).astype(np.float32)]}
    from repro.runtime import ErrorFeedbackState as RefEF
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    for with_ef in (False, True):
        payload, new_ef = compress_gradients(
            to_t(g), ErrorFeedbackState(to_t(ef)) if with_ef else None)
        ref_payload, ref_ef = ref_compress(
            to_j(g), RefEF(to_j(ef)) if with_ef else None)
        for key in ("q", "scale"):
            got = flatten_with_paths(payload[key])[1]
            want = jax.tree_util.tree_leaves(ref_payload[key])
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(flatten_with_paths(new_ef.residual)[1],
                        jax.tree_util.tree_leaves(ref_ef.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    payload, _ = compress_gradients(to_t(g))
    rec = decompress_gradients(payload)
    assert payload["q"]["w"].dtype == torch.int8
    err = float((rec["w"] - torch.from_numpy(g["w"])).abs().max())
    assert err <= float(np.abs(g["w"]).max()) / 127.0 + 1e-6
    assert compression_ratio(to_t(g)) > 3.5


def test_error_feedback_preserves_mean_signal():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=32).astype(np.float32)) * 1e-3
    ef = ErrorFeedbackState.init({"w": g})
    total_true, total_sent = torch.zeros(32), torch.zeros(32)
    for i in range(50):
        gi = {"w": g * (1 + 0.1 * i)}
        payload, ef = compress_gradients(gi, ef)
        total_sent += decompress_gradients(payload)["w"]
        total_true += gi["w"]
    gap = float((total_sent - total_true).abs().max())
    assert gap <= float(ef.residual["w"].abs().max()) + 1e-6
