"""Faults planted under the timed path, for the checks that must catch
them (``bench/tests/test_bench_correct.py`` on the CPU,
``bench/calibration/readings.py`` on the card). Each swaps a driver's
hook for the length of a ``with`` block."""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "half_sequence", "token")


@contextlib.contextmanager
def planted(spec, fault: str):
    """Within, the drivers of ``spec`` carry ``fault``:

    - ``unchanged``: the training step returns its state unchanged;
    - ``half_batch``: the training step takes the first half of the batch
      (the loss a mean over those rows);
    - ``half_sequence``: the training step takes the first half of every
      row's positions (the loss a mean over those), the fault that cuts
      the work of a batch of one;
    - ``token``: each served token is the next id after the argmax.
    """
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; the faults are {FAULTS}")
    if fault == "token":
        mod, attr = spec.module("drivers", "prefill"), "serve"
        real = mod.serve
        fake = lambda logits: (real(logits) + 1) % logits.shape[-1]  # noqa: E731
    else:
        mod, attr = spec.module("drivers", "train"), "make_program"
        real = mod.make_program

        def fake(arch, opt):
            step = real(arch, opt)

            def broken(params, opt_state, batch):
                if fault == "half_batch":
                    half = batch["tokens"].shape[0] // 2
                    return step(params, opt_state, {k: v[:half] for k, v in batch.items()})
                if fault == "half_sequence":
                    half = batch["tokens"].shape[1] // 2
                    return step(params, opt_state,
                                {k: v[:, :half] for k, v in batch.items()})
                _, _, metrics = step(params, opt_state, batch)
                return params, opt_state, metrics

            return broken
    setattr(mod, attr, fake)
    try:
        yield
    finally:
        setattr(mod, attr, real)
