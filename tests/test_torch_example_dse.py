"""The port's copy of ``examples/dse_pipeline.py`` against the original,
on the CPU.

The original runs as a subprocess, as a user runs it (it sets its own
``XLA_FLAGS``). Its steps 1-4 (the LM's task view, the DSE, the TG
baseline, `provision`) must print the copy's lines, with only the
search's candidates-per-second figure masked. Its step 5 is not awaited:
under JAX 0.9.0 the original's SPMD executor raises there, so the test
takes its stdout whatever its exit code. The copy's step 5 runs the same
4-layer bf16 Minitron (4 heads of 32) as 4 gloo stage ranks on the CPU
and must give `reference_backbone`'s output exactly: error 0.
"""
import contextlib
import io
import os
import re
import subprocess
import sys

import torch

from repro_torch.examples import dse_pipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masked(lines):
    out = [re.sub(r"\([\d,]+ candidates/s batched\)", "(<n> candidates/s batched)", l)
           for l in lines]
    while out and not out[-1].strip():
        out.pop()
    return out


def test_steps_1_to_4_print_the_originals_lines():
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "dse_pipeline.py")],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600,
    )
    ref = proc.stdout.splitlines()
    cut = next((i for i, l in enumerate(ref) if l.startswith("SPMD pipeline")),
               len(ref))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best = dse_pipeline.plan(device="cpu")
    got = buf.getvalue().splitlines()
    assert best is not None
    assert any(l.startswith("provisioned steady_city") for l in got)
    assert _masked(got) == _masked(ref[:cut]), proc.stderr[-2000:]


def test_step_5_pipeline_on_gloo_cpu_ranks_has_error_zero():
    case = dse_pipeline.pipeline_case()
    assert (case.cfg.n_layers, case.cfg.d_model, case.cfg.n_heads,
            case.cfg.head_dim, case.dtype) == (4, 128, 4, 32, torch.bfloat16)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        err, ranks = dse_pipeline.run_pipeline(case, device="cpu", timeout=300.0)
    assert err == 0.0
    assert buf.getvalue().strip().endswith("max err vs sequential = 0.00e+00")
    out = ranks[-1]["out"]
    assert tuple(out.shape) == (8, 2, 32, 128) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert [r["layers"] for r in ranks] == [1, 1, 1, 1]
