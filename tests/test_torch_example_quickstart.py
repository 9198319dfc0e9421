"""The port's copy of ``examples/quickstart.py`` against the original, on
the CPU.

The original runs as a subprocess, as a user runs it; its lines before
step 5 (live serving, on the wall clock) must equal the copy's steps 1-4
line for line, with only the beam search's own wall time masked. Then
the copy serves its design briefly on the CPU (the window kernel's plain
version).
"""
import contextlib
import io
import os
import re
import subprocess
import sys

import torch

from repro_torch.examples import quickstart

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE = "live EDF serving"


def _masked(lines):
    """The lines with the search's wall time masked, trailing blanks cut."""
    out = [re.sub(r"designs in \d+\.\d+s", "designs in <t>s", l) for l in lines]
    while out and not out[-1].strip():
        out.pop()
    return out


def test_steps_1_to_4_print_the_originals_lines():
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "quickstart.py")],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = proc.stdout.splitlines()
    cut = next(i for i, l in enumerate(ref) if l.startswith(LIVE))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best, workloads, taskset = quickstart.plan()
    got = buf.getvalue().splitlines()
    assert _masked(got) == _masked(ref[:cut])
    assert len(got) >= 11  # tasks, periods, fixed, search, best, Eq. 3, ...
    assert best.n_stages >= 2 and len(workloads) == len(taskset.tasks) == 2


def test_step_5_serves_the_design_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        best, workloads, taskset = quickstart.plan()
        tasks, rep = quickstart.serve(best, workloads, taskset, device="cpu",
                                      horizon_s=0.3)
    lines = buf.getvalue().splitlines()
    assert lines[-1].startswith("  preemptions=")
    assert f"{LIVE} (0.3s):" in lines
    assert rep.windows_executed > 0 and rep.jobs_released > 0
    assert all(w.device.type == "cpu" for t in tasks for w in t.weights)
    assert [t.name for t in tasks] == ["pointnet", "mlp_mixer"]
