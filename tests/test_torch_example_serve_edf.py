"""The port's copy of ``examples/serve_edf.py`` against the original, on
the CPU.

The original builds its two tenants inside ``main`` and serves each
policy for 2 s on the wall clock. Loaded by path with its `PharosServer`
replaced by a recorder, it hands over the tasks it built without serving
them: their structure (names, layer shapes, stage maps, periods,
deadlines, input rows, fp32) must equal the copy's. The weights come
from another generator (numpy's seeds do not give JAX's bits), so their
values are held only to the drawing rule, N(0, 1) / sqrt(K). The copy
then serves both policies briefly on the CPU and prints the original's
lines.
"""
import contextlib
import importlib.util
import io
import math
import os
import types

import numpy as np
import torch

from repro_torch.examples import serve_edf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_tasks():
    spec = importlib.util.spec_from_file_location(
        "ref_serve_edf", os.path.join(ROOT, "examples", "serve_edf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = []

    class Recorder:
        def __init__(self, tasks, n_stages, **kwargs):
            built.append((tasks, n_stages, kwargs))
            self.tasks = tasks

        def run(self, horizon_s):
            names = [t.name for t in self.tasks]
            return types.SimpleNamespace(
                response_times={n: [] for n in names},
                deadline_misses={n: 0 for n in names},
                preemptions=0, windows_executed=0)

    mod.PharosServer = Recorder
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    return built


def test_tasks_have_the_originals_structure():
    built = _reference_tasks()
    assert [kw["policy"] for _, _, kw in built] == list(serve_edf.POLICIES)
    ref_tasks, n_stages, kwargs = built[0]
    assert n_stages == 2 and kwargs["window_tiles"] == 2
    got = serve_edf.make_tasks("cpu")
    assert len(got) == len(ref_tasks) == 2
    for t, r in zip(got, ref_tasks):
        assert t.name == r.name
        assert t.stage_of_layer == r.stage_of_layer
        assert (t.period, t.deadline, t.input_rows) == (r.period, r.deadline,
                                                        r.input_rows)
        assert [tuple(w.shape) for w in t.weights] == [
            tuple(np.asarray(w).shape) for w in r.weights]
        for w, rw in zip(t.weights, r.weights):
            assert w.dtype == torch.float32 and w.device.type == "cpu"
            assert str(np.asarray(rw).dtype) == "float32"
            want_std = 1 / math.sqrt(w.shape[0])
            assert abs(w.std().item() / want_std - 1) < 0.02
            assert abs(w.mean().item()) < 0.05 * want_std
    again = serve_edf.make_tasks("cpu")
    assert all(torch.equal(a, b) for t, u in zip(got, again)
               for a, b in zip(t.weights, u.weights))


def test_both_policies_serve_and_print_the_originals_lines():
    tasks = serve_edf.make_tasks("cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        reps = [serve_edf.serve(tasks, p, device="cpu", horizon_s=0.3)
                for p in serve_edf.POLICIES]
    lines = buf.getvalue().splitlines()
    assert [l for l in lines if l.startswith("==")] == ["== FIFO ==", "== EDF =="]
    assert sum(l.startswith("  preemptions=") for l in lines) == 2
    for rep in reps:
        assert rep.windows_executed > 0 and rep.jobs_released > 0
    for l in lines:
        if l.startswith("  perception") or l.startswith("  safety"):
            assert "jobs=" in l and "p99=" in l and "deadline_misses=" in l
