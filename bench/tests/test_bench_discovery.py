"""A cell and a metric that exist only as files in another directory are
found by name and run, through the plain path on the CPU."""
import json

from bench_support import write_root
from benchkit.harness import execute

CALLS = '''"""Calls completed in the window (a count the run keeps)."""


def read(run):
    return float(len(run.calls))
'''


def test_cell_and_metric_defined_elsewhere_are_found_and_run(tmp_path):
    metrics = [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                "source": "host_clock"},
               {"name": "calls_done", "unit": "calls", "better": "higher",
                "bound": 0.05, "source": "program_counter"}]
    root = write_root(tmp_path, metrics=metrics, extra_metric_files={"calls_done": CALLS})
    out = execute("smoke.smoke_prefill", 11, 0.3, False, root=root, device="cpu")
    line = out["line"]
    assert set(line["metrics"]) == {"setup_s", "calls_done"}
    assert line["metrics"]["calls_done"]["value"] == len(out["run"].calls) >= 1
    assert line["correct"] is True
    # the cell's pieces came from the other directory
    doc = json.loads((root / "BENCHMARK.json").read_text())
    assert [c["name"] for c in doc["workloads"]] == ["smoke.smoke_train",
                                                     "smoke.smoke_prefill"]


def test_a_metric_without_workloads_follows_the_metric_it_moves(tmp_path):
    root = write_root(tmp_path)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"] = [{"name": "calls_done", "unit": "calls", "better": "higher",
                         "source": "program_counter", "layer": "loop",
                         "moves": "train_tokens_per_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (root / "bench" / "metrics" / "calls_done.py").write_text(CALLS)
    train = execute("smoke.smoke_train", 5, 0.2, True, root=root, device="cpu")
    prefill = execute("smoke.smoke_prefill", 5, 0.2, True, root=root, device="cpu")
    assert "calls_done" in train["line"]["metrics"]
    assert "calls_done" not in prefill["line"]["metrics"]
