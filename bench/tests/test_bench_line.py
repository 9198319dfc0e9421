"""The result line's shape, and the command's refusal without a card."""
import json
import subprocess
import sys

from bench_support import ROOT, card_absent, smoke_root  # noqa: F401 (fixtures)
from benchkit.harness import execute
from benchkit.trace import Trace

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_line_has_the_keys_and_checks_last(smoke_root):
    out = execute("smoke.smoke_prefill", 21, 0.2, False, root=smoke_root, device="cpu")
    line = json.loads(json.dumps(out["line"]))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "breakdown" not in line
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] == sum(c.rows for c in out["run"].calls)


def test_traced_line_without_device_time_reports_no_device_metric(smoke_root):
    out = execute("smoke.smoke_train", 21, 0.2, True, root=smoke_root, device="cpu")
    line = out["line"]
    # on the CPU the profiler keeps no device operation: nothing is
    # reported under a device metric's name, and no breakdown
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert line["metrics"] == {}


def test_breakdown_shape():
    t = Trace(window_s=1.0, busy_s=0.5,
              ops={f"k{i}": [0.01 * i, i] for i in range(12)},
              gaps={"bench.step/aten::mm": [0.2, 3], "bench.read": [0.3, 1]})
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k11", 0.11]
    assert b["idle_gaps"][0] == ["bench.read", 0.3]


def test_the_command_fails_without_a_card_and_prints_no_result(card_absent):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen1.5-1.8b.train_b8_s2048",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_call_times_name_the_longest_calls():
    from benchkit import harness

    run = harness.Run(cell={}, sizes=None, traffic={}, device="cpu")
    run.calls = [harness.Call(0.0, d, 1, 1) for d in (0.1, 0.5, 0.2)]
    assert harness.call_times(run, worst=1) == "calls median 200.0 ms, longest #1 500.0 ms"


def test_collector_pauses_count_a_full_pass():
    import gc

    from benchkit import harness

    pauses = harness.CollectorPauses()
    gc.callbacks.append(pauses)
    try:
        gc.collect()
    finally:
        gc.callbacks.remove(pauses)
    assert pauses.count[2] == 1 and pauses.seconds[2] > 0 and "1 full" in str(pauses)
