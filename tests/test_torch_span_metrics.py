"""The benchmark's readers of the program's spans (``bench/metrics/``:
``forward_ms.train``, ``backward_ms.train``, ``optimizer_ms.train``,
``optimizer_host_ms.train``, ``prefill_host_ms.prefill``,
``attention_ms.prefill``, ``ffn_ms.prefill``; `benchkit.program_spans`).

On a stand-in run fed a hand-made span summary each gives its span's
milliseconds a call, on its clock; it gives None where the run is
untraced, off the card, driven by the other driver, or made no call, and
where the program has no such span or no spans module (a checkout from
before them). A traced smoke run on the CPU records the spans but
reports none of the metrics."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "bench" / "tests"))

import bench_support  # noqa: E402  (puts bench/ and src/ on the path)
from benchkit import harness  # noqa: E402
from benchkit.spec import Spec  # noqa: E402
from benchkit.trace import Trace  # noqa: E402
import repro_torch.obs  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

#: metric -> (driver, span name, clock)
READERS = {
    "forward_ms.train": ("train", "train.forward", "device"),
    "backward_ms.train": ("train", "train.backward", "device"),
    "optimizer_ms.train": ("train", "train.optimizer", "device"),
    "optimizer_host_ms.train": ("train", "train.optimizer", "host"),
    "prefill_host_ms.prefill": ("prefill", "prefill", "host"),
    "attention_ms.prefill": ("prefill", "prefill.mixer", "device"),
    "ffn_ms.prefill": ("prefill", "prefill.ffn", "device"),
}
CALLS = 4
T0, T1 = 100.5, 140.25  # the window, perf_counter seconds


def _reader(name):
    return Spec(ROOT).module("metrics", name).read


def _run(driver, device="cuda", traced=True, calls=CALLS):
    run = harness.Run(cell={}, sizes=None, traffic={"driver": driver}, device=device)
    run.t0, run.t1 = T0, T1
    run.calls = [harness.Call(T0, T1, 8, 2048) for _ in range(calls)]
    run.trace = Trace(window_s=T1 - T0, busy_s=T1 - T0) if traced else None
    return run


@pytest.fixture
def summary(monkeypatch):
    """The spans' summary as the test sets it, and the windows asked for."""
    made = {"totals": {}, "asked": []}

    def fake(t0_ns, t1_ns):
        made["asked"].append((t0_ns, t1_ns))
        return made["totals"]

    monkeypatch.setattr(spans, "summary", fake)
    return made


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_its_spans_ms_a_call(metric, summary):
    driver, name, clock = READERS[metric]
    summary["totals"] = {
        name: spans.SpanTotals(count=40, host_s=0.8, device_s=2.4),
        "other": spans.SpanTotals(count=1, host_s=9.0, device_s=9.0),
    }
    got = _reader(metric)(_run(driver))
    want = 1e3 * (0.8 if clock == "host" else 2.4) / CALLS
    assert got == pytest.approx(want)
    assert summary["asked"] == [(int(T0 * 1e9), int(T1 * 1e9))]


def _untraced(driver):
    return _run(driver, traced=False)


def _off_card(driver):
    return _run(driver, device="cpu")


def _other_driver(driver):
    return _run("prefill" if driver == "train" else "train")


def _no_calls(driver):
    return _run(driver, calls=0)


CASES = {"untraced": _untraced, "off_card": _off_card,
         "other_driver": _other_driver, "no_calls": _no_calls}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_none_for_a_run_it_cannot_read(metric, case, summary):
    driver, name, _ = READERS[metric]
    summary["totals"] = {name: spans.SpanTotals(count=40, host_s=0.8, device_s=2.4)}
    assert _reader(metric)(CASES[case](driver)) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_none_without_the_programs_span(metric, summary):
    driver, name, clock = READERS[metric]
    read = _reader(metric)
    assert read(_run(driver)) is None  # no span of any name
    # spans that ran off the card have no device time
    summary["totals"] = {name: spans.SpanTotals(count=40, host_s=0.8, device_s=None)}
    assert (read(_run(driver)) is None) == (clock == "device")


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_gives_none_for_a_program_without_spans(metric, summary, monkeypatch):
    driver, name, _ = READERS[metric]
    summary["totals"] = {name: spans.SpanTotals(count=40, host_s=0.8, device_s=2.4)}
    assert _reader(metric)(_run(driver)) is not None
    # a checkout of the program from before its spans: the import fails
    monkeypatch.delattr(repro_torch.obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert _reader(metric)(_run(driver)) is None


@pytest.mark.parametrize("cell", ["smoke.smoke_train", "smoke.smoke_prefill"])
def test_traced_cpu_run_records_spans_and_reports_none_of_them(tmp_path, cell):
    bench_support.write_root(tmp_path)
    doc_path = tmp_path / "BENCHMARK.json"
    doc = json.loads(doc_path.read_text())
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["per_layer"] = [dict(m, workloads=[f"smoke.smoke_{READERS[m['name']][0]}"])
                        for m in real["per_layer"] if m["name"] in READERS]
    assert len(doc["per_layer"]) == len(READERS)
    doc_path.write_text(json.dumps(doc))
    spans.RECORDER.clear()
    try:
        out = harness.execute(cell, 2**31 + 5, 0.2, True, root=tmp_path, device="cpu")
        recorded = {s.name for s in spans.RECORDER.spans()}
    finally:
        spans.RECORDER.clear()
    driver = cell.split("_")[-1]
    assert recorded == {n for d, n, _ in READERS.values() if d == driver}
    assert out["line"]["metrics"] == {}
    notes = [n for n in out["notes"] if n.endswith(": not measured")]
    assert sorted(notes) == sorted(f"{m}: not measured" for m, v in READERS.items()
                                   if v[0] == driver)
