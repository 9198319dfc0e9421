"""The port's copy of ``examples/serve_gateway.py`` against the original,
on the CPU.

Both modules are loaded by path and run side by side at a shortened
horizon (10 periods of the slowest tenant): rush_hour and overload_2x
through a `TrafficGateway`, multi_tenant_rush on a 2-shard
`ShardedGateway`. Every run is on a `VirtualClock` driven by the
conformance cost model, so what each prints depends only on the
analysis, the traffic and the window counts: the copy's lines must equal
the original's, line for line. The copy's trace (``--trace``) must hold
the events of every run.
"""
import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from repro_torch.examples import serve_gateway

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HORIZON_PERIODS = 10.0


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_serve_gateway", os.path.join(ROOT, "examples", "serve_gateway.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return buf.getvalue().splitlines(), out


@pytest.mark.parametrize("name", ["rush_hour", "overload_2x"])
def test_run_scenario_prints_the_originals_lines(name):
    want, _ = _printed(_reference().run_scenario, name,
                       horizon_periods=HORIZON_PERIODS)
    got, report = _printed(serve_gateway.run_scenario, name,
                           horizon_periods=HORIZON_PERIODS, device="cpu")
    assert got == want
    assert report.server_report.jobs_completed > 0


def test_run_sharded_prints_the_originals_lines():
    want, _ = _printed(_reference().run_sharded, "multi_tenant_rush", shards=2,
                       horizon_periods=HORIZON_PERIODS)
    got, report = _printed(serve_gateway.run_sharded, "multi_tenant_rush",
                           shards=2, horizon_periods=HORIZON_PERIODS,
                           device="cpu")
    assert got == want
    assert report.total_released() > 0 and report.total_rate_limited() > 0


def test_trace_records_every_run(tmp_path, monkeypatch):
    """``main(["--trace", ...])`` at the shortened horizon: one Chrome
    trace holding events of all three scenario passes."""
    out = tmp_path / "trace.json"
    for fn in ("run_scenario", "run_sharded"):
        full = getattr(serve_gateway, fn)

        def short(*args, _full=full, **kwargs):
            return _full(*args, horizon_periods=HORIZON_PERIODS, **kwargs)

        monkeypatch.setattr(serve_gateway, fn, short)
    lines, _ = _printed(serve_gateway.main, ["--trace", str(out), "--device", "cpu"])
    assert lines[-1].startswith("wrote ") and str(out) in lines[-1]
    doc = json.loads(out.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    scenarios = {e.get("args", {}).get("scenario") for e in events}
    assert {"rush_hour", "overload_2x", "multi_tenant_rush"} <= scenarios
