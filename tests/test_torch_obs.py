"""The port's observability layer against the JAX package's, on the CPU.

`repro_torch.obs` is a copy of `repro.obs`: the same event vocabulary,
recorder, metrics catalog, Chrome export and trace diff. The same calls
on both recorders must give equal events (field for field, after
`repro_torch.convert.events_from`), and the same events equal metrics,
Chrome documents and diffs. Then on every registry scenario the port's
gateway, traced by the port's recorder, must give the events, metrics
and Chrome export the reference's gateway gives with its own. Call
sequences come from fixed seeds; gateways serve at surrogate width
(``max_dim=256``) on virtual clocks.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import TraceRecorder as RefRecorder
from repro.obs import to_chrome_trace as ref_chrome
from repro.obs import trace_diff as ref_trace_diff
from repro.obs import write_chrome_trace as ref_write_chrome
from repro.obs import diff as ref_diff_mod
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace_mod
from repro.traffic.scenarios import SCENARIOS as REF_SCENARIOS
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
from repro.traffic.shard import built_gateway as ref_built_gateway
from repro_torch import convert
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.obs import (
    DEFAULT_DIFF_KINDS,
    EVENT_KINDS,
    LAYERS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    TraceEvent,
    TraceRecorder,
    to_chrome_trace,
    trace_diff,
    write_chrome_trace,
)
from repro_torch.obs import trace as trace_mod
from repro_torch.traffic.scenarios import build, get_scenario
from repro_torch.traffic.shard import built_gateway

torch.set_num_threads(1)

NAMES = sorted(REF_SCENARIOS)
SEEDS = (0, 1, 2)
MAX_DIM = 256
#: gateway horizon, in periods of each scenario's slowest tenant
HORIZON_PERIODS = 10.0
TASKS = ("pointnet", "deit_t", "mlp_mixer")


def _fields(e) -> tuple:
    return tuple(getattr(e, f.name) for f in dataclasses.fields(TraceEvent))


def _attrs(rng, kind):
    if kind == "complete":
        return {"deadline": math.inf if rng.rand() < 0.2 else float(rng.rand())}
    if kind in ("preempt_store", "preempt_load"):
        return {"xi": float(rng.rand()) * 1e-3}
    if rng.rand() < 0.5:
        return None
    return {"note": int(rng.randint(0, 5))}


def _drive(rec, seed) -> None:
    """One seeded sequence of `emit`, `annotate`, `sink` and
    `clear_annotations` calls, the same for either package's recorder."""
    rng = np.random.RandomState(seed)
    t = 0.0

    def emit_some(n):
        nonlocal t
        for _ in range(n):
            t += float(rng.exponential(0.01))
            kind = EVENT_KINDS[rng.randint(len(EVENT_KINDS))]
            release = None if rng.rand() < 0.2 else t - float(rng.rand()) * 0.02
            rec.emit(kind, t, LAYERS[rng.randint(len(LAYERS))],
                     TASKS[rng.randint(len(TASKS))], int(rng.randint(-1, 3)),
                     int(rng.randint(-1, 2)), release=release,
                     attrs=_attrs(rng, kind))

    def sink_some(tr, n):
        nonlocal t
        for _ in range(n):
            t += float(rng.exponential(0.01))
            kind = ("release", "complete", "preempt_store", "dispatch")[rng.randint(4)]
            row = (t, kind, TASKS[rng.randint(len(TASKS))], int(rng.randint(0, 3)),
                   t - 0.01)
            if kind in ("complete", "preempt_store") and rng.rand() < 0.7:
                row += (float(rng.rand()),)  # the bare scalar payload
            elif rng.rand() < 0.3:
                row += ({"resumed": bool(rng.rand() < 0.5)},)
            tr(row)

    emit_some(20)
    rec.annotate(attempt=1)
    emit_some(5)
    sink_some(rec.sink("des", 1), 15)  # sticky attributes armed
    rec.clear_annotations()
    sink_some(rec.sink("des", 1), 15)  # the buffer's bare append
    emit_some(10)


def _pair(seed):
    ref, port = RefRecorder(), TraceRecorder()
    _drive(ref, seed)
    _drive(port, seed)
    return ref, port


def test_vocabulary_is_the_references():
    assert EVENT_KINDS == ref_trace_mod.EVENT_KINDS
    assert LAYERS == ref_trace_mod.LAYERS
    assert DEFAULT_DIFF_KINDS == ref_diff_mod.DEFAULT_DIFF_KINDS
    assert trace_mod._VAL_KEY == ref_trace_mod._VAL_KEY
    assert ([f.name for f in dataclasses.fields(TraceEvent)]
            == [f.name for f in dataclasses.fields(ref_trace_mod.TraceEvent)])


@pytest.mark.parametrize("seed", SEEDS)
def test_recorder_calls_give_equal_events(seed):
    ref, port = _pair(seed)
    assert len(port.events) == len(ref.events) == 65
    assert [_fields(e) for e in port.events] == [_fields(e) for e in ref.events]
    assert port.events == convert.events_from(ref)
    assert port.counts() == ref.counts()
    for kw in ({"layer": "des"}, {"kind": "complete"}, {"task": "deit_t"},
               {"shard": 1}, {"layer": "gateway", "shard": -1}):
        assert ([_fields(e) for e in port.stream(**kw)]
                == [_fields(e) for e in ref.stream(**kw)])
    with pytest.raises(ValueError, match="sink tag"):
        port.sink("runtime", 0)
    with pytest.raises(ValueError, match="sink tag"):
        ref.sink("runtime", 0)


def test_disabled_recorder_emits_nothing():
    ref, port = RefRecorder(enabled=False), TraceRecorder(enabled=False)
    for rec in (ref, port):
        rec.emit("release", 0.0, "des", "a")
        assert rec.sink() is None
    assert port.events == [] and ref.events == []
    assert port.counts() == ref.counts() == {}


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_registry_from_trace_agrees(seed):
    ref, port = _pair(seed)
    want = RefRegistry.from_trace(ref)
    got = MetricsRegistry.from_trace(port)
    assert got.snapshot() == want.snapshot()
    assert MetricsRegistry.from_trace(port.events).snapshot() == want.snapshot()
    slacks = [0.25, 0.0, -1e-12]
    want.set_eq3_slacks(slacks)
    got.set_eq3_slacks(slacks)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["counters"], "the trace must populate counters"


def test_counter_gauge_histogram_agree():
    c, rc = Counter(), ref_metrics.Counter()
    g, rg = Gauge(), ref_metrics.Gauge()
    h, rh = Histogram(), ref_metrics.Histogram()
    for v in (3.0, 0.5, 2.0, 7.25, 1.0):
        c.inc(v), rc.inc(v)
        g.set(v), rg.set(v)
        h.observe(v), rh.observe(v)
    assert (c.value, g.value) == (rc.value, rg.value)
    assert h.summary((50, 90, 100)) == rh.summary((50, 90, 100))
    assert h.percentile(95) == rh.percentile(95) and h.count == rh.count == 5
    assert Histogram().summary() == ref_metrics.Histogram().summary()
    for counter in (c, rc):
        with pytest.raises(ValueError, match="only go up"):
            counter.inc(-1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_chrome_trace_agrees(seed, tmp_path):
    ref, port = _pair(seed)
    want = ref_chrome(ref)
    assert to_chrome_trace(port) == want
    assert to_chrome_trace(port.events, time_scale=1e3) == ref_chrome(ref, time_scale=1e3)
    got = write_chrome_trace(port, tmp_path / "port.json")
    ref_write_chrome(ref, tmp_path / "ref.json")
    assert got == want
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))


def _shift(events, pick, dt):
    return [dataclasses.replace(e, t=e.t + dt) if pick(i, e) else e
            for i, e in enumerate(events)]


#: (events a, events b, trace_diff keywords) from one recorder's events
DIFF_CASES = {
    "identical": lambda ev: (ev, list(ev), {}),
    "skewed_within_tolerance": lambda ev: (
        ev, _shift(ev, lambda i, e: e.kind == "complete", 4e-4), {"time_tol": 5e-4}),
    "per_task_tolerance": lambda ev: (
        ev, _shift(ev, lambda i, e: e.task == "deit_t", 2e-3),
        {"time_tol": {"deit_t": 3e-3}}),
    "first_divergence": lambda ev: (
        ev, _shift(ev, lambda i, e: e.kind == "complete" and i > 30, 0.05),
        {"time_tol": 1e-3}),
    "missing_in_b": lambda ev: (
        ev, [e for i, e in enumerate(ev) if not (i > 20 and e.kind == "release")], {}),
    "missing_in_a": lambda ev: (
        [e for i, e in enumerate(ev) if not (i > 20 and e.kind == "complete")], ev, {}),
}


@pytest.mark.parametrize("kinds", ["default", "all"])
@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_trace_diff_agrees(case, kinds):
    ref, port = _pair(1)
    kw_kinds = {} if kinds == "default" else {"kinds": EVENT_KINDS}
    ra, rb, kw = DIFF_CASES[case](ref.events)
    pa, pb, _ = DIFF_CASES[case](port.events)
    want = ref_trace_diff(ra, rb, names=("a", "b"), **kw_kinds, **kw)
    got = trace_diff(pa, pb, names=("a", "b"), **kw_kinds, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    assert got.identical == (case in ("identical", "skewed_within_tolerance",
                                      "per_task_tolerance"))
    if not got.identical:
        assert got.divergence.reason == {"first_divergence": "time_skew"}.get(case, case)
        assert str(got.divergence) == str(want.divergence)


@pytest.fixture(scope="module")
def builds():
    """Each package's own build of every registry scenario, once."""
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform(16), beam_width=4),
            build(get_scenario(n), paper_platform(16), beam_width=4))
        for n in NAMES
    }


@pytest.mark.parametrize("name", NAMES)
def test_gateway_traced_by_the_ports_recorder_matches_reference(builds, name):
    """`built_gateway` in each package, each traced by its own package's
    recorder: equal events, metrics and Chrome export."""
    ref_b, b = builds[name]
    horizon = HORIZON_PERIODS * max(t.period for t in ref_b.taskset.tasks)
    rtr, ptr = RefRecorder(), TraceRecorder()
    want = ref_built_gateway(ref_b, max_dim=MAX_DIM, trace=rtr).run(horizon)
    got = built_gateway(b, max_dim=MAX_DIM, trace=ptr, device="cpu").run(horizon)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ptr.events == convert.events_from(rtr)
    assert {e.kind for e in ptr.events} >= {"release", "dispatch", "complete", "admit"}
    assert {e.layer for e in ptr.events} == {"runtime", "gateway"}
    metrics = MetricsRegistry.from_trace(ptr).snapshot()
    assert metrics == RefRegistry.from_trace(rtr).snapshot()
    assert sum(v for k, v in metrics["counters"].items()
               if k.startswith("completions/")) > 0
    assert to_chrome_trace(ptr) == ref_chrome(rtr)
    d = trace_diff(ptr, convert.events_from(rtr), kinds=EVENT_KINDS)
    assert d.identical and d.compared == len(ptr.events)
