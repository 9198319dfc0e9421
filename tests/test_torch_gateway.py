"""The port's traffic gateway against the JAX package's, on the CPU.

Each registry scenario is built by each package (its own DSE, seeded
traffic and contracts), served at surrogate width (``max_dim=256``) in
front of that package's `PharosServer` on a `VirtualClock` driven by
the exec cost model, with the overload authority ``chip_smoke.py``'s
gateway phase arms: reject-newest shedding, or the mixed-criticality
mode switch where a tenant is HI. A virtual-clock run depends only on
window counts and WCETs, so the two `GatewayReport`s must be equal
field for field and the two schedule traces (each package's own
`TraceRecorder`, compared through `repro_torch.convert.events_from` by
both packages' `trace_diff`) identical. The port's side runs through
``chip_smoke.py``'s own helpers, the ones its card phase drives.
"""
import dataclasses
import importlib.util
import os

import pytest
import torch

from repro.conformance import CostModel as RefCostModel
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.obs import TraceRecorder as RefRecorder
from repro.obs import trace_diff as ref_trace_diff
from repro.pipeline.serve import PharosServer as RefServer
from repro.traffic import CRITICALITY_HI as REF_HI
from repro.traffic.admission import AdmissionController as RefAdmission
from repro.traffic.clock import VirtualClock as RefClock
from repro.traffic.gateway import TrafficGateway as RefGateway
from repro.traffic.modes import ModeController as RefModes
from repro.traffic.scenarios import SCENARIOS as REF_SCENARIOS
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
from repro.traffic.shedding import get_policy as ref_get_policy
from repro_torch import convert
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.obs import EVENT_KINDS, TraceRecorder, trace_diff
from repro_torch.traffic import GatewayReport, TrafficGateway, VirtualClock
from repro_torch.traffic.scenarios import build, get_scenario

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(REF_SCENARIOS)
MAX_DIM = 256
WINDOW_TILES = 4  # PharosServer's default, as chip_smoke.py serves
#: horizon in periods of each scenario's slowest tenant
HORIZON_PERIODS = 15.0


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke():
    return _load_smoke()


@pytest.fixture(scope="module")
def builds():
    """Each package's own build of every registry scenario, once."""
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform()),
            build(get_scenario(n), paper_platform()))
        for n in NAMES
    }


def _ref_gateway_run(b, horizon, trace, backend):
    """The reference's gateway, built as ``chip_smoke.serve_gateway``
    builds the port's, in the window geometry ``backend``."""
    tasks, requests, arrivals = b.serve_bundle(period_scale=1.0, max_dim=MAX_DIM)
    policy = b.scenario.policy
    cm = RefCostModel.from_exec_model(b.design, list(b.workloads), tasks,
                                      backend=backend, window_tiles=WINDOW_TILES)
    clk = RefClock()
    srv = RefServer(tasks, b.design.n_stages, policy=policy, backend=backend,
                    window_tiles=WINDOW_TILES, cost_model=cm,
                    clock=clk.now, sleep=clk.sleep, trace=trace)
    adm = RefAdmission(list(b.table.overhead), preemptive=policy == "edf")
    mixed = any(r.criticality == REF_HI for r in requests)
    gw = RefGateway(srv, adm, list(requests), list(arrivals),
                    shedding=None if mixed else ref_get_policy("reject_newest"),
                    modes=RefModes(adm, list(requests)) if mixed else None,
                    clock=clk, trace=trace)
    return gw.run(horizon)


@pytest.mark.parametrize(
    "name", ["steady_city", "rush_hour", "overload_2x", "av_stack", "copilot_decode"])
def test_chip_smoke_searches_the_design_build_picks(smoke, builds, name):
    """The card's gateway phase picks each design through
    ``chip_smoke.search_design``: the same search, design, contracts
    and seeded traffic as the port's own ``build``."""
    assert name in smoke.GATEWAY_DESIGNS
    got, res = smoke.search_design(name)
    want = builds[name][1]
    assert res.best == want.design
    assert smoke.design_summary(got.design) == smoke.design_summary(want.design)
    assert got.requests == want.requests and got.arrivals == want.arrivals
    assert got.taskset == want.taskset and got.workloads == want.workloads


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_gateway_report_and_trace_match_reference(smoke, builds, name, backend):
    """Both window geometries: one output-tile row per window ("jnp"),
    and the four-tile windows the card's gateway phase serves
    ("pallas"; the reference runs its Pallas kernel in interpret
    mode)."""
    ref_b, b = builds[name]
    assert smoke.WINDOW_TILES == WINDOW_TILES
    assert smoke.design_summary(b.design) == smoke.design_summary(ref_b.design)
    horizon = HORIZON_PERIODS * max(r.period for r in ref_b.requests)
    rtr, ptr = RefRecorder(), TraceRecorder()
    want = _ref_gateway_run(ref_b, horizon, rtr, backend)
    tasks, requests, arrivals, cm = smoke.gateway_bundle(
        b, device="cpu", max_dim=MAX_DIM, backend=backend)
    got, _ = smoke.serve_gateway(b, tasks, requests, arrivals, device="cpu",
                                 horizon=horizon, cost_model=cm, trace=ptr,
                                 backend=backend)
    assert isinstance(got, GatewayReport)
    sr = want.server_report
    assert sr.jobs_completed > 0 and sr.windows_executed > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    ref_events = convert.events_from(rtr)
    d = trace_diff(ref_events, ptr, kinds=EVENT_KINDS, names=("jax", "torch"))
    assert d.identical, d.summary()
    assert d.compared == len(rtr.events) == len(ptr.events) > 0
    rd = ref_trace_diff(rtr, ptr.events, kinds=EVENT_KINDS, names=("jax", "torch"))
    assert rd.identical and rd.compared == d.compared
    assert ptr.events == ref_events
    assert {e.kind for e in ptr.events} <= set(EVENT_KINDS)
    if name == "overload_2x":
        assert got.total_shed() > 0, "overload_2x must shed"
    if name == "av_stack":
        assert got.mode_switches, "av_stack must switch mode"


def test_cost_model_and_bundle_match_reference(builds):
    """copilot_decode's StableLM-1.6B decode tenant (121 layers): the
    serve bundle's chains and the conformance cost model."""
    ref_b, b = builds["copilot_decode"]
    ref_tasks, _, _ = ref_b.serve_bundle(period_scale=1.0, max_dim=MAX_DIM)
    tasks, _, _ = b.serve_bundle(period_scale=1.0, max_dim=MAX_DIM, device="cpu")
    assert [len(t.weights) for t in tasks] == [10, 121]
    for t, r in zip(tasks, ref_tasks):
        assert [tuple(w.shape) for w in t.weights] == [tuple(w.shape) for w in r.weights]
        assert (t.name, t.stage_of_layer, t.period, t.deadline, t.input_rows) == (
            r.name, r.stage_of_layer, r.period, r.deadline, r.input_rows)
    got = b.conformance_cost_model(tasks)
    want = ref_b.conformance_cost_model(ref_tasks)
    assert got.layer_costs == want.layer_costs
    assert got.layer_windows == want.layer_windows
    assert got.chunk_schedule() == want.chunk_schedule()


def test_serve_bundle_weights_follow_the_seed_on_every_device(builds):
    _, b = builds["rush_hour"]
    a, _, _ = b.serve_bundle(period_scale=1.0, seed=3, max_dim=MAX_DIM, device="cpu")
    c, _, _ = b.serve_bundle(period_scale=1.0, max_dim=MAX_DIM, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    d, _, _ = b.serve_bundle(period_scale=1.0, seed=4, max_dim=MAX_DIM, device="cpu")
    assert all(torch.equal(x, y) for s, t in zip(a, c)
               for x, y in zip(s.weights, t.weights))
    assert not torch.equal(a[0].weights[0], d[0].weights[0])


def test_gateway_refuses_two_overload_authorities(smoke, builds):
    _, b = builds["av_stack"]
    tasks, requests, arrivals, _ = smoke.gateway_bundle(b, device="cpu",
                                                        max_dim=MAX_DIM)
    srv = smoke.PharosServer(tasks, b.design.n_stages, device="cpu")
    adm = smoke.AdmissionController(list(b.table.overhead))
    with pytest.raises(ValueError, match="either per-job shedding or"):
        TrafficGateway(srv, adm, requests, arrivals,
                       shedding=smoke.get_policy("reject_newest"),
                       modes=smoke.ModeController(adm, list(requests)),
                       clock=VirtualClock())


def test_chip_smoke_gateway_checks_every_tenants_outputs(smoke, builds):
    """The output hook of the card's gateway phase sees exactly the jobs
    the report counts as completed, for every tenant, and each output is
    its task's chain (CPU, float64 yardstick)."""
    _, b = builds["av_stack"]
    tasks, requests, arrivals, cm = smoke.gateway_bundle(
        b, device="cpu", max_dim=MAX_DIM, seed=1)
    gen = torch.Generator().manual_seed(2)
    inputs = [torch.randn((t.input_rows, t.weights[0].shape[0]), generator=gen)
              for t in tasks]
    chains = smoke.ChainCheck([smoke.chain64(t, x) for t, x in zip(tasks, inputs)])
    horizon = 10.0 * max(r.period for r in requests)
    rep, _ = smoke.serve_gateway(b, tasks, requests, arrivals, device="cpu",
                                 horizon=horizon, cost_model=cm, inputs=inputs,
                                 on_output=chains)
    done = [len(rep.server_report.response_times[t.name]) for t in tasks]
    assert all(n > 0 for n in done)
    assert [len(e) for e in chains.errors] == done
    assert max(e for errs in chains.errors for e in errs) <= smoke.CHAIN_REL_TOL
