"""The port's traffic layer against the JAX package's, on the CPU.

Arrival processes, admission, rate limiting, shedding and the
mixed-criticality mode switch are NumPy or pure Python on both sides:
the same seeds and contracts must give the same release times, the
same verdicts and the same transitions, exactly. Contracts come from the
reference's own scenario builds, carried across with
`repro_torch.convert`.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.scheduler.des import simulate_taskset as ref_simulate
from repro.traffic import arrival as ref_arrival
from repro.traffic.admission import AdmissionController as RefAdmission
from repro.traffic.admission import TaskRequest as RefRequest
from repro.traffic.modes import ModeController as RefModes
from repro.traffic.ratelimit import RateLimiter as RefLimiter
from repro.traffic.ratelimit import TokenBucket as RefBucket
from repro.traffic.scenarios import ArrivalSpec as RefSpec
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
from repro.traffic.shedding import BacklogMonitor as RefMonitor
from repro.traffic.shedding import get_policy as ref_get_policy
from repro_torch import convert
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.scheduler import simulate_taskset
from repro_torch.traffic import arrival
from repro_torch.traffic.admission import AdmissionController
from repro_torch.traffic.modes import ModeController
from repro_torch.traffic.ratelimit import RateLimiter, TokenBucket
from repro_torch.traffic.scenarios import ArrivalSpec, build, get_scenario
from repro_torch.traffic.shedding import BacklogMonitor, get_policy

torch.set_num_threads(1)

#: scenarios whose DSE is quick, covering every arrival kind, the
#: overdriven tenants and the mixed-criticality classes
SCENARIOS = ("rush_hour", "sensor_fusion", "overload_2x", "noisy_neighbor",
             "av_stack")
POLICIES = ("reject_newest", "shed_by_value", "degrade_best_effort")


@pytest.fixture(scope="module")
def ref_built():
    return {n: ref_build(ref_get_scenario(n), ref_platform()) for n in SCENARIOS}


def _pair_admission(reqs, overheads, preemptive):
    """A reference and a port controller with the same contracts fed in
    the same order; returns both and the two request tuples."""
    ref = RefAdmission(list(overheads), preemptive=preemptive)
    port = AdmissionController(list(overheads), preemptive=preemptive)
    port_reqs = convert.requests_from(reqs)
    for r, p in zip(reqs, port_reqs):
        assert dataclasses.asdict(port.admit(p)) == dataclasses.asdict(ref.admit(r))
    return ref, port, port_reqs


@pytest.mark.parametrize("seed", [0, 7, 101])
@pytest.mark.parametrize("kind", ["periodic", "sporadic", "poisson", "mmpp"])
def test_arrival_specs_release_at_the_references_times(kind, seed):
    for period in (1e-3, 0.37):
        spec, ref_spec = ArrivalSpec(kind=kind), RefSpec(kind=kind)
        proc, ref_proc = spec.build(period, seed), ref_spec.build(period, seed)
        horizon = 200 * period
        got = proc.arrivals(horizon)
        assert got and got == ref_proc.arrivals(horizon)
        assert proc.mean_rate() == ref_proc.mean_rate()
        assert proc.analysis_period() == ref_proc.analysis_period()
        assert spec.analysis_period(period) == ref_spec.analysis_period(period)


def test_trace_arrivals_and_merge_match_reference():
    rng = np.random.default_rng(3)
    times = tuple(float(t) for t in np.sort(rng.uniform(0, 1, 40)))
    procs = [arrival.TraceArrivals(times=times),
             arrival.MMPPArrivals(rates=(20.0, 90.0), dwells=(0.1, 0.05), seed=4),
             arrival.SporadicArrivals(min_gap=0.02, jitter=0.5, seed=5)]
    refs = [ref_arrival.TraceArrivals(times=times),
            ref_arrival.MMPPArrivals(rates=(20.0, 90.0), dwells=(0.1, 0.05), seed=4),
            ref_arrival.SporadicArrivals(min_gap=0.02, jitter=0.5, seed=5)]
    for p, r in zip(procs, refs):
        assert p.arrivals(0.8) == r.arrivals(0.8)
        assert p.analysis_period() == r.analysis_period()
    assert arrival.merge_arrivals(procs, 0.8) == ref_arrival.merge_arrivals(refs, 0.8)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_contracts_and_traffic_match_reference(ref_built, name):
    """The port's build on the reference's design: the same segment
    table, contracts and seeded traffic; the serve bundle's rescaled
    contracts and traffic too."""
    b = ref_built[name]
    got = build(get_scenario(name), paper_platform(),
                design=convert.design_from(b.design))
    assert dataclasses.asdict(got.table) == dataclasses.asdict(b.table)
    assert got.requests == convert.requests_from(b.requests)
    horizon = 50 * max(t.period for t in b.taskset.tasks)
    assert got.des_arrivals(horizon) == b.des_arrivals(horizon)
    _, reqs, arrs = got.serve_bundle(period_scale=1e3, seed=5, max_dim=128,
                                     device="cpu")
    _, ref_reqs, ref_arrs = b.serve_bundle(period_scale=1e3, seed=5, max_dim=128)
    assert reqs == convert.requests_from(ref_reqs)
    assert [a.arrivals(1e3 * horizon) for a in arrs] == [
        a.arrivals(1e3 * horizon) for a in ref_arrs
    ]


@pytest.mark.parametrize("preemptive", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_admission_matches_reference(ref_built, name, preemptive):
    """Admit the scenario's tenants, then heavier copies until Eq. 3
    rejects: equal decisions, caches, bounds and headroom reports; the
    batched cohort check agrees; release rebuilds the same state."""
    b = ref_built[name]
    heavy = [RefRequest(name=f"{r.name}x{s}", base=tuple(s * x for x in r.base),
                        period=r.period, value=r.value, criticality=r.criticality)
             for s in (0.5, 2.0, 6.0) for r in b.requests]
    reqs = list(b.requests) + heavy
    ref, port, port_reqs = _pair_admission(reqs, b.table.overhead, preemptive)
    assert any(not d.admitted for d in ref.decisions), "no rejection exercised"
    assert port.utilizations() == ref.utilizations()
    assert port.verify() and ref.verify()
    for policy in (None, "fifo", "edf"):
        assert port.response_bounds(policy) == ref.response_bounds(policy)
    probe = b.requests[0].base
    assert dataclasses.asdict(port.headroom_report(probe=probe)) == (
        dataclasses.asdict(ref.headroom_report(probe=probe)))
    assert port.max_rate(probe) == ref.max_rate(probe)
    cohort = convert.requests_from(heavy)
    rows = [r.base for r in heavy]
    periods = [r.period for r in heavy]
    for got, want in zip(port.score_many(rows, periods), ref.score_many(rows, periods)):
        np.testing.assert_array_equal(got, want)
    assert [dataclasses.asdict(d) for d in port.check_many(cohort)] == [
        dataclasses.asdict(d) for d in ref.check_many(heavy)
    ]
    gone = b.requests[0].name
    assert port.release(gone) == convert.requests_from([ref.release(gone)])[0]
    assert port.utilizations() == ref.utilizations()


@pytest.mark.parametrize("value_weighted", [False, True])
@pytest.mark.parametrize("name", ["rush_hour", "noisy_neighbor"])
def test_rate_limiter_matches_reference(ref_built, name, value_weighted):
    """Token buckets from the contracts, hit by an overdriven stream:
    the scalar and the batched sweeps decide as the reference's do."""
    b = ref_built[name]
    kw = dict(burst_periods=3.0, value_weighted=value_weighted)
    ref_a, ref_b = (RefLimiter.for_requests(b.requests, **kw) for _ in range(2))
    port_a, port_b = (RateLimiter.for_requests(convert.requests_from(b.requests),
                                               **kw) for _ in range(2))
    horizon = 40 * max(r.period for r in b.requests)
    stream = sorted(
        (t, i) for i, r in enumerate(b.requests)
        for t in RefSpec(kind="poisson").build(r.period / 3.0, seed=i).arrivals(horizon)
    )
    times, idx = [t for t, _ in stream], [i for _, i in stream]
    got = [port_a.allow(i, t) for t, i in stream]
    assert got == [ref_a.allow(i, t) for t, i in stream]
    assert not all(got) and any(got)
    np.testing.assert_array_equal(port_b.allow_many(times, idx),
                                  ref_b.allow_many(times, idx))
    assert port_a.totals() == ref_a.totals() == port_b.totals()
    for i in range(len(b.requests)):
        assert port_b.tokens(i, horizon) == ref_b.tokens(i, horizon)
    bucket, ref_bucket = TokenBucket(rate=50.0, burst=3.0), RefBucket(rate=50.0, burst=3.0)
    for t in np.linspace(0.0, 0.2, 37):
        assert bucket.take(float(t), cost=1.5) == ref_bucket.take(float(t), cost=1.5)
        assert bucket.tokens == ref_bucket.tokens


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["sensor_fusion", "noisy_neighbor", "av_stack"])
def test_shedding_policies_decide_as_the_reference(ref_built, name, policy):
    """Every (releasing tenant, overloaded set) pair gets the same
    verdict; the backlog monitor's hysteresis follows the same path."""
    b = ref_built[name]
    ref, port, port_reqs = _pair_admission(b.requests, b.table.overhead, True)
    pol, ref_pol = get_policy(policy), ref_get_policy(policy)
    assert pol.name == ref_pol.name and pol.drops == ref_pol.drops
    n = len(b.requests)
    for k in range(1, n + 1):
        for over in itertools.combinations(range(n), k):
            for i in range(n):
                assert pol.classify(i, list(over), port, list(port_reqs)) == (
                    ref_pol.classify(i, list(over), ref, list(b.requests)))
    mon, ref_mon = BacklogMonitor(), RefMonitor()
    bounds = ref.response_bounds()
    limits = [mon.limit_for(bounds.get(r.name, float("inf")), r.period)
              for r in b.requests]
    assert limits == [ref_mon.limit_for(bounds.get(r.name, float("inf")), r.period)
                      for r in b.requests]
    for step, pending in enumerate([0, 3, 9, 40, 70, 12, 5, 1, 0, 55]):
        i = step % n
        assert mon.observe(i, pending, limits[i]) == ref_mon.observe(i, pending, limits[i])
    assert mon.engaged == ref_mon.engaged


@pytest.mark.parametrize("policy", ["fifo", "edf"])
@pytest.mark.parametrize("action", ["drop", "degrade"])
def test_mode_controller_switches_at_the_references_times(ref_built, action, policy):
    """av_stack's overdriven LO tenant through the DES with a mode
    controller on each side: the same transitions at the same times,
    the same survivors and re-proofs, and an equal `SimResult`."""
    b = ref_built["av_stack"]
    horizon = 40.0 * max(t.period for t in b.taskset.tasks)
    preemptive = policy == "edf"

    def controller(adm_cls, modes_cls, reqs):
        adm = adm_cls([0.0] * b.design.n_stages, preemptive=preemptive)
        for r in reqs:
            adm.admit(r)
        return modes_cls(adm, list(reqs), action=action)

    ref_modes = controller(RefAdmission, RefModes, b.requests)
    modes = controller(AdmissionController, ModeController,
                       convert.requests_from(b.requests))
    kw = dict(horizon=horizon, arrivals=b.des_arrivals(horizon))
    want = ref_simulate(b.table, b.taskset, policy, shedding=ref_modes, **kw)
    got = simulate_taskset(convert.table_from(b.table),
                           convert.taskset_from(b.taskset), policy,
                           shedding=modes, **kw)
    assert want.mode_switches, "av_stack must switch mode"
    assert got.mode_switches == want.mode_switches
    assert [dataclasses.asdict(s) for s in modes.switches] == [
        dataclasses.asdict(s) for s in ref_modes.switches
    ]
    assert modes.mode == ref_modes.mode
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
