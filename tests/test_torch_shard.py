"""The port's sharded gateway, live migration, autoscaler and the DSE's
`provision` and `brute` against the JAX package's, on the CPU.

Each module is a copy of its counterpart in `repro` that changes only
imports and the ``device=`` that builds servers, so on the same
scenario both packages must give equal plans, `ShardedReport`s,
`MigrationRecord`s, `AutoscaleReport`s, `ProvisionPlan`s and search
results, and identical schedule traces (each package's gateway traced
by its own recorder, compared through `repro_torch.convert.events_from`
over the whole vocabulary). Gateways serve at surrogate width
(``max_dim=256``) on virtual clocks. These tests compare outputs; they
do not assert the reference's own properties.
"""
import dataclasses
import importlib.util
import os

import pytest
import torch

from repro.core.dse import DSEConfig as RefDSEConfig
from repro.core.dse import brute_force_search as ref_brute
from repro.core.dse import explore as ref_explore
from repro.core.dse import provision as ref_provision
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.core.workloads import PAPER_WORKLOADS as REF_WORKLOADS
from repro.core.workloads import make_taskset as ref_make_taskset
from repro.obs import TraceRecorder as RefRecorder
from repro.traffic import Autoscaler as RefAutoscaler
from repro.traffic import MigrationController as RefMigrationController
from repro.traffic import MigrationPlan as RefMigrationPlan
from repro.traffic import RampPhase as RefRampPhase
from repro.traffic import ShardedGateway as RefShardedGateway
from repro.traffic import plan_shards as ref_plan_shards
from repro.traffic import replicate as ref_replicate
from repro.traffic.scenarios import SCENARIOS as REF_SCENARIOS
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
from repro_torch import convert
from repro_torch.core.dse import DSEConfig, brute_force_search, explore, provision
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.core.workloads import PAPER_WORKLOADS, make_taskset
from repro_torch.obs import EVENT_KINDS, TraceRecorder, trace_diff
from repro_torch.traffic import (
    Autoscaler,
    MigrationController,
    MigrationPlan,
    RampPhase,
    ShardedGateway,
    ShardPlan,
    built_gateway,
    get_placement,
    plan_shards,
    replicate,
)
from repro_torch.traffic.scenarios import build, get_scenario
from repro_torch.traffic.shard import PLACEMENTS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(REF_SCENARIOS)
MAX_DIM = 256
#: horizon in periods of each scenario's slowest tenant, as
#: ``tests/test_migration.py`` runs
HORIZON_PERIODS = 15.0
#: the search `traffic.scenarios.build` runs
BUILD_SEARCH = dict(method="beam", max_m=3, beam_width=6)


@pytest.fixture(scope="module")
def builds():
    """Each package's own build of every registry scenario, once, with
    the reference's test search (``beam_width=4``)."""
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform(16), beam_width=4),
            build(get_scenario(n), paper_platform(16), beam_width=4))
        for n in NAMES
    }


def _horizon(built, periods=HORIZON_PERIODS):
    return periods * max(t.period for t in built.taskset.tasks)


def _same_trace(rtr, ptr):
    """The port's trace equals the reference's, event for event."""
    assert ptr.events == convert.events_from(rtr)
    d = trace_diff(convert.events_from(rtr), ptr, kinds=EVENT_KINDS,
                   names=("jax", "torch"))
    assert d.identical, d.summary()
    assert d.compared == len(ptr.events) > 0


def _design(d):
    """A design point's plain fields, for equality across packages."""
    return (tuple((a.chips, tuple(a.block), dataclasses.asdict(a.chip))
                  for a in d.accs), d.splits, d.max_util)


# ---------------------------------------------------------------------------
# placement and plans
# ---------------------------------------------------------------------------
def test_placement_registry_is_the_references():
    from repro.traffic.shard import PLACEMENTS as REF_PLACEMENTS

    assert sorted(PLACEMENTS) == sorted(REF_PLACEMENTS)
    assert [get_placement(n).name for n in sorted(PLACEMENTS)] == sorted(REF_PLACEMENTS)
    with pytest.raises(KeyError, match="unknown placement"):
        get_placement("round_robin")


@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_every_placement_gives_the_references_plan(builds, name, shards):
    ref_b, b = builds[name]
    preemptive = b.scenario.policy == "edf"
    n_stages = b.design.n_stages
    assert b.requests == convert.requests_from(ref_b.requests)
    for placement in sorted(PLACEMENTS) + [None]:
        rpol, rplan = ref_plan_shards(ref_b.requests, shards, placement,
                                      n_stages=n_stages, preemptive=preemptive)
        pol, plan = plan_shards(b.requests, shards, placement,
                                n_stages=n_stages, preemptive=preemptive)
        assert isinstance(plan, ShardPlan)
        assert pol.name == rpol.name
        assert (plan.n_shards, plan.assignment, plan.members) == (
            rplan.n_shards, rplan.assignment, rplan.members)
    with pytest.raises(ValueError, match="at least one shard"):
        plan_shards(b.requests, 0, n_stages=n_stages, preemptive=preemptive)


# ---------------------------------------------------------------------------
# the sharded gateway
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_k1_sharded_equals_unsharded(builds, name):
    """K = 1: the sharded gateway's one shard reports what the unsharded
    gateway reports, and both equal the reference's K = 1 run."""
    ref_b, b = builds[name]
    horizon = _horizon(b)
    plain = built_gateway(b, max_dim=MAX_DIM, device="cpu").run(horizon)
    sharded = ShardedGateway.from_built(b, shards=1, max_dim=MAX_DIM, device="cpu")
    rep = sharded.run(horizon)
    assert sharded.verify()
    assert rep.plan.assignment == (0,) * len(b.requests)
    assert dataclasses.asdict(rep.reports[0]) == dataclasses.asdict(plain)
    want = RefShardedGateway.from_built(ref_b, shards=1, max_dim=MAX_DIM).run(horizon)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)


@pytest.mark.parametrize("periods", [6.0, 14.0])
@pytest.mark.parametrize("name", ["sharded_city", "steady_city"])
def test_k1_elastic_shared_clock_equals_unsharded(builds, name, periods):
    """One elastic shard (built over every tenant) on the shared clock
    reports what the unsharded gateway reports, and equals the
    reference's run. (The reference's property test of this,
    ``test_migration::test_property_shared_clock_k1_elastic_bit_identical``,
    fails on hypothesis's nested-``@given`` health check before it
    compares anything: it imports ``tests.test_shard`` inside a
    ``@given`` test.)"""
    ref_b, b = builds[name]
    horizon = _horizon(b, periods)
    plain = built_gateway(b, max_dim=MAX_DIM, device="cpu").run(horizon)
    rep = ShardedGateway.from_built(b, shards=1, placement="least_loaded", elastic=True,
                                    max_dim=MAX_DIM, device="cpu").run(horizon)
    assert dataclasses.asdict(rep.reports[0]) == dataclasses.asdict(plain)
    want = RefShardedGateway.from_built(ref_b, shards=1, placement="least_loaded",
                                        elastic=True, max_dim=MAX_DIM).run(horizon)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)


@pytest.mark.parametrize("shared_clock", [True, False])
@pytest.mark.parametrize("name", ["sharded_city", "multi_tenant_rush", "noisy_neighbor"])
def test_sharded_report_and_trace_match_reference(builds, name, shared_clock):
    ref_b, b = builds[name]
    horizon = _horizon(b)
    rtr, ptr = RefRecorder(), TraceRecorder()
    ref_gw = RefShardedGateway.from_built(ref_b, shards=2, placement="least_loaded",
                                          max_dim=MAX_DIM, trace=rtr)
    gw = ShardedGateway.from_built(b, shards=2, placement="least_loaded",
                                   max_dim=MAX_DIM, trace=ptr, device="cpu")
    want = ref_gw.run(horizon, shared_clock=shared_clock)
    got = gw.run(horizon, shared_clock=shared_clock)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.total_released(), got.total_shed(), got.admitted_count()) == (
        want.total_released(), want.total_shed(), want.admitted_count())
    assert got.total_released() > 0
    assert sum(r is not None for r in got.reports) == 2
    _same_trace(rtr, ptr)
    assert sum(e.kind == "place" for e in ptr.events) == len(b.requests)


# ---------------------------------------------------------------------------
# live migration: the commit and abort cases of tests/test_migration.py
# ---------------------------------------------------------------------------
def _migration_plans(built, case, donor):
    name0, horizon = built.requests[0].name, _horizon(built)
    return {
        "commit": [(name0, 0.3 * horizon, None)],
        "abort_target_is_donor": [(name0, 0.3 * horizon, donor)],
        "k1_abort": [(name0, 0.3 * horizon, None)],
        "unknown_tenant_and_target": [("nobody", 0.0, None), (name0, 0.0, 7)],
        "drain_cut_by_horizon": [(name0, 0.995 * horizon, None)],
    }[case]


def _migrate(built, case, *, sharded_cls, controller_cls, plan_cls, recorder_cls, **kw):
    shards = 1 if case == "k1_abort" else 2
    base = sharded_cls.from_built(built, shards=shards, placement="least_loaded",
                                  elastic=True, max_dim=MAX_DIM, **kw)
    base.open()
    donor = base.shard_of_tenant(0)
    rec = recorder_cls()
    gw = sharded_cls.from_built(built, shards=shards, placement="least_loaded",
                                elastic=True, max_dim=MAX_DIM, trace=rec, **kw)
    mc = controller_cls([plan_cls(tenant=t, at=at, target=k)
                         for t, at, k in _migration_plans(built, case, donor)],
                        trace=rec)
    rep = gw.run(_horizon(built), controller=mc)
    return rep, rec, mc, gw


@pytest.mark.parametrize("case", ["commit", "abort_target_is_donor", "k1_abort",
                                  "unknown_tenant_and_target", "drain_cut_by_horizon"])
def test_migration_matches_reference(builds, case):
    ref_b, b = builds["sharded_city"]
    want, rtr, rmc, rgw = _migrate(
        ref_b, case, sharded_cls=RefShardedGateway,
        controller_cls=RefMigrationController, plan_cls=RefMigrationPlan,
        recorder_cls=RefRecorder)
    got, ptr, pmc, pgw = _migrate(
        b, case, sharded_cls=ShardedGateway, controller_cls=MigrationController,
        plan_cls=MigrationPlan, recorder_cls=TraceRecorder, device="cpu")
    assert ([dataclasses.asdict(r) for r in pmc.records]
            == [dataclasses.asdict(r) for r in rmc.records])
    assert pmc.final_assignment() == rmc.final_assignment()
    assert pmc.in_progress() == rmc.in_progress()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert pgw.verify() and rgw.verify()
    _same_trace(rtr, ptr)
    kinds = {e.kind for e in ptr.events}
    if case == "commit":
        (r,) = pmc.records
        assert r.committed and r.held > 0
        assert {"migrate_start", "migrate_commit"} <= kinds
    elif case in ("abort_target_is_donor", "k1_abort"):
        assert pmc.records[0].aborted and "migrate_abort" in kinds
    elif case == "drain_cut_by_horizon":
        assert pmc.in_progress() == [b.requests[0].name]


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------
def _ramp(built, phase_cls, autoscaler_cls, recorder_cls, case, **kw):
    """The ramps of ``tests/test_migration.py``: grow-then-shrink over
    ``replicate(multi_tenant_rush, 2)`` (the down phase keeps one tenant
    per peak shard, from a scout run), and the two-phase carry-over ramp
    over sharded_city."""
    dur = 6.0 * max(r.period for r in built.requests)
    if case == "carry_over":
        phases = [phase_cls(duration=dur, active=(0, 1)),
                  phase_cls(duration=dur, active=(0, 1, 2, 3))]
    else:
        n = len(built.requests)
        few, full = tuple(range(max(1, n // 4))), tuple(range(n))
        scout = autoscaler_cls(built, min_shards=1, max_shards=4, max_dim=MAX_DIM,
                               **kw).run_ramp([phase_cls(duration=dur, active=few),
                                               phase_cls(duration=dur, active=full)])
        peak = scout.epochs[1].assignment
        down = tuple(sorted(min(i for i, s in peak.items() if s == k)
                            for k in set(peak.values())))
        phases = [phase_cls(duration=dur, active=few),
                  phase_cls(duration=dur, active=full),
                  phase_cls(duration=dur, active=down)]
    rec = recorder_cls()
    max_shards = 2 if case == "carry_over" else 4
    rep = autoscaler_cls(built, min_shards=1, max_shards=max_shards, max_dim=MAX_DIM,
                         trace=rec, **kw).run_ramp(phases)
    return rep, rec


@pytest.mark.parametrize("case", ["grow_then_shrink", "carry_over"])
def test_autoscale_ramp_matches_reference(builds, case):
    if case == "carry_over":
        ref_b, b = builds["sharded_city"]
    else:
        ref_b = ref_replicate(builds["multi_tenant_rush"][0], 2)
        b = replicate(builds["multi_tenant_rush"][1], 2)
    want, rtr = _ramp(ref_b, RefRampPhase, RefAutoscaler, RefRecorder, case)
    got, ptr = _ramp(b, RampPhase, Autoscaler, TraceRecorder, case, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.shard_counts() == want.shard_counts()
    assert got.admit_rate() == want.admit_rate()
    _same_trace(rtr, ptr)
    counts = got.shard_counts()
    if case == "grow_then_shrink":
        assert counts[1] > counts[0] and counts[2] < counts[1]
        assert got.epochs[2].rehomed
        assert {"migrate_start", "migrate_commit"} <= {e.kind for e in ptr.events}


# ---------------------------------------------------------------------------
# the DSE's provision and brute
# ---------------------------------------------------------------------------
PROVISION_CASES = {
    # (scenario, shards, placement, whether the DSE runs in `provision`)
    "sharded_city_dse": ("sharded_city", 2, "least_loaded", True),
    "multi_tenant_rush": ("multi_tenant_rush", 3, "slack_aware", False),
    "noisy_neighbor": ("noisy_neighbor", 2, "hash_by_tenant", False),
}


@pytest.fixture(scope="module")
def provisioned():
    """Each package's `provision` of sharded_city over 2 least-loaded
    shards, its DSE running the search ``build`` runs. (At `DSEConfig`'s
    defaults, max_m 4 and beam width 8, that search outgrows
    ``max_frontier`` in both packages.)"""
    kw = dict(shards=2, placement="least_loaded")
    return (ref_provision("sharded_city", cfg=RefDSEConfig(**BUILD_SEARCH), **kw),
            provision("sharded_city", cfg=DSEConfig(**BUILD_SEARCH), **kw))


@pytest.mark.parametrize("case", sorted(PROVISION_CASES))
def test_provision_matches_reference(builds, provisioned, case):
    name, shards, placement, dse = PROVISION_CASES[case]
    ref_b, b = builds[name]
    kw = dict(shards=shards, placement=placement)
    if dse:
        want, got = provisioned
    else:
        want = ref_provision(name, design=ref_b.design, **kw)
        got = provision(name, design=b.design, **kw)
    assert _design(got.design) == _design(want.design)
    assert _design(got.built.design) == _design(want.built.design)
    assert (got.placement, got.policy, got.n_shards) == (
        want.placement, want.policy, want.n_shards)
    assert (got.plan.n_shards, got.plan.assignment) == (
        want.plan.n_shards, want.plan.assignment)
    assert got.contracts == tuple(convert.requests_from(c) for c in want.contracts)
    assert got.built.requests == convert.requests_from(want.built.requests)
    assert got.shard_utilizations() == want.shard_utilizations()
    assert ([c.utilizations() for c in got.admission_controllers()]
            == [c.utilizations() for c in want.admission_controllers()])
    gw = got.sharded_gateway(device="cpu", max_dim=MAX_DIM)
    assert gw.plan.assignment == got.plan.assignment
    gw.open()
    assert gw.verify()


def test_brute_matches_reference():
    """The exhaustive search on the reference's own small problem."""
    names, rates = ("pointnet", "deit_t"), (0.8, 0.8)
    rplat, plat = ref_platform(6), paper_platform(6)
    rwls = [REF_WORKLOADS[n] for n in names]
    wls = [PAPER_WORKLOADS[n] for n in names]
    rts, ts = ref_make_taskset(names, rates, rplat), make_taskset(names, rates, plat)
    want = ref_brute(rwls, rts, rplat, max_m=3)
    got = brute_force_search(wls, ts, plat, max_m=3)
    assert want.best is not None
    assert _design(got.best) == _design(want.best)
    assert [_design(d) for d in got.succ_pts] == [_design(d) for d in want.succ_pts]
    timing = ("wall_time_s", "first_feasible_time_s", "eval_seconds")
    stats = {k: v for k, v in dataclasses.asdict(got.stats).items() if k not in timing}
    assert stats == {k: v for k, v in dataclasses.asdict(want.stats).items()
                     if k not in timing}
    via = explore(wls, ts, plat, method="brute", max_m=3)
    ref_via = ref_explore(rwls, rts, rplat, method="brute", max_m=3)
    assert _design(via.best) == _design(ref_via.best) == _design(got.best)


# ---------------------------------------------------------------------------
# chip_smoke.py's sharded phase, on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def counted_windows(monkeypatch):
    """Count every plain window as the kernel counts its launches, so the
    phase's launch accounting is checked on the CPU."""
    from repro_torch.kernels.preemptible_matmul import kernel

    plain = kernel.matmul_window_plain

    def counted(*args, **kwargs):
        kernel.matmul_window_call.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(kernel, "matmul_window_plain", counted)


def _ref_sharded_run(case, ref_plan, trace):
    """The reference's run of what ``chip_smoke.py``'s phase serves."""
    horizon = _horizon(ref_plan.built, 40.0)
    if case == "provisioned":
        return ref_plan.sharded_gateway(max_dim=MAX_DIM, trace=trace).run(horizon), {}
    gw = RefShardedGateway.from_built(
        ref_plan.built, shards=2, placement="least_loaded", elastic=True,
        max_dim=MAX_DIM, trace=trace)
    mc = RefMigrationController(
        [RefMigrationPlan(tenant=ref_plan.built.requests[0].name, at=0.3 * horizon)],
        trace=trace)
    rep = gw.run(horizon, controller=mc)
    return rep, {"records": mc.records, "final": mc.final_assignment(),
                 "in_progress": mc.in_progress()}


@pytest.mark.parametrize("case", ["provisioned", "migration", "autoscale"])
def test_chip_smoke_sharded_phase_on_the_cpu(smoke, provisioned, counted_windows, case):
    """The sharded phase's helpers with ``device="cpu"`` at surrogate
    width: `sharded_case` runs each workload twice (its card side here
    on the CPU) with every check of the card phase, and the result
    equals the reference's run of the same workload."""
    assert (smoke.SHARDED_SCENARIO, smoke.SHARDED_SHARDS, smoke.SHARDED_PLACEMENT,
            smoke.SHARDED_PERIODS, smoke.MIGRATE_AT) == (
        "sharded_city", 2, "least_loaded", 40.0, 0.3)
    ref_plan, port_plan = provisioned
    rtr = RefRecorder()
    if case == "autoscale":
        population = replicate(smoke.search_design(smoke.AUTOSCALE_SCENARIO)[0],
                               smoke.AUTOSCALE_COPIES)
        phases = smoke.autoscale_phases(population)
        make = smoke.autoscale_run(population, phases, max_dim=MAX_DIM)
        ref_population = ref_replicate(
            ref_build(ref_get_scenario("multi_tenant_rush"), ref_platform()), 2)
        lo, hi = smoke.AUTOSCALE_SHARDS
        want = RefAutoscaler(ref_population, min_shards=lo, max_shards=hi,
                             max_dim=MAX_DIM, trace=rtr).run_ramp(
            [RefRampPhase(duration=p.duration, active=p.active) for p in phases])
        want_extra = {}
    else:
        plan = smoke.provision_sharded()
        assert plan.plan.assignment == port_plan.plan.assignment
        assert _design(plan.design) == _design(port_plan.design)
        make = (smoke.provisioned_run(plan, max_dim=MAX_DIM) if case == "provisioned"
                else smoke.migration_run(plan.built, max_dim=MAX_DIM))
        want, want_extra = _ref_sharded_run(case, ref_plan, rtr)
    run = smoke.sharded_case(case, make, device="cpu")
    assert dataclasses.asdict(run["report"]) == dataclasses.asdict(want)
    _same_trace(rtr, run["trace"])
    tally = run["tally"]
    assert run["launches"] == tally["windows"] + tally["warmup"] > 0
    assert tally["outputs"] == tally["completed"] > 0
    assert tally["err"] <= smoke.CHAIN_REL_TOL
    if case == "migration":
        extra = run["extra"]
        assert ([dataclasses.asdict(r) for r in extra["records"]]
                == [dataclasses.asdict(r) for r in want_extra["records"]])
        assert (extra["final"], extra["in_progress"]) == (
            want_extra["final"], want_extra["in_progress"])
        (rec,) = extra["records"]
        assert rec.committed and rec.target != rec.donor
    else:
        assert run["extra"] == want_extra == {}
    if case == "autoscale":
        shards = run["report"].shard_counts()
        assert shards[1] > shards[0] and shards[2] < shards[1]
