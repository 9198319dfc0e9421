"""The port's analysis, DSE and discrete-event simulator against the
JAX package's, on the CPU.

Everything here is NumPy or pure Python on both sides, so the port must
reproduce the reference's arithmetic bit for bit: the Eq. 2/3 analysis
and response bounds give equal floats, the beam search picks the same
design with the same ``max_util``, the throughput-guided baseline the
same mapping, and the DES the same `SimResult`. Inputs are the
reference's own scenario builds, carried across with
`repro_torch.convert`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.conformance import CostModel as RefCostModel
from repro.core.dse.explore import explore as ref_explore
from repro.core.dse.space import fixed_design as ref_fixed_design
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.core.rt import batch as ref_batch
from repro.core.rt import response_time as ref_rt
from repro.core.rt import schedulability as ref_sched
from repro.pipeline.stage_split import design_to_segments as ref_segments
from repro.scheduler.des import StageOverhead as RefOverhead
from repro.scheduler.des import simulate_taskset as ref_simulate
from repro.traffic.admission import AdmissionController as RefAdmission
from repro.traffic.scenarios import SCENARIOS as REF_SCENARIOS
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
from repro.traffic.scenarios import resolve_problem as ref_resolve_problem
from repro.traffic.shedding import des_release_shedding as ref_des_shedding
from repro.traffic.shedding import get_policy as ref_get_policy
from repro_torch import convert
from repro_torch.conformance import CostModel
from repro_torch.core.dse import explore, fixed_design
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.core.rt import (
    batched_busy_period,
    batched_end_to_end_bounds,
    batched_max_utilization,
    batched_srt_schedulable,
    batched_stage_slacks,
    batched_stage_utilizations,
    batched_wcets,
    busy_period,
    end_to_end_bounds,
    max_admissible_rate,
    max_utilization,
    srt_schedulable,
    stage_slacks,
    task_rate_sensitivity,
    utilization_headroom,
)
from repro_torch.core.rt.schedulability import density_check
from repro_torch.pipeline.stage_split import design_to_segments
from repro_torch.scheduler import StageOverhead, simulate_taskset
from repro_torch.traffic.admission import AdmissionController
from repro_torch.traffic.scenarios import (
    SCENARIOS,
    get_scenario,
    resolve_problem,
)
from repro_torch.traffic.shedding import des_release_shedding, get_policy

torch.set_num_threads(1)

NAMES = sorted(REF_SCENARIOS)
#: the search `traffic.scenarios.build` runs
BUILD_SEARCH = dict(method="beam", max_m=3, beam_width=6)


def _design(d):
    """A design point's plain fields, for equality across packages."""
    return (tuple((a.chips, tuple(a.block), dataclasses.asdict(a.chip))
                  for a in d.accs), d.splits, d.max_util)


@pytest.fixture(scope="module")
def problems():
    """Each scenario's DSE problem as both packages resolve it."""
    return {
        n: (ref_resolve_problem(ref_get_scenario(n), ref_platform()),
            resolve_problem(get_scenario(n), paper_platform()))
        for n in NAMES
    }


@pytest.fixture(scope="module")
def ref_searched(problems):
    """The reference's search of every scenario, as its ``build`` runs
    it (beam, 3 stages at most, width 6), once."""
    return {
        n: ref_explore(*problems[n][0], ref_platform(), **BUILD_SEARCH)
        for n in NAMES
    }


@pytest.fixture(scope="module")
def ref_built(ref_searched):
    """The reference's own builds of every registry scenario, on the
    designs its search picked."""
    return {
        n: ref_build(ref_get_scenario(n), ref_platform(),
                     design=ref_searched[n].best)
        for n in NAMES
    }


def test_the_registry_is_the_references():
    assert sorted(SCENARIOS) == NAMES
    for n in NAMES:
        assert repr(get_scenario(n)) == repr(ref_get_scenario(n))


@pytest.mark.parametrize("name", NAMES)
def test_resolve_problem_matches_reference(problems, name):
    (ref_wls, ref_ts), (wls, ts) = problems[name]
    assert wls == [convert.workload_from(w) for w in ref_wls]
    assert ts == convert.taskset_from(ref_ts)


@pytest.mark.parametrize("name", NAMES)
def test_beam_explore_picks_the_references_design(problems, ref_searched, name):
    """The scenario's own search (``build``'s: beam, 3 stages at most,
    width 6): the same best design, the same feasible set, the same
    score, exactly."""
    _, (wls, ts) = problems[name]
    want = ref_searched[name]
    got = explore(wls, ts, paper_platform(), **BUILD_SEARCH)
    assert want.best is not None
    assert _design(got.best) == _design(want.best)
    assert [_design(d) for d in got.succ_pts] == [_design(d) for d in want.succ_pts]
    assert got.score == want.score and got.objective == want.objective
    for f in ("create_acc_calls", "children_generated", "parents_expanded",
              "feasible_found", "evaluator"):
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    assert got.stats.wall_time_s > 0.0


@pytest.mark.parametrize("name", NAMES)
def test_tg_explore_matches_reference(problems, name):
    (ref_wls, ref_ts), (wls, ts) = problems[name]
    want = ref_explore(ref_wls, ref_ts, ref_platform(), method="tg")
    got = explore(wls, ts, paper_platform(), method="tg")
    assert [(a.chips, tuple(a.block)) for a in got.tg.accs] == [
        (a.chips, tuple(a.block)) for a in want.tg.accs
    ]
    assert got.tg.sequences == want.tg.sequences
    assert dataclasses.asdict(got.tg.table) == dataclasses.asdict(want.tg.table)
    assert got.tg.max_util == want.tg.max_util
    assert got.score == want.score
    assert got.stats.create_acc_calls == want.stats.create_acc_calls


@pytest.mark.parametrize("name", NAMES)
def test_fixed_design_matches_reference(problems, name):
    (ref_wls, ref_ts), (wls, ts) = problems[name]
    want = ref_fixed_design(ref_wls, ref_ts, ref_platform())
    got = fixed_design(wls, ts, paper_platform())
    assert _design(got) == _design(want)


@pytest.mark.parametrize("preemptive", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_analysis_matches_reference(ref_built, name, preemptive):
    """Eq. 2/3, the headroom helpers and the FIFO/EDF response bounds on
    the scenario's segment table: equal floats."""
    b = ref_built[name]
    table, ts = convert.table_from(b.table), convert.taskset_from(b.taskset)
    for fn, ref_fn in (
        (srt_schedulable, ref_sched.srt_schedulable),
        (max_utilization, ref_sched.max_utilization),
        (stage_slacks, ref_sched.stage_slacks),
        (utilization_headroom, ref_sched.utilization_headroom),
        (task_rate_sensitivity, ref_sched.task_rate_sensitivity),
        (density_check, ref_sched.density_check),
    ):
        want = ref_fn(b.table, b.taskset, preemptive)
        assert fn(table, ts, preemptive) == want, fn.__name__
    probe = list(b.table.base[0])
    assert max_admissible_rate(table, ts, probe, preemptive) == (
        ref_sched.max_admissible_rate(b.table, b.taskset, probe, preemptive))
    policy = "edf" if preemptive else "fifo"
    blocking = [0.1 * o for o in b.table.overhead] if preemptive else None
    assert end_to_end_bounds(table, ts, policy) == ref_rt.end_to_end_bounds(
        b.table, b.taskset, policy)
    assert end_to_end_bounds(table, ts, policy, blocking) == (
        ref_rt.end_to_end_bounds(b.table, b.taskset, policy, blocking))
    wcets = [table.wcet(i, 0, preemptive) for i in range(table.n_tasks)]
    periods = [t.period for t in ts.tasks]
    assert busy_period(wcets, periods) == ref_rt.busy_period(wcets, periods)


@pytest.mark.parametrize("preemptive", [False, True])
@pytest.mark.parametrize("name", ["sensor_fusion", "copilot_decode", "av_stack"])
def test_batched_analysis_matches_reference(ref_built, name, preemptive):
    """The batched functions over a stack of perturbed segment tables
    (the DSE's candidate batches): equal arrays."""
    b = ref_built[name]
    ts = convert.taskset_from(b.taskset)
    rng = np.random.default_rng(7)
    base = np.asarray(b.table.base, dtype=np.float64)
    stack = base[None] * rng.uniform(0.5, 1.6, size=(6,) + base.shape)
    stack[2, 0, :] = 0.0  # a task with no active stage in one candidate
    ov = np.asarray(b.table.overhead)
    pairs = (
        (batched_wcets, ref_batch.batched_wcets, (stack, ov, preemptive)),
        (batched_stage_utilizations, ref_batch.batched_stage_utilizations,
         (stack, ov, None, preemptive)),
        (batched_max_utilization, ref_batch.batched_max_utilization,
         (stack, ov, None, preemptive)),
        (batched_srt_schedulable, ref_batch.batched_srt_schedulable,
         (stack, ov, None, preemptive)),
        (batched_stage_slacks, ref_batch.batched_stage_slacks,
         (stack, ov, None, preemptive)),
    )
    for fn, ref_fn, args in pairs:
        got = fn(*[ts if a is None else a for a in args])
        want = ref_fn(*[b.taskset if a is None else a for a in args])
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
    policy = "edf" if preemptive else "fifo"
    blocking = 0.1 * ov if preemptive else None
    np.testing.assert_array_equal(
        batched_end_to_end_bounds(stack, ov, ts, policy, blocking),
        ref_batch.batched_end_to_end_bounds(stack, ov, b.taskset, policy, blocking),
    )
    e = batched_wcets(stack, ov, preemptive)[:, :, 0]
    periods = [t.period for t in ts.tasks]
    np.testing.assert_array_equal(
        batched_busy_period(e, periods),
        ref_batch.batched_busy_period(e, periods),
    )


def _ref_shedding(b, policy_name):
    adm = RefAdmission(list(b.table.overhead), preemptive=b.scenario.policy == "edf")
    for r in b.requests:
        adm.admit(r)
    return ref_des_shedding(ref_get_policy(policy_name), adm, list(b.requests))


def _port_shedding(b, policy_name):
    reqs = convert.requests_from(b.requests)
    adm = AdmissionController(list(b.table.overhead),
                              preemptive=b.scenario.policy == "edf")
    for r in reqs:
        adm.admit(r)
    return des_release_shedding(get_policy(policy_name), adm, list(reqs))


@pytest.mark.parametrize("shedding", [None, "reject_newest", "shed_by_value",
                                      "degrade_best_effort"])
@pytest.mark.parametrize("policy", ["fifo", "edf"])
@pytest.mark.parametrize("name", ["steady_city", "rush_hour", "overload_2x",
                                  "noisy_neighbor"])
def test_simulate_taskset_matches_reference(ref_built, name, policy, shedding):
    """Scenario traffic (its seeded arrival traces) through the DES under
    FIFO and EDF, with and without release-time shedding, with the
    paper's preemption overheads: an equal `SimResult`."""
    b = ref_built[name]
    horizon = 30.0 * max(t.period for t in b.taskset.tasks)
    arrivals = b.des_arrivals(horizon)
    ref_ov = [RefOverhead(e_tile=o / 3, e_store=o / 3, e_load=o / 3)
              for o in b.table.overhead]
    ov = [StageOverhead(e_tile=o / 3, e_store=o / 3, e_load=o / 3)
          for o in b.table.overhead]
    want = ref_simulate(
        b.table, b.taskset, policy, horizon=horizon, overheads=ref_ov,
        arrivals=arrivals,
        shedding=None if shedding is None else _ref_shedding(b, shedding))
    got = simulate_taskset(
        convert.table_from(b.table), convert.taskset_from(b.taskset), policy,
        horizon=horizon, overheads=ov, arrivals=arrivals,
        shedding=None if shedding is None else _port_shedding(b, shedding))
    assert want.jobs_completed > 0
    if name == "overload_2x" and shedding is not None:
        assert want.jobs_shed > 0 or sum(want.degraded_per_task) > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["sensor_fusion", "av_stack"])
def test_window_preemption_des_matches_reference(ref_built, name):
    """Limited preemption at the runtime's own tile-window boundaries
    (`CostModel.chunk_schedule`), as the conformance harness runs it."""
    b = ref_built[name]
    ref_tasks = ref_segments(b.design, list(b.workloads), b.taskset, max_dim=256)
    ref_cm = RefCostModel.from_exec_model(b.design, list(b.workloads), ref_tasks)
    tasks = design_to_segments(
        convert.design_from(b.design),
        [convert.workload_from(w) for w in b.workloads],
        convert.taskset_from(b.taskset), max_dim=256, device="meta")
    cm = CostModel.from_exec_model(
        convert.design_from(b.design),
        [convert.workload_from(w) for w in b.workloads], tasks)
    assert cm.chunk_schedule() == ref_cm.chunk_schedule()
    horizon = 20.0 * max(t.period for t in b.taskset.tasks)
    kw = dict(horizon=horizon, arrivals=b.des_arrivals(horizon),
              preemption="window")
    want = ref_simulate(b.table, b.taskset, "edf",
                        chunk_schedules=ref_cm.chunk_schedule(),
                        overheads=ref_cm.des_overheads(), **kw)
    got = simulate_taskset(convert.table_from(b.table),
                           convert.taskset_from(b.taskset), "edf",
                           chunk_schedules=cm.chunk_schedule(),
                           overheads=cm.des_overheads(), **kw)
    assert want.preemptions > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
