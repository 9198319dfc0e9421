"""The port's conformance legs beyond `run_case`, against the JAX
package's, on the CPU: the sharded, shedding, mode-switch, migration and
DSE cases at the settings ``chip_smoke.py``'s conformance phase runs on
the card (the reference's own test and benchmark settings), plus the
reference fuzz test's overdriven tenant under shedding.

Each package builds its scenarios with its own DSE, once per module,
and runs its own harness; the port's servers are on ``device="cpu"``
(the plain windows). Every leg runs on virtual clocks, so each result
must equal the reference's field for field (``wall_seconds`` of nested
`CaseResult`s aside, the host time a case took).
"""
import dataclasses

import pytest
import torch

import repro.conformance as ref
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.traffic.arrival import PoissonArrivals as RefPoisson
from repro.traffic.migration import MigrationPlan as RefPlan
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
import repro_torch.conformance as port
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.traffic.arrival import PoissonArrivals
from repro_torch.traffic.migration import MigrationPlan
from repro_torch.traffic.scenarios import build, get_scenario

torch.set_num_threads(1)

NAMES = ("sharded_city", "overload_2x", "av_stack", "steady_city")


@pytest.fixture(scope="module")
def builds():
    """Each package's own build of the legs' scenarios, once."""
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform()),
            build(get_scenario(n), paper_platform()))
        for n in NAMES
    }


def without_wall_seconds(result):
    """``dataclasses.asdict(result)`` with every nested ``wall_seconds``
    set to zero."""
    def strip(x):
        if isinstance(x, dict):
            return {k: 0.0 if k == "wall_seconds" else strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x
    return strip(dataclasses.asdict(result))


def both(leg, pair, *args, **kwargs):
    """``leg``'s result from each package, ``(port, reference)``: the
    reference's on ``pair[0]``, the port's on ``pair[1]`` (its servers on
    the CPU), the other arguments and the leg's `CFG` the same."""
    want = getattr(ref, leg)(pair[0], *args, cfg=ref.ConformanceConfig(**CFG[leg]),
                             **kwargs)
    got = getattr(port, leg)(pair[1], *args, cfg=port.ConformanceConfig(**CFG[leg]),
                             device="cpu", **kwargs)
    return got, want


#: each leg's horizon, in periods: the card phase's (and the
#: reference's own tests' and benchmark's) settings
CFG = {
    "run_sharded_case": dict(horizon_periods=24.0),
    "run_shedding_case": dict(horizon_periods=24.0),
    "run_mode_switch_case": dict(horizon_periods=24.0),
    "run_migration_case": dict(horizon_periods=20.0),
    "run_dse_case": dict(horizon_periods=16.0),
}


@pytest.mark.parametrize("policy", ["fifo", "edf"])
def test_sharded_case_matches_reference(builds, policy):
    got, want = both("run_sharded_case", builds["sharded_city"], policy,
                     shards=2, placement="least_loaded")
    assert got.ok and got.n_shards == 2 and len(got.cases) == 2
    assert without_wall_seconds(got) == without_wall_seconds(want)


def test_shedding_case_matches_reference(builds):
    got, want = both("run_shedding_case", builds["overload_2x"], "edf",
                     shed_policy="reject_newest")
    assert got.ok and got.analysis_schedulable
    assert sum(got.total_shed()) > 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mode_switch_case_matches_reference(builds):
    got, want = both("run_mode_switch_case", builds["av_stack"], "edf",
                     action="degrade")
    assert got.ok and got.des_switches and got.server_switches
    assert got.hi_miss_totals() == (0, 0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_migration_case_matches_reference(builds):
    got, want = both("run_migration_case", builds["sharded_city"], "edf",
                     shards=2)
    assert got.ok and got.commits == 1 and got.aborts == 0
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_migration_case_with_explicit_target_matches_reference(builds):
    """The benchmark's second plan: the first tenant to shard 1 at a
    quarter of the horizon."""
    ref_built, built = builds["sharded_city"]
    at = 0.25 * CFG["run_migration_case"]["horizon_periods"] * max(
        r.period for r in built.requests)
    got = port.run_migration_case(
        built, "edf", shards=2, device="cpu",
        plans=[MigrationPlan(tenant=built.requests[0].name, at=at, target=1)],
        cfg=port.ConformanceConfig(**CFG["run_migration_case"]))
    want = ref.run_migration_case(
        ref_built, "edf", shards=2,
        plans=[RefPlan(tenant=ref_built.requests[0].name, at=at, target=1)],
        cfg=ref.ConformanceConfig(**CFG["run_migration_case"]))
    assert got.commits + got.aborts == 1
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_dse_case_matches_reference():
    got, want = both("run_dse_case", ("steady_city", "steady_city"), "edf",
                     shards=2, check_top=2)
    assert got.ok and got.admitted == 2 and got.released > 0
    assert got.checked_utils[0] == min(got.checked_utils)
    assert without_wall_seconds(got) == without_wall_seconds(want)


def overdrive_tenant(built, idx, factor, poisson):
    """``built`` with tenant ``idx``'s traffic sped up ``factor`` times
    (a `PoissonArrivals` of the package's own, ``poisson``), its contract
    and analysis unchanged: the overload contradicts the analysis, the
    shedding case's premise (as the reference's fuzz test overdrives
    its last tenant by 2.5)."""
    p = built.taskset.tasks[idx].period
    arrivals = list(built.arrivals)
    arrivals[idx] = poisson(rate=factor / p, seed=1234 + idx)
    return dataclasses.replace(built, arrivals=tuple(arrivals))


@pytest.mark.parametrize("name", ["steady_city", "sharded_city"])
def test_overdriven_tenant_shedding_matches_reference(builds, name):
    ref_built, built = builds[name]
    last = len(built.requests) - 1
    got = port.run_shedding_case(
        overdrive_tenant(built, last, 2.5, PoissonArrivals), "edf",
        shed_policy="reject_newest", device="cpu",
        cfg=port.ConformanceConfig(horizon_periods=25.0))
    want = ref.run_shedding_case(
        overdrive_tenant(ref_built, last, 2.5, RefPoisson), "edf",
        shed_policy="reject_newest",
        cfg=ref.ConformanceConfig(horizon_periods=25.0))
    assert got.ok and got.analysis_schedulable
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
