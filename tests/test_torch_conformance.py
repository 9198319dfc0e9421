"""The port's conformance harness against the JAX package's, on the CPU.

Each package builds the four scenarios of the conformance sweep with its
own DSE, once per module, and runs them through its own harness:
analysis, window-boundary DES and the virtual-clock `PharosServer`
(the port's on ``device="cpu"``, the plain windows). Every number the
harness compares is a deterministic model second, so the port's
`CaseResult` must equal the reference's field for field, apart from
``wall_seconds`` (the host time the case itself took), and the sweep
summaries must be the same string.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.conformance as ref
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
import repro_torch.conformance as port
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.traffic.scenarios import build, get_scenario

torch.set_num_threads(1)

#: the reference test's horizon (tests/test_conformance.py)
HORIZON_PERIODS = 25.0


@pytest.fixture(scope="module")
def builds():
    """Each package's own build of the sweep's scenarios, once."""
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform()),
            build(get_scenario(n), paper_platform()))
        for n in port.DEFAULT_SCENARIOS
    }


def without_wall_seconds(result):
    """``dataclasses.asdict(result)`` with every nested ``wall_seconds``
    set to zero: the one field that is host time, not model time."""
    def strip(x):
        if isinstance(x, dict):
            return {k: 0.0 if k == "wall_seconds" else strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x
    return strip(dataclasses.asdict(result))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_gap", [0.0, 0.25, 1.0])
def test_regulate_trace_matches_reference(seed, min_gap):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.exponential(0.5, size=200).cumsum() - rng.uniform(0, 1))
    got = port.regulate_trace(times, min_gap)
    assert got == ref.regulate_trace(times, min_gap)
    assert all(b >= a + min_gap for a, b in zip(got, got[1:]))
    assert port.regulate_trace([], min_gap) == []


def test_config_constants_and_exports_match_reference():
    assert dataclasses.asdict(port.ConformanceConfig()) == dataclasses.asdict(
        ref.ConformanceConfig())
    assert [f.name for f in dataclasses.fields(port.ConformanceConfig)] == [
        f.name for f in dataclasses.fields(ref.ConformanceConfig)]
    assert (port.PR2_TOL_REL, port.PR2_QUANTUM_SLACK, port.PR3_QUANTUM_SLACK) == (
        ref.PR2_TOL_REL, ref.PR2_QUANTUM_SLACK, ref.PR3_QUANTUM_SLACK)
    assert port.DEFAULT_SCENARIOS == ref.DEFAULT_SCENARIOS
    assert port.POLICIES == ref.POLICIES
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("policy", ["fifo", "edf"])
@pytest.mark.parametrize("name", ["steady_city", "rush_hour", "sensor_fusion",
                                  "copilot_decode"])
def test_run_case_matches_reference(builds, name, policy):
    ref_built, built = builds[name]
    got = port.run_case(built, policy, device="cpu",
                        cfg=port.ConformanceConfig(horizon_periods=HORIZON_PERIODS))
    want = ref.run_case(ref_built, policy,
                        cfg=ref.ConformanceConfig(horizon_periods=HORIZON_PERIODS))
    assert got.ok and want.ok, [str(v) for v in got.violations + want.violations]
    assert without_wall_seconds(got) == without_wall_seconds(want)
    assert got.wall_seconds > 0.0
    assert all(t.server_jobs > 0 for t in got.tasks)


def test_run_case_trace_diff_matches_reference(builds):
    ref_built, built = builds["sensor_fusion"]
    got = port.run_case(built, "edf", device="cpu", cfg=port.ConformanceConfig(
        horizon_periods=HORIZON_PERIODS, record_traces=True))
    want = ref.run_case(ref_built, "edf", cfg=ref.ConformanceConfig(
        horizon_periods=HORIZON_PERIODS, record_traces=True))
    assert got.trace_diff is not None and got.trace_diff.compared > 0
    assert dataclasses.asdict(got.trace_diff) == dataclasses.asdict(want.trace_diff)
    assert without_wall_seconds(got) == without_wall_seconds(want)


def test_run_conformance_with_prebuilt_matches_reference(builds):
    names = ("steady_city", "rush_hour")
    got = port.run_conformance(
        names, device="cpu", prebuilt={n: builds[n][1] for n in names},
        cfg=port.ConformanceConfig(horizon_periods=HORIZON_PERIODS))
    want = ref.run_conformance(
        names, prebuilt={n: builds[n][0] for n in names},
        cfg=ref.ConformanceConfig(horizon_periods=HORIZON_PERIODS))
    assert got.ok and len(got.cases) == 4
    assert without_wall_seconds(got) == without_wall_seconds(want)
    assert got.summary() == want.summary()
    assert got.case("rush_hour", "edf") is got.cases[3]


def test_legs_run_on_the_card_unless_told_otherwise(builds):
    """No CPU fallback: with no card, a leg left at its default device
    raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device serves")
    with pytest.raises((RuntimeError, AssertionError)):
        port.run_case(builds["rush_hour"][1], "edf")
