"""The port's wall-clock conformance leg and the calibration it rests on,
on the CPU.

`run_wallclock_case` calibrates the window WCETs on the serving device,
puts the periods on a wall timebase, predicts each task's response from
the measured model and then serves on a `WallClock`. What it measures on
the host clock cannot be compared across packages, so both packages'
`CostModel.calibrate` are replaced by one deterministic model: every
window costs ``WINDOW_S``. Everything the leg computes before the run
(the period scale, the horizon, the margin, the admission mode, each
task's analytic bound and DES prediction) must then equal the
reference's exactly; the measured fields are checked for type and sign.
``WINDOW_S`` keeps each wall run under about 0.3 s.

The calibration itself times each window as the reference's does: on
the host clock from before the launch to after the device sync, with the
accumulator allocated outside the timed region.
"""
import time

import pytest
import torch

import repro.conformance as ref
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.pipeline.serve import window_plan as ref_window_plan
from repro.traffic.scenarios import build as ref_build
from repro.traffic.scenarios import get_scenario as ref_get_scenario
import repro_torch.conformance as port
from repro_torch.conformance import costmodel
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.pipeline import PharosServer, ServeTask
from repro_torch.pipeline.serve import window_plan
from repro_torch.traffic.scenarios import build, get_scenario

torch.set_num_threads(1)

#: every window's calibrated cost, in seconds
WINDOW_S = 2e-4
#: the reference's own wall-clock test settings (tests/test_conformance.py)
WALL = dict(wall_horizon_periods=8.0, wall_reps=2, wall_margin=8.0)


@pytest.fixture(scope="module")
def builds():
    return {
        n: (ref_build(ref_get_scenario(n), ref_platform()),
            build(get_scenario(n), paper_platform()))
        for n in ("steady_city", "rush_hour")
    }


def fixed_calibration(plan, seen):
    """A stand-in for ``CostModel.calibrate``: ``WINDOW_S`` a window, the
    window counts from the package's own ``plan`` (`window_plan`); each
    model made is appended to ``seen``."""
    def calibrate(cls, server, *, reps=3, period_scale=1.0):
        costs, windows = [], []
        for x, t in zip(server.inputs, server.tasks):
            n = [plan(x.shape[0], w.shape[1], w.shape[0], block=server.block,
                      backend=server.backend, window_tiles=server.window_tiles)[1]
                 for w in t.weights]
            costs.append(tuple(WINDOW_S * k * period_scale for k in n))
            windows.append(tuple(n))
        cm = cls(layer_costs=tuple(costs), layer_windows=tuple(windows),
                 stage_of_layer=tuple(tuple(t.stage_of_layer) for t in server.tasks),
                 n_stages=len(server.stages), source="calibrated")
        seen.append(cm)
        return cm
    return classmethod(calibrate)


@pytest.mark.parametrize("calibrated_admission", [False, True])
@pytest.mark.parametrize("name", ["steady_city", "rush_hour"])
def test_wallclock_predictions_match_reference_under_one_calibration(
        builds, monkeypatch, name, calibrated_admission):
    ref_models, port_models = [], []
    monkeypatch.setattr(ref.CostModel, "calibrate",
                        fixed_calibration(ref_window_plan, ref_models))
    monkeypatch.setattr(port.CostModel, "calibrate",
                        fixed_calibration(window_plan, port_models))
    ref_built, built = builds[name]
    got = port.run_wallclock_case(built, "edf", device="cpu", cfg=port.ConformanceConfig(
        calibrated_admission=calibrated_admission, **WALL))
    want = ref.run_wallclock_case(ref_built, "edf", cfg=ref.ConformanceConfig(
        calibrated_admission=calibrated_admission, **WALL))
    (cm,), (ref_cm,) = port_models, ref_models
    assert (cm.layer_costs, cm.layer_windows, cm.stage_of_layer) == (
        ref_cm.layer_costs, ref_cm.layer_windows, ref_cm.stage_of_layer)
    assert (got.scenario, got.policy, got.period_scale, got.horizon_s, got.margin,
            got.admission_mode) == (want.scenario, want.policy, want.period_scale,
                                    want.horizon_s, want.margin, want.admission_mode)
    assert got.admission_mode == ("calibrated" if calibrated_admission else "model")
    assert got.horizon_s < 0.3
    assert [(t.task, t.predicted_bound, t.predicted_des_max) for t in got.tasks] == [
        (t.task, t.predicted_bound, t.predicted_des_max) for t in want.tasks]
    for t in got.tasks:
        assert 0.0 < t.predicted_des_max <= t.predicted_bound
        assert isinstance(t.jobs, int) and t.jobs >= 0
        assert isinstance(t.in_flight, int) and t.in_flight >= 0
        assert isinstance(t.measured_median, float) and isinstance(t.measured_max, float)
        assert 0.0 <= t.measured_median <= t.measured_max
    kinds = {"wall_vs_model", "wall_no_jobs", "verdict_wall_backlog"}
    assert all(v.kind in kinds for v in got.violations), got.violations


def _server():
    gen = torch.Generator().manual_seed(0)
    task = ServeTask(
        name="t", stage_of_layer=(0, 0), period=1.0,
        weights=(torch.randn((128, 256), generator=gen),
                 torch.randn((256, 384), generator=gen)))
    return PharosServer([task], 1, device="cpu", backend="pallas", window_tiles=1)


def test_calibration_times_the_launch_and_the_device_sync(monkeypatch):
    """Each timed window runs from before the launch to after the device
    sync: with the window made to take 2 ms and the sync 1 ms, every
    per-window cost is at least 3 ms. Every probe of a layer, the
    untimed one included, accumulates into one buffer allocated before
    them."""
    run_window, sync = costmodel._run_window, costmodel._sync
    calls = []

    def slow_window(x, w, c_acc, start, **kw):
        calls.append(c_acc)
        time.sleep(2e-3)
        return run_window(x, w, c_acc, start, **kw)

    def slow_sync(dev):
        time.sleep(1e-3)
        sync(dev)

    monkeypatch.setattr(costmodel, "_run_window", slow_window)
    monkeypatch.setattr(costmodel, "_sync", slow_sync)
    reps = 2
    cm = port.CostModel.calibrate(_server(), reps=reps)
    assert cm.layer_windows == ((2, 3),)
    for cost, n in zip(cm.layer_costs[0], cm.layer_windows[0]):
        assert cost / n >= 3e-3
    assert len(calls) == 2 * (reps + 1)
    for layer in (calls[:reps + 1], calls[reps + 1:]):
        assert all(c is layer[0] for c in layer)
    assert calls[0] is not calls[reps + 1]
