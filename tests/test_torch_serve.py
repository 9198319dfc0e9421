"""The port's serving runtime against the JAX package's, on the CPU.

Both servers run on a virtual clock driven by the exec cost model, so
the schedule is decided by the model and the two reports must be equal
field for field, and their schedule traces (each package's own recorder)
identical. Weights and inputs are the reference's, carried across as
numpy arrays (`repro_torch.convert`); chained outputs then agree to
rtol 1e-3 (fp32 products summed in another order, as in
``tests/test_pipeline.py``). Widths stay at or below 512.
"""
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.conformance import CostModel as RefCostModel
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.obs import TraceRecorder as RefRecorder
from repro.pipeline.serve import PharosServer as RefServer
from repro.pipeline.serve import ServeTask as RefServeTask
from repro.pipeline.serve import window_plan as ref_window_plan
from repro.pipeline.stage_split import design_to_segments as ref_segments
from repro.traffic.clock import VirtualClock as RefClock
from repro.traffic.scenarios import build, get_scenario
from repro_torch import convert
from repro_torch.conformance import CostModel
from repro_torch.obs import TraceRecorder, trace_diff
from repro_torch.pipeline import PharosServer, ServeTask, design_to_segments
from repro_torch.pipeline.serve import window_plan
from repro_torch.traffic.clock import VirtualClock

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = (128, 128, 128)
#: every event kind the runtime emits
RUNTIME_KINDS = (
    "release", "dispatch", "preempt_store", "preempt_load",
    "segment_end", "complete", "deadline_miss",
)
GEOMETRIES = {"jnp": 4, "pallas": 1}  # backend -> window_tiles


@pytest.fixture(scope="module")
def built():
    """The reference's own scenario builds (DSE included), once."""
    return {
        name: build(get_scenario(name), ref_platform())
        for name in ("steady_city", "sensor_fusion", "copilot_decode")
    }


def _port_problem(b):
    return (
        convert.design_from(b.design),
        [convert.workload_from(w) for w in b.workloads],
        convert.taskset_from(b.taskset),
    )


def _np_weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        for k, n in dims
    ]


def _pair_tasks(specs):
    """(reference tasks, port tasks) with the same numpy weights."""
    ref, port = [], []
    for name, dims, stages, period, rows, seed in specs:
        ws = _np_weights(dims, seed)
        ref.append(RefServeTask(name, tuple(jnp.asarray(w) for w in ws),
                                stages, period=period, input_rows=rows))
        port.append(ServeTask(name, tuple(torch.from_numpy(w) for w in ws),
                              stages, period=period, input_rows=rows))
    return ref, port


def _inputs(tasks, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((t.input_rows, t.weights[0].shape[0])).astype(np.float32)
        for t in tasks
    ]


def _capture_outputs(srv, n_layers):
    """Spy on layer completions: each task's chained outputs, in order."""
    out = {}
    orig = srv._finish_layer_or_forward

    def spy(job, now):
        if job.layer == n_layers[job.task_id] - 1:
            out.setdefault(srv.tasks[job.task_id].name, []).append(
                np.array(job.c_acc, dtype=np.float32)
            )
        orig(job, now)

    srv._finish_layer_or_forward = spy
    return out


def _run_pair(ref_tasks, port_tasks, n_stages, *, policy, backend,
              ref_cm, port_cm, horizon, inputs):
    window_tiles = GEOMETRIES[backend]
    n_layers = [len(t.weights) for t in ref_tasks]
    rc, rtr = RefClock(), RefRecorder()
    ref = RefServer(ref_tasks, n_stages, policy=policy, backend=backend,
                    window_tiles=window_tiles, clock=rc.now, sleep=rc.sleep,
                    cost_model=ref_cm, trace=rtr)
    ref.inputs = [jnp.asarray(x) for x in inputs]
    ref_out = _capture_outputs(ref, n_layers)
    pc, ptr = VirtualClock(), TraceRecorder()
    port = PharosServer(port_tasks, n_stages, policy=policy, backend=backend,
                        window_tiles=window_tiles, inputs=inputs, device="cpu",
                        clock=pc.now, sleep=pc.sleep, cost_model=port_cm,
                        trace=ptr)
    port_out = _capture_outputs(port, n_layers)
    return (ref.run(horizon), rtr, ref_out), (port.run(horizon), ptr, port_out)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_window_plan_matches_reference(backend):
    for M in (128, 256, 384, 1024):
        for K in (128, 512):
            for N in (128, 256, 384, 640, 1664, 3072):
                for tiles in (1, 2, 3, 4, 8):
                    kw = dict(block=BLOCK, backend=backend, window_tiles=tiles)
                    assert window_plan(M, N, K, **kw) == ref_window_plan(M, N, K, **kw)


@pytest.mark.parametrize(
    "scenario,max_dim",
    [("steady_city", None), ("sensor_fusion", None), ("copilot_decode", 512)],
)
def test_design_to_segments_matches_reference(built, scenario, max_dim):
    b = built[scenario]
    want = ref_segments(b.design, list(b.workloads), b.taskset, max_dim=max_dim)
    design, workloads, taskset = _port_problem(b)
    got = design_to_segments(design, workloads, taskset, max_dim=max_dim,
                             device="meta")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.name == w.name
        assert [tuple(x.shape) for x in g.weights] == [tuple(x.shape) for x in w.weights]
        assert g.stage_of_layer == w.stage_of_layer
        assert g.period == w.period and g.deadline == w.deadline
        assert g.input_rows == w.input_rows


def test_design_to_segments_weights_are_seeded_and_device_independent(built):
    design, workloads, taskset = _port_problem(built["steady_city"])
    kw = dict(max_dim=256, device="cpu")
    a = design_to_segments(design, workloads, taskset,
                           generator=torch.Generator().manual_seed(3), **kw)
    b = design_to_segments(design, workloads, taskset,
                           generator=torch.Generator().manual_seed(3), **kw)
    for ta, tb in zip(a, b):
        for wa, wb in zip(ta.weights, tb.weights):
            assert torch.equal(wa, wb) and wa.dtype == torch.float32


def test_chip_smoke_constants_match_the_reference_design(built):
    """chip_smoke.py serves steady_city on the design the port's own DSE
    picks; it must be the design the reference's build picks, and the
    reference design its gateway phase checks against must be that too."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    b = built["steady_city"]
    accs, splits, max_util = smoke.STEADY_CITY_REFERENCE_DESIGN
    assert splits == b.design.splits
    assert accs == tuple((a.chips, a.block) for a in b.design.accs)
    assert max_util == b.design.max_util
    design, workloads, taskset, tasks = smoke.steady_city(device="meta")
    assert smoke.design_summary(design) == smoke.STEADY_CITY_REFERENCE_DESIGN
    assert design == convert.design_from(b.design)
    assert taskset == convert.taskset_from(b.taskset)
    assert workloads == [convert.workload_from(w) for w in b.workloads]
    # full width: chained widths up to 3072, as the card serves them
    assert max(d for t in tasks for w in t.weights for d in w.shape) == 3072


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_cost_model_from_exec_model_equals_reference(built, backend):
    b = built["steady_city"]
    ref_tasks = ref_segments(b.design, list(b.workloads), b.taskset, max_dim=256)
    design, workloads, _ = _port_problem(b)
    port_tasks = [convert.serve_task_from(t, device="cpu") for t in ref_tasks]
    kw = dict(backend=backend, window_tiles=GEOMETRIES[backend], period_scale=1e3)
    want = RefCostModel.from_exec_model(b.design, list(b.workloads), ref_tasks, **kw)
    got = CostModel.from_exec_model(design, workloads, port_tasks, **kw)
    assert got.layer_costs == want.layer_costs
    assert got.layer_windows == want.layer_windows
    assert got.stage_of_layer == want.stage_of_layer
    assert dataclasses.asdict(got.segment_table()) == dataclasses.asdict(want.segment_table())
    assert [dataclasses.asdict(o) for o in got.des_overheads()] == [
        dataclasses.asdict(o) for o in want.des_overheads()
    ]
    assert got.chunk_schedule() == want.chunk_schedule()
    assert got.device is None


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("policy", ["fifo", "edf"])
def test_server_matches_reference_on_steady_city(built, policy, backend):
    """The slice end to end: steady_city's DSE design, its stage split
    and cost model, served by both runtimes on a virtual clock."""
    b = built["steady_city"]
    ref_tasks = ref_segments(b.design, list(b.workloads), b.taskset, max_dim=256)
    design, workloads, _ = _port_problem(b)
    port_tasks = [convert.serve_task_from(t, device="cpu") for t in ref_tasks]
    kw = dict(backend=backend, window_tiles=GEOMETRIES[backend])
    ref_cm = RefCostModel.from_exec_model(b.design, list(b.workloads), ref_tasks, **kw)
    port_cm = CostModel.from_exec_model(design, workloads, port_tasks, **kw)
    inputs = _inputs(port_tasks, seed=11)
    horizon = 25 * max(t.period for t in ref_tasks)
    (rrep, rtr, rout), (prep, ptr, pout) = _run_pair(
        ref_tasks, port_tasks, b.design.n_stages, policy=policy,
        backend=backend, ref_cm=ref_cm, port_cm=port_cm, horizon=horizon,
        inputs=inputs,
    )
    assert rrep.jobs_completed > 0 and rrep.windows_executed > 0
    if policy == "edf":
        assert rrep.preemptions > 0, "the case must exercise preemption"
    assert dataclasses.asdict(prep) == dataclasses.asdict(rrep)
    d = trace_diff(convert.events_from(rtr), ptr, kinds=RUNTIME_KINDS,
                   names=("jax", "torch"))
    assert d.identical, d.summary()
    assert d.compared == len(rtr.events) == len(ptr.events)
    assert rout.keys() == pout.keys() and rout
    for name in rout:
        assert len(rout[name]) == len(pout[name])
        np.testing.assert_allclose(pout[name][0], rout[name][0], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_preempted_result_is_exact(backend):
    """Preemption must not corrupt results: completed heavy jobs carry
    the exact chained product despite interleaving (the reference's
    test of the same name, on a virtual clock and against the
    reference's own server)."""
    specs = [
        ("heavy", [(256, 256), (256, 256)], (0, 0), 4.0, 256, 0),
        ("urgent", [(128, 128)], (0,), 0.3, 128, 9),
    ]
    ref_tasks, port_tasks = _pair_tasks(specs)
    fields = dict(layer_costs=((1.0, 1.0), (0.05,)), stage_of_layer=((0, 0), (0,)),
                  n_stages=1)
    wins = tuple(
        tuple(window_plan(t.input_rows, w.shape[1], w.shape[0], block=BLOCK,
                          backend=backend, window_tiles=GEOMETRIES[backend])[1]
              for w in t.weights)
        for t in port_tasks
    )
    ref_cm = RefCostModel(layer_windows=wins, **fields)
    port_cm = CostModel(layer_windows=wins, **fields)
    inputs = _inputs(port_tasks, seed=5)
    (rrep, rtr, rout), (prep, ptr, pout) = _run_pair(
        ref_tasks, port_tasks, 1, policy="edf", backend=backend,
        ref_cm=ref_cm, port_cm=port_cm, horizon=8.0, inputs=inputs,
    )
    assert prep.preemptions > 0, "EDF must preempt the heavy job"
    assert dataclasses.asdict(prep) == dataclasses.asdict(rrep)
    assert trace_diff(convert.events_from(rtr), ptr, kinds=RUNTIME_KINDS).identical
    w = _np_weights(specs[0][1], specs[0][5])
    want = inputs[0] @ w[0] @ w[1]
    assert pout["heavy"], "no heavy job finished"
    for got, ref in zip(pout["heavy"], rout["heavy"]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_server_rejects_misplaced_weights_and_bad_inputs():
    _, (task,) = _pair_tasks([("t", [(128, 128)], (0,), 1.0, 128, 0)])
    with pytest.raises(ValueError, match="off the server's device"):
        PharosServer([task], 1, device="meta")
    with pytest.raises(ValueError, match="input has shape"):
        PharosServer([task], 1, device="cpu", inputs=[np.zeros((128, 256))])
    with pytest.raises(ValueError, match="backend"):
        PharosServer([task], 1, device="cpu", backend="xla")


def test_server_draws_inputs_from_its_seed():
    _, (task,) = _pair_tasks([("t", [(128, 256)], (0,), 1.0, 128, 0)])
    a = PharosServer([task], 1, device="cpu", seed=4).inputs[0]
    b = PharosServer([task], 1, device="cpu", seed=4).inputs[0]
    assert a.shape == (128, 128) and torch.equal(a, b)


def test_calibrate_on_cpu_carries_no_device_label():
    _, tasks = _pair_tasks([("t", [(128, 256), (256, 128)], (0, 0), 1.0, 128, 0)])
    srv = PharosServer(tasks, 1, device="cpu", backend="pallas", window_tiles=1)
    cm = CostModel.calibrate(srv, reps=2)
    assert cm.source == "calibrated" and cm.device is None
    assert cm.layer_windows == ((2, 1),)
    assert all(c > 0 for c in cm.layer_costs[0])
    assert cm.scaled(2.0).device is None
