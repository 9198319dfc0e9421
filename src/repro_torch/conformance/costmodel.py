"""Per-layer cost model for the serving runtime.

The `CostModel` prices each (task, layer) individually and the
`PharosServer` charges exactly that much virtual time per executed tile
window, so the virtual runtime is driven by the *same* WCETs the Eq. 2/3
analysis and the DES consume.

Two sources:

- `CostModel.from_exec_model` — the analytic path: per-layer latency
  from `core.perfmodel.layer_latency` on the design's accelerators.
  Per-stage sums then equal `SegmentTable.base` bit-for-bit (both are
  the same left-to-right `segment_latency` accumulation). The exec
  model prices the paper's platform; the card enters only through
  `calibrate`.
- `CostModel.calibrate` — the measured path: `PharosServer.warmup`-style
  probes time the window executor per (task, layer) on the server's
  device — with CUDA events on the card — and the model carries
  measured seconds and the name of the device that was timed.
  `segment_table()` then yields a *measured* WCET table.

Preemption in the serving runtime happens only at window boundaries: a
preemptor blocks for at most one in-flight window and resumption costs
nothing extra (the fp32 accumulator stays in the job's buffer and the
executor re-streams nothing). `stage_window_quantum` is that blocking
term per stage — the runtime's realization of the paper's Eq. 5 ``xi``
— and `segment_table`/`des_overheads` hand it to the analysis (Eq. 4
inflation) and the DES so all three layers model the same preemption
cost structure.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.core.perfmodel.exec_model import layer_latency
from repro_torch.core.rt.task import SegmentTable
from repro_torch.pipeline.serve import DEFAULT_BLOCK, _run_window, window_plan
from repro_torch.scheduler.des import StageOverhead


@dataclass(frozen=True)
class CostModel:
    """Per-(task, layer) virtual WCETs + window counts.

    ``layer_costs[i][j]`` is the full service of task i's layer j in
    (virtual) seconds; the serving runtime charges
    ``layer_costs[i][j] / layer_windows[i][j]`` per executed window.
    """

    layer_costs: tuple[tuple[float, ...], ...]
    layer_windows: tuple[tuple[int, ...], ...]
    stage_of_layer: tuple[tuple[int, ...], ...]
    n_stages: int
    source: str = "exec_model"
    #: name of the device `calibrate` timed (None: not measured on a card)
    device: str | None = None

    def __post_init__(self) -> None:
        if not (
            len(self.layer_costs)
            == len(self.layer_windows)
            == len(self.stage_of_layer)
        ):
            raise ValueError("per-task vectors must align")
        for costs, wins, stages in zip(
            self.layer_costs, self.layer_windows, self.stage_of_layer
        ):
            if not (len(costs) == len(wins) == len(stages)):
                raise ValueError("per-layer vectors must align")
            if any(c <= 0.0 for c in costs):
                raise ValueError("layer costs must be positive")
            if any(w < 1 for w in wins):
                raise ValueError("each layer needs >= 1 window")
            if any(s < 0 or s >= self.n_stages for s in stages):
                raise ValueError("stage index out of range")

    # -- accessors ----------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.layer_costs)

    def layer_cost(self, task_id: int, layer: int) -> float:
        return self.layer_costs[task_id][layer]

    def window_cost(self, task_id: int, layer: int) -> float:
        """Virtual seconds one executed tile window charges."""
        return (
            self.layer_costs[task_id][layer]
            / self.layer_windows[task_id][layer]
        )

    def segment_cost(self, task_id: int, stage: int) -> float:
        """``b_i^k``: summed layer costs of task i's segment on stage k."""
        return sum(
            c
            for c, s in zip(
                self.layer_costs[task_id], self.stage_of_layer[task_id]
            )
            if s == stage
        )

    def stage_window_quantum(self) -> list[float]:
        """Worst-case single-window service per stage — how long a
        window-boundary preemptor can be blocked (the runtime's Eq. 5
        ``xi`` analogue; store/load cost 0 in the virtual executor)."""
        q = [0.0] * self.n_stages
        for i in range(self.n_tasks):
            for j, s in enumerate(self.stage_of_layer[i]):
                q[s] = max(q[s], self.window_cost(i, j))
        return q

    # -- bridges to the other layers ----------------------------------
    def segment_table(self) -> SegmentTable:
        """Analysis view: base = per-stage cost sums, overhead = the
        per-stage window quantum — one consistent WCET source for
        Eq. 2/3, the response bounds, and the DES."""
        base = [
            [self.segment_cost(i, k) for k in range(self.n_stages)]
            for i in range(self.n_tasks)
        ]
        return SegmentTable(base=base, overhead=self.stage_window_quantum())

    def des_overheads(self) -> list[StageOverhead]:
        """DES preemption costs matching the runtime: the preemptor
        drains at most one window (``pre`` = quantum) and resumption is
        free (``post`` = 0)."""
        return [
            StageOverhead(e_tile=q) for q in self.stage_window_quantum()
        ]

    def chunk_schedule(self) -> list[dict[int, tuple[float, ...]]]:
        """Per task: stage -> the non-preemptible chunk lengths (one
        per executed tile window, in execution order) of that task's
        segment on the stage — exactly the service quanta
        `PharosServer` charges between preemption opportunities. The
        DES (``simulate_taskset(chunk_schedules=..., preemption="window")``
        in `repro_torch.scheduler.des`) takes it to defer
        preemption at the same boundaries the runtime does."""
        out: list[dict[int, tuple[float, ...]]] = []
        for i in range(self.n_tasks):
            per_stage: dict[int, list[float]] = {}
            for j, s in enumerate(self.stage_of_layer[i]):
                per_stage.setdefault(s, []).extend(
                    [self.window_cost(i, j)] * self.layer_windows[i][j]
                )
            out.append({k: tuple(v) for k, v in sorted(per_stage.items())})
        return out

    def scaled(self, factor: float) -> "CostModel":
        """Rescale every cost (e.g. analytic seconds -> wall seconds)."""
        if factor <= 0.0:
            raise ValueError("scale factor must be positive")
        return CostModel(
            layer_costs=tuple(
                tuple(c * factor for c in row) for row in self.layer_costs
            ),
            layer_windows=self.layer_windows,
            stage_of_layer=self.stage_of_layer,
            n_stages=self.n_stages,
            source=self.source,
            device=self.device,
        )

    # -- constructors -------------------------------------------------
    @classmethod
    def from_exec_model(
        cls,
        design,
        workloads,
        serve_tasks,
        *,
        block=DEFAULT_BLOCK,
        backend: str = "jnp",
        window_tiles: int = 4,
        period_scale: float = 1.0,
    ) -> "CostModel":
        """Price each workload layer on its assigned accelerator.

        ``serve_tasks`` (from `design_to_segments`) supply the stage map
        and the block-rounded GEMM geometry the server will actually
        execute, so window counts match the runtime exactly.
        """
        costs, windows, stages = [], [], []
        for i, (w, st) in enumerate(zip(workloads, serve_tasks)):
            if len(w.layers) != len(st.weights):
                raise ValueError(
                    f"task {st.name!r}: workload has {len(w.layers)} "
                    f"layers, serve task {len(st.weights)}"
                )
            row_c, row_w = [], []
            M = st.input_rows
            for layer, weight, k in zip(
                w.layers, st.weights, st.stage_of_layer
            ):
                K, N = weight.shape
                row_c.append(
                    layer_latency(layer, design.accs[k]) * period_scale
                )
                _, n_win = window_plan(
                    M, N, K,
                    block=block, backend=backend,
                    window_tiles=window_tiles,
                )
                row_w.append(n_win)
            costs.append(tuple(row_c))
            windows.append(tuple(row_w))
            stages.append(tuple(st.stage_of_layer))
        return cls(
            layer_costs=tuple(costs),
            layer_windows=tuple(windows),
            stage_of_layer=tuple(stages),
            n_stages=design.n_stages,
            source="exec_model",
        )

    @classmethod
    def calibrate(
        cls, server, *, reps: int = 3, period_scale: float = 1.0
    ) -> "CostModel":
        """Measure per-(task, layer) window times on ``server``'s device
        (warmup-style probes: min over ``reps`` timed windows after one
        untimed pass) and return a measured cost model. On the card each
        window is timed with CUDA events and the model records the
        card's name; on the CPU the host clock times the plain version
        and ``device`` stays None. ``period_scale`` optionally rescales
        the measured seconds onto another timebase."""
        if reps < 1:
            raise ValueError("need at least one timed repetition")
        dev = server.device
        costs, windows, stages = [], [], []
        n_stages = len(server.stages)
        for i, t in enumerate(server.tasks):
            x = server.inputs[i]
            row_c, row_w = [], []
            for w in t.weights:
                M, (K, N) = x.shape[0], w.shape
                window, n_win = window_plan(
                    M, N, K,
                    block=server.block, backend=server.backend,
                    window_tiles=server.window_tiles,
                )
                # untimed pass: kernel build/load and first launch
                c, _ = _run_window(
                    x, w, torch.zeros((M, N), dtype=torch.float32, device=dev), 0,
                    block=server.block, window=window,
                )
                best = min(
                    _time_window(x, w, block=server.block, window=window)
                    for _ in range(reps)
                )
                row_c.append(max(best, 1e-12) * n_win * period_scale)
                row_w.append(n_win)
                # chain shapes like the real execution (one window is
                # enough: probe timing is value-independent and `c`
                # already has the full (M, N) accumulator shape)
                x = c
            costs.append(tuple(row_c))
            windows.append(tuple(row_w))
            stages.append(tuple(t.stage_of_layer))
        return cls(
            layer_costs=tuple(costs),
            layer_windows=tuple(windows),
            stage_of_layer=tuple(stages),
            n_stages=n_stages,
            source="calibrated",
            device=(
                torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
            ),
        )


def _time_window(x, w, *, block, window) -> float:
    """Seconds one window of ``x @ w`` takes on the operands' device."""
    c = torch.zeros(
        (x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device
    )
    if x.device.type == "cuda":
        stream = torch.cuda.current_stream(x.device)
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        _run_window(x, w, c, 0, block=block, window=window)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    # rtlint: disable=clock-domain -- calibration probe: this
    # deliberately measures the plain CPU window's real time
    t0 = time.perf_counter()
    _run_window(x, w, c, 0, block=block, window=window)
    # rtlint: disable=clock-domain -- calibration probe
    return time.perf_counter() - t0
