"""PHAROS serving runtime: per-stage FIFO/EDF scheduling with
tile-window preemption — the paper's §3.2 control flow executing real
compute.

Entities map 1:1 onto the paper's hardware (Fig. 2):

- ``ServeTask``     — a task: an ordered GEMM chain (the DNN layers),
                      period/deadline, and a layer->stage map obeying
                      the pipelined-topology constraint.
- ``StageRuntime``  — one accelerator: a job pool (FIFO deque / EDF
                      heap), a progress table (per-job, per-layer
                      `MatmulProgress`), and the window executor.
- ``PharosServer``  — the decentralized control flow: jobs released by
                      period, forwarded stage->stage when their segment
                      completes (the HLS FIFO streams), preempted
                      between tile windows when EDF priority demands.

Preemption fidelity: a job is only ever interrupted at a *window*
boundary — the running window always completes (``e_tile``), the fp32
partial accumulator already lives in the job's buffer (``e_store``),
and resumption re-streams the operand tiles (``e_load``) — exactly the
Eq. 5 cost structure, realized by `kernels.preemptible_matmul`.

Window geometries: ``backend`` keeps the JAX package's two names, which
here choose only how many tiles one window covers (`window_plan`):
``"jnp"`` runs one output-tile row a window, ``"pallas"`` the configured
tile count. Either way every window is one call of the preemptible
matmul: the CUDA kernel for tensors on the card, its plain version for
CPU tensors. Accumulators are updated in place.
"""
from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from repro_torch.kernels.preemptible_matmul import (
    grid_geometry,
    matmul_window,
    pick_window,
)

DEFAULT_BLOCK = (128, 128, 128)

#: Degenerate safety tick (seconds): the smallest forced clock advance
#: of a serving loop iteration that made no progress — no window ran
#: and the next modeled event is not in the future (a float-equality
#: corner the event-driven advance cannot cross on its own). Advancing
#: by this epsilon guarantees a zero-progress step still terminates
#: instead of spinning; it is far below any modeled window cost, so it
#: never perturbs response times.
DEGENERATE_SAFETY_TICK_S = 1e-9
BACKENDS = ("jnp", "pallas")


def window_plan(
    M: int, N: int, K: int, *, block, backend: str, window_tiles: int
) -> tuple[int, int]:
    """(window size, window count) the executor runs for one
    ``(M,K) @ (K,N)`` layer — the single source of truth for window
    geometry, shared by `_window_for`, the cost-model validation in
    `PharosServer.__init__` and `repro_torch.conformance.CostModel`. The
    jnp geometry serves one output-tile row per window; the pallas
    geometry honours the configured tile count."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _, n_n, _, total = grid_geometry(M, N, K, block)
    window = n_n if backend == "jnp" else pick_window(total, window_tiles)
    return window, -(-total // window)


def _run_window(a, b, c_acc, start, *, block, window):
    """One tile window (a `window_plan` size) of ``a @ b`` into
    ``c_acc``, in place; returns ``(c_acc, next_tile)``."""
    return matmul_window(a, b, c_acc, start, block=block, window_tiles=window)


# ---------------------------------------------------------------------------
# tasks / jobs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ServeTask:
    """A periodic inference task: GEMM-chain layers mapped to stages."""

    name: str
    weights: tuple  # tuple of (K, N) weight tensors, chained
    stage_of_layer: tuple[int, ...]  # non-decreasing (pipelined topology)
    period: float  # seconds
    deadline: float = 0.0  # 0 -> implicit
    input_rows: int = 128  # M of the chain input

    def __post_init__(self):
        if len(self.weights) != len(self.stage_of_layer):
            raise ValueError("one stage per layer required")
        if any(
            b < a
            for a, b in zip(self.stage_of_layer, self.stage_of_layer[1:])
        ):
            raise ValueError("stage map must be non-decreasing (no backtrack)")
        if self.deadline == 0.0:
            object.__setattr__(self, "deadline", self.period)


class Job:
    """One released inference + its progress-table rows.

    ``best_effort`` jobs carry an infinite absolute deadline: EDF orders
    them after every guaranteed job and they never count as deadline
    misses — the degraded service class the traffic layer's shedding
    policies demote to under overload.
    """

    _ids = itertools.count()

    def __init__(
        self,
        task_id: int,
        task: ServeTask,
        release: float,
        x0,
        *,
        best_effort: bool = False,
    ):
        self.uid = next(Job._ids)
        self.task_id = task_id
        self.release = release
        self.best_effort = best_effort
        self.abs_deadline = (
            float("inf") if best_effort else release + task.deadline
        )
        self.layer = 0  # next/current layer index
        self.x = x0  # current activation (input of self.layer)
        self.c_acc = None  # partial fp32 accumulator of current layer
        self.next_tile = 0
        self.done_at: float | None = None
        self.preemptions = 0

    def __repr__(self):
        return f"Job(t{self.task_id}#{self.uid} layer={self.layer})"


class StageRuntime:
    """One accelerator: job pool + running-job slot (paper Fig. 2).

    Best-effort jobs are genuinely demoted under both policies: EDF
    orders their infinite deadline after every guaranteed job, and FIFO
    keeps them in a second queue served only when no guaranteed job is
    waiting.
    """

    def __init__(self, idx: int, policy: str):
        self.idx = idx
        self.policy = policy
        self.fifo: deque[Job] = deque()
        self.fifo_be: deque[Job] = deque()  # best-effort background
        self.edf: list[tuple[float, int, Job]] = []
        self.running: Job | None = None
        # cost-model (virtual-time) mode: end of the window in flight
        self.busy_until = 0.0

    def jobs(self) -> list[Job]:
        """Every job currently resident on this stage (pool + running)."""
        out = list(self.fifo) + list(self.fifo_be)
        out += [j for _, _, j in self.edf]
        if self.running is not None:
            out.append(self.running)
        return out

    def push(self, job: Job) -> None:
        if self.policy == "fifo":
            (self.fifo_be if job.best_effort else self.fifo).append(job)
        else:
            heapq.heappush(self.edf, (job.abs_deadline, job.uid, job))

    def pop(self) -> Job | None:
        if self.policy == "fifo":
            if self.fifo:
                return self.fifo.popleft()
            return self.fifo_be.popleft() if self.fifo_be else None
        return heapq.heappop(self.edf)[2] if self.edf else None

    def head_deadline(self) -> float:
        return self.edf[0][0] if self.edf else float("inf")

    def busy(self) -> bool:
        return (
            self.running is not None
            or bool(self.fifo)
            or bool(self.fifo_be)
            or bool(self.edf)
        )


@dataclass
class ServerReport:
    response_times: dict[str, list[float]]
    #: release times of the completed jobs, aligned 1:1 with
    #: ``response_times`` — the join key for matching "the same job"
    #: across runs whose shed sets differ (conformance under overload)
    completed_releases: dict[str, list[float]]
    deadline_misses: dict[str, int]
    preemptions: int
    jobs_completed: int
    jobs_released: int
    windows_executed: int
    #: released-but-unfinished jobs per task at the last
    #: `PharosServer.finalize_report` — the same number the gateway's
    #: backlog monitor polls via `pending`, so overload verdicts and
    #: conformance checks read one counter
    in_flight: dict[str, int] = field(default_factory=dict)

    def max_response(self, name: str) -> float:
        r = self.response_times.get(name, [])
        return max(r) if r else 0.0

    def total_in_flight(self) -> int:
        return sum(self.in_flight.values())

    def response_percentiles(
        self, name: str, qs=(50, 95, 99)
    ) -> dict[str, float]:
        """Nearest-rank response-time percentiles of one tenant
        (`repro_torch.obs.metrics.percentile` — the one shared
        implementation)."""
        from repro_torch.obs.metrics import percentile_summary

        return percentile_summary(self.response_times.get(name, []), qs)

    def tardiness_percentiles(
        self, name: str, deadline: float, qs=(50, 95, 99)
    ) -> dict[str, float]:
        """Per-tenant tardiness (``max(0, response - deadline)``)
        percentiles against the given relative deadline."""
        from repro_torch.obs.metrics import percentile_summary

        return percentile_summary(
            [
                max(0.0, r - deadline)
                for r in self.response_times.get(name, [])
            ],
            qs,
        )


class PharosServer:
    """Decentralized pipelined serving with FIFO/EDF + preemption.

    ``clock``/``sleep`` are injectable (defaults: wall clock). All
    timestamps inside one serving step come from the same clock, so a
    virtual clock (repro_torch.traffic.clock.VirtualClock) makes the
    runtime fully deterministic: the schedule then follows the cost
    model, whatever device computes the windows.

    ``device`` holds the job inputs and accumulators; every task's
    weights must lie there too. ``inputs`` gives each task's chain input
    ((input_rows, K) arrays or tensors, one per task); without it they
    are drawn from ``torch.Generator().manual_seed(seed)``.

    ``cost_model`` (repro_torch.conformance.CostModel) switches virtual-time
    service from wall-side quantization to model-driven timing: every
    executed tile window occupies its stage for exactly the model's
    per-window WCET on the injected clock, preemption waits for the
    window boundary, and completions are stamped at the modeled finish
    time. Requires an injected (virtual) clock — advancing a wall clock
    by modeled WCETs would be meaningless.

    ``trace`` (a `repro_torch.obs.TraceRecorder`) captures the runtime's
    schedule as structured events — release / dispatch /
    preempt_store / preempt_load (xi = 0: the virtual executor keeps
    accumulators resident, nothing spills) / segment_end / complete /
    deadline_miss — stamped on the injected clock; ``trace_shard`` tags
    every event with the shard index when the server backs one
    `ShardedGateway` replica. None (the default) emits nothing.
    """

    def __init__(
        self,
        tasks: list[ServeTask],
        n_stages: int,
        *,
        policy: str = "edf",
        block=DEFAULT_BLOCK,
        window_tiles: int = 4,
        backend: str = "jnp",
        seed: int = 0,
        inputs=None,
        device="cuda",
        clock=None,
        sleep=None,
        cost_model=None,
        trace=None,
        trace_shard: int = -1,
    ):
        if policy not in ("fifo", "edf"):
            raise ValueError(policy)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.device = torch.device(device)
        for t in tasks:
            if any(w.device.type != self.device.type for w in t.weights):
                raise ValueError(
                    f"task {t.name!r} has weights off the server's "
                    f"device {self.device}"
                )
        if cost_model is not None:
            if clock is None:
                raise ValueError(
                    "cost_model-driven serving needs an injected "
                    "(virtual) clock"
                )
            if cost_model.n_tasks != len(tasks) or any(
                len(cost_model.layer_costs[i]) != len(t.weights)
                for i, t in enumerate(tasks)
            ):
                raise ValueError("cost model does not match the task set")
            # window counts must match the executor's real geometry or
            # per-window charges silently mis-time the whole run
            for i, t in enumerate(tasks):
                for j, w in enumerate(t.weights):
                    K, N = w.shape
                    _, expect = window_plan(
                        t.input_rows, N, K,
                        block=block, backend=backend,
                        window_tiles=window_tiles,
                    )
                    have = cost_model.layer_windows[i][j]
                    if have != expect:
                        raise ValueError(
                            f"cost model window count for task {i} "
                            f"layer {j} is {have}, executor runs "
                            f"{expect}"
                        )
        self.tasks = tasks
        self.policy = policy
        self.block = block
        self.window_tiles = window_tiles
        self.backend = backend
        self.cost_model = cost_model
        # rtlint: disable=clock-domain -- injectable wall-clock defaults
        # for live serving; the DES and tests inject virtual clocks
        self.clock = clock if clock is not None else time.perf_counter
        # rtlint: disable=clock-domain -- same: live-serving default
        self.sleep = sleep if sleep is not None else time.sleep
        # schedule-trace handle, resolved once: disabled tracing emits
        # nothing and costs nothing
        self._tr = (
            trace
            if trace is not None and getattr(trace, "enabled", False)
            else None
        )
        self._tr_shard = trace_shard
        self._missed_in_flight: set[int] = set()
        self.released_per_task = [0] * len(tasks)
        self.completed_per_task = [0] * len(tasks)
        self.stages = [StageRuntime(k, policy) for k in range(n_stages)]
        if inputs is None:
            gen = torch.Generator().manual_seed(seed)
            inputs = [
                torch.randn(
                    (t.input_rows, t.weights[0].shape[0]), generator=gen
                )
                for t in tasks
            ]
        if len(inputs) != len(tasks):
            raise ValueError("one input per task required")
        self.inputs = []
        for t, x in zip(tasks, inputs):
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            if tuple(x.shape) != (t.input_rows, t.weights[0].shape[0]):
                raise ValueError(
                    f"task {t.name!r} input has shape {tuple(x.shape)}, "
                    f"expected {(t.input_rows, t.weights[0].shape[0])}"
                )
            self.inputs.append(x.contiguous())
        self.report = ServerReport(
            response_times={t.name: [] for t in tasks},
            completed_releases={t.name: [] for t in tasks},
            deadline_misses={t.name: 0 for t in tasks},
            preemptions=0,
            jobs_completed=0,
            jobs_released=0,
            windows_executed=0,
        )

    # ------------------------------------------------------------------
    def _start_layer(self, job: Job) -> None:
        t = self.tasks[job.task_id]
        w = t.weights[job.layer]
        M, N = job.x.shape[0], w.shape[1]
        job.c_acc = torch.zeros(
            (M, N), dtype=torch.float32, device=self.device
        )
        job.next_tile = 0

    def _layer_tiles(self, job: Job) -> int:
        t = self.tasks[job.task_id]
        w = t.weights[job.layer]
        M, K = job.x.shape
        _, _, _, total = grid_geometry(M, w.shape[1], K, self.block)
        return total

    def _window_for(self, job: Job) -> int:
        """Preemption quantum of the current layer (see `window_plan`)."""
        t = self.tasks[job.task_id]
        w = t.weights[job.layer]
        M, K = job.x.shape
        window, _ = window_plan(
            M, w.shape[1], K,
            block=self.block, backend=self.backend,
            window_tiles=self.window_tiles,
        )
        return window

    def _finish_layer_or_forward(self, job: Job, now: float) -> None:
        """Layer done: advance; forward to next stage / complete job."""
        t = self.tasks[job.task_id]
        job.x = job.c_acc  # fp32 activation chains to the next GEMM
        job.c_acc = None
        prev_stage = t.stage_of_layer[job.layer]
        job.layer += 1
        if job.layer >= len(t.weights):
            job.done_at = now
            self.report.jobs_completed += 1
            self.completed_per_task[job.task_id] += 1
            rt = now - job.release
            self.report.response_times[t.name].append(rt)
            self.report.completed_releases[t.name].append(job.release)
            missed = (
                now > job.abs_deadline
                and job.uid not in self._missed_in_flight
            )
            if missed:
                # not already counted by a mid-run finalize_report
                self.report.deadline_misses[t.name] += 1
            if self._tr is not None:
                # response/tardiness/missed derive from (t, release,
                # deadline) at read time — same complete-event schema
                # as the DES; completed-job misses are not separately
                # emitted (only in-flight ones at finalize are)
                self._tr.emit(
                    "complete", now, "runtime", t.name,
                    prev_stage, self._tr_shard, release=job.release,
                    attrs={"deadline": job.abs_deadline},
                )
            return
        nxt = t.stage_of_layer[job.layer]
        self._start_layer(job)
        if nxt == prev_stage:
            # same accelerator: continue immediately (still its segment)
            self.stages[nxt].running = job
        else:
            # release to successor via the inter-stage FIFO (paper §3.2)
            if self._tr is not None:
                self._tr.emit(
                    "segment_end", now, "runtime", t.name,
                    prev_stage, self._tr_shard, release=job.release,
                )
            self.stages[nxt].push(job)

    def _preempt_if_due(self, st: StageRuntime, now: float) -> None:
        """EDF preemption check between windows (tile boundary)."""
        if (
            self.policy == "edf"
            and st.running is not None
            and st.head_deadline() < st.running.abs_deadline
        ):
            preempted = st.running
            preempted.preemptions += 1
            self.report.preemptions += 1
            if self._tr is not None:
                name = self.tasks[preempted.task_id].name
                # xi = 0: the virtual executor's accumulator stays
                # resident, so the boundary preemption spills nothing
                # (the conformance premise — raw-WCET comparison)
                self._tr.emit(
                    "preempt_store", now, "runtime", name,
                    st.idx, self._tr_shard, release=preempted.release,
                    attrs={"xi": 0.0},
                )
                self._tr.emit(
                    "preempt_load", now, "runtime", name,
                    st.idx, self._tr_shard, release=preempted.release,
                    attrs={"xi": 0.0},
                )
            st.push(preempted)  # progress table keeps (layer, next_tile)
            st.running = None

    def _emit_dispatch(self, st: StageRuntime, now: float) -> None:
        """Trace a stage server picking a job (fresh or resumed)."""
        if self._tr is None:
            return
        job = st.running
        self._tr.emit(
            "dispatch", now, "runtime",
            self.tasks[job.task_id].name,
            st.idx, self._tr_shard, release=job.release,
            # c_acc still set => mid-layer resume after a preemption
            attrs={"resumed": True} if job.c_acc is not None else None,
        )

    def _exec_window(self, job: Job) -> int:
        """Execute one tile window of ``job``'s current layer; returns
        the layer's total tile count."""
        t = self.tasks[job.task_id]
        w = t.weights[job.layer]
        total = self._layer_tiles(job)
        window = self._window_for(job)
        job.c_acc, job.next_tile = _run_window(
            job.x,
            w,
            job.c_acc,
            job.next_tile,
            block=self.block,
            window=window,
        )
        self.report.windows_executed += 1
        return total

    def _step_stage(self, st: StageRuntime, now: float) -> bool:
        """Run one tile window on stage ``st``. Returns True if it ran."""
        self._preempt_if_due(st, now)
        if st.running is None:
            st.running = st.pop()
            if st.running is None:
                return False
            self._emit_dispatch(st, now)
            if st.running.c_acc is None:
                self._start_layer(st.running)
        job = st.running
        total = self._exec_window(job)
        if self.device.type == "cuda":
            # a launch returns before the card finishes: wait, so the
            # window has really run before the next decision or stamp
            torch.cuda.synchronize(self.device)
        if job.next_tile >= total:
            st.running = None
            # Completion is stamped off the *injected* clock (the window
            # just executed, so re-read rather than reuse loop-entry
            # `now`) — keeps all timestamps on one timebase.
            self._finish_layer_or_forward(job, self.clock())
        return True

    def _step_stage_virtual(self, st: StageRuntime, now: float) -> bool:
        """Cost-model stepping: the stage is occupied until the modeled
        end of the window in flight; compute runs eagerly at window
        start, completion bookkeeping is stamped at ``busy_until``."""
        job = st.running
        if job is not None:
            if now < st.busy_until - 1e-18:
                return False  # mid-window in virtual time
            if job.next_tile >= self._layer_tiles(job):
                st.running = None
                self._finish_layer_or_forward(job, st.busy_until)
                # a same-stage next layer re-occupies `running`; a
                # forwarded/finished job frees the stage for the pool
        self._preempt_if_due(st, now)
        if st.running is None:
            st.running = st.pop()
            if st.running is None:
                return False
            self._emit_dispatch(st, now)
            if st.running.c_acc is None:
                self._start_layer(st.running)
        job = st.running
        self._exec_window(job)
        st.busy_until = now + self.cost_model.window_cost(
            job.task_id, job.layer
        )
        return True

    # ------------------------------------------------------------------
    # traffic-layer API: explicit release / single-step / backlog probes
    # ------------------------------------------------------------------
    def submit(
        self,
        task_id: int,
        release: float | None = None,
        *,
        best_effort: bool = False,
    ) -> Job:
        """Release one job of ``task_id`` (the TrafficGateway entry
        point; `run` uses it for its own periodic releases)."""
        t = self.tasks[task_id]
        job = Job(
            task_id,
            t,
            self.clock() if release is None else release,
            self.inputs[task_id],
            best_effort=best_effort,
        )
        self.stages[t.stage_of_layer[0]].push(job)
        self.report.jobs_released += 1
        self.released_per_task[task_id] += 1
        if self._tr is not None:
            # stamped at the *clock* instant of submission (monotone
            # within the stream); `release` carries the nominal stamp —
            # the cross-layer join key
            self._tr.emit(
                "release", self.clock(), "runtime", t.name,
                t.stage_of_layer[0], self._tr_shard,
                release=job.release,
                attrs={"best_effort": True} if best_effort else None,
            )
        return job

    def step(self) -> bool:
        """Run at most one tile window on every stage; True if any ran."""
        ran = False
        now = self.clock()
        stepper = (
            self._step_stage_virtual
            if self.cost_model is not None
            else self._step_stage
        )
        for st in self.stages:
            ran |= stepper(st, now)
        return ran

    def next_completion_time(self) -> float:
        """Earliest modeled window-boundary across busy stages (inf when
        every stage is idle) — the event a cost-model-driven caller
        should advance its virtual clock to."""
        ends = [
            st.busy_until for st in self.stages if st.running is not None
        ]
        return min(ends) if ends else float("inf")

    def pending(self, task_id: int) -> int:
        """Jobs of ``task_id`` released but not yet completed."""
        return (
            self.released_per_task[task_id]
            - self.completed_per_task[task_id]
        )

    def queue_depths(self) -> list[int]:
        """Per-stage backlog (pool + in-flight) — the observable the
        traffic layer checks against the analysis."""
        return [
            len(st.fifo)
            + len(st.fifo_be)
            + len(st.edf)
            + (1 if st.running else 0)
            for st in self.stages
        ]

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Run one window of every layer before serving — the kernel
        build and load, and the first launch of each geometry, would
        otherwise stall the first hyperperiod. One launch per layer."""
        for i, t in enumerate(self.tasks):
            x = self.inputs[i]
            for w in t.weights:
                M, N = x.shape[0], w.shape[1]
                window, _ = window_plan(
                    M, N, x.shape[1],
                    block=self.block, backend=self.backend,
                    window_tiles=self.window_tiles,
                )
                c = torch.zeros((M, N), dtype=torch.float32, device=self.device)
                c, _ = _run_window(x, w, c, 0, block=self.block, window=window)
                x = c  # chain shapes like the real execution
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finalize_report(self, now: float | None = None) -> ServerReport:
        """Horizon-end accounting: expose per-task in-flight counts and
        count deadline misses of jobs still executing past their
        absolute deadline — an overloaded run would otherwise report
        zero misses because unfinished jobs were never examined.
        Idempotent: each in-flight job is counted as a miss once."""
        now = self.clock() if now is None else now
        self.report.in_flight = {
            t.name: self.pending(i) for i, t in enumerate(self.tasks)
        }
        for st in self.stages:
            for job in st.jobs():
                if (
                    now > job.abs_deadline
                    and job.uid not in self._missed_in_flight
                ):
                    self._missed_in_flight.add(job.uid)
                    name = self.tasks[job.task_id].name
                    self.report.deadline_misses[name] += 1
                    if self._tr is not None:
                        self._tr.emit(
                            "deadline_miss", now, "runtime", name,
                            st.idx, self._tr_shard,
                            release=job.release,
                            attrs={"in_flight": True},
                        )
        return self.report

    def run(self, horizon_s: float) -> ServerReport:
        """Serve for ``horizon_s`` clock seconds (periodic releases)."""
        self.warmup()
        t0 = self.clock()
        next_release = [t0 for _ in self.tasks]
        while True:
            now = self.clock()
            if now - t0 >= horizon_s:
                break
            for i, t in enumerate(self.tasks):
                while next_release[i] <= now:
                    self.submit(i, next_release[i])
                    next_release[i] += t.period
            ran = self.step()
            if self.cost_model is not None:
                # event-driven virtual time: jump to the next modeled
                # window boundary or the next periodic release
                nxt = min(
                    self.next_completion_time(),
                    min(next_release),
                    t0 + horizon_s,
                )
                now2 = self.clock()
                if nxt > now2:
                    self.sleep(nxt - now2)
                elif not ran:
                    self.sleep(DEGENERATE_SAFETY_TICK_S)
            elif not ran:
                self.sleep(1e-4)  # idle
        return self.finalize_report(t0 + horizon_s)
