"""Event-driven pipeline scheduler simulator.

Clock semantics: the simulator runs on its own event-driven virtual
timebase — event timestamps are exact model seconds, never wall time.
It shares no clock with the serving runtime; the conformance harness
(the JAX package's `repro.conformance`) aligns the two by driving both from the same
WCETs and release traces.

Design notes
------------
* Entities: ``M`` stages, each a single server with a job pool. A task
  is a sequence of segments ``[(stage, wcet), ...]`` executed strictly
  in order; chained (PHAROS) designs have increasing stage indices,
  throughput-guided baselines may revisit stages (backtracking), which
  the polling/no-polling FIFO variants treat differently.
* Preemption model (EDF only; FIFO never preempts). Two granularities,
  selected by ``SimConfig.preemption``:

  - ``"instant"`` — idealized: when a job with an earlier absolute
    deadline arrives at a busy stage, the running job is preempted
    immediately. Overhead mirrors the paper's tile-granular mechanism:
    the preemptor starts after ``pre = e_tile + e_store`` (drain the
    current tile, spill partial outputs) and the preempted job pays
    ``post = e_load`` extra on resume (buffer reload).
  - ``"window"`` — limited preemption, matching the `PharosServer`
    runtime: each segment executes as a sequence of non-preemptible
    *chunks* (`SimTask.chunks`, e.g. the `CostModel`'s per-layer tile
    windows; default: one chunk = the whole segment). Preemption
    decisions happen **only at chunk boundaries**, so an urgent job
    blocks for at most the in-flight chunk. Because the boundary
    already absorbed the drain (``e_tile`` becomes real blocking, not
    inserted work), each actual preemption *event* charges only
    ``e_store`` to the preemptor's start and ``e_load`` to the
    preempted job's resume — Eq. 4's xi is paid per preemption event,
    not inflated per job.
* Events are versioned per stage (``epoch``): a scheduled completion is
  ignored if the stage has been re-dispatched since it was scheduled.
* Simultaneous-event ordering mirrors the serving runtime's control
  flow exactly: at one instant, all due releases fire first (in task
  order — the gateway submits its merged, ``(time, task)``-sorted
  schedule before stepping), then stage completions are processed in
  ascending stage index (``PharosServer.step`` iterates stages in
  index order). FIFO pools break arrival-time ties by *pool insertion
  order* (the runtime's deque order), so fan-in stages — two upstream
  stages forwarding into one downstream stage at the same instant —
  order jobs identically in both layers.
* Release-time shedding (`SimConfig.shedding`): the DES can mirror the
  gateway's backlog-triggered overload policies *inside* the
  simulation — per-release verdicts (submit / drop / degrade to
  best-effort) against the simulated backlog with the same hysteresis
  the `BacklogMonitor` applies, so DES, runtime and analysis can be
  conformance-checked under overload (see
  `repro_torch.traffic.shedding.des_release_shedding`).
* Schedulability detection (paper §5.2): simulate ``horizon`` (default
  >100x max period); declare *non*-schedulable if unfinished jobs
  accumulate or response times grow between the first and second half.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable

#: release-time shedding verdicts (string-identical to the gateway's
#: `repro_torch.traffic.shedding` constants so adapters need no translation)
SHED_SUBMIT = "submit"
SHED_DROP = "drop"
SHED_BEST_EFFORT = "best_effort"


@dataclass(frozen=True)
class SimTask:
    """One task: ordered segments of (stage, wcet).

    Releases are strictly periodic (``phase + n * period``) unless
    ``arrivals`` gives an explicit release-time sequence — sporadic,
    Poisson, bursty MMPP, and trace-driven traffic (repro_torch.traffic) all
    flow through that one hook. With explicit arrivals ``period`` is
    only used for analysis/metrics (set it to the minimum inter-arrival
    for sporadic traffic, or the provisioned period for stochastic
    traffic) and ``phase`` is ignored; the simulation releases exactly
    ``len(arrivals)`` jobs.
    """

    segments: tuple[tuple[int, float], ...]
    period: float
    deadline: float = 0.0  # relative; 0 -> implicit (= period)
    phase: float = 0.0
    name: str = ""
    arrivals: tuple[float, ...] | None = None  # explicit release times
    #: per-segment non-preemptible chunk lengths (window-boundary
    #: preemption, ``SimConfig.preemption == "window"``); aligned with
    #: ``segments`` as passed in, each tuple summing to that segment's
    #: WCET. None -> every segment is one indivisible chunk.
    chunks: tuple[tuple[float, ...], ...] | None = None

    def __post_init__(self) -> None:
        if self.deadline == 0.0:
            object.__setattr__(self, "deadline", self.period)
        raw = tuple(self.segments)
        if self.chunks is not None and len(self.chunks) != len(raw):
            raise ValueError("chunks must align 1:1 with segments")
        keep = [i for i, (_s, w) in enumerate(raw) if w > 0.0]
        segs = tuple((raw[i][0], raw[i][1]) for i in keep)
        object.__setattr__(self, "segments", segs)
        if not segs:
            raise ValueError("task has no non-empty segments")
        if self.chunks is not None:
            chs = tuple(tuple(float(c) for c in self.chunks[i]) for i in keep)
            for (_s, w), ch in zip(segs, chs):
                if not ch or any(c <= 0.0 for c in ch):
                    raise ValueError("chunk lengths must be positive")
                if abs(sum(ch) - w) > 1e-6 * max(w, 1e-12):
                    raise ValueError(
                        "segment chunks must sum to the segment WCET"
                    )
            object.__setattr__(self, "chunks", chs)
        if self.arrivals is not None:
            arr = tuple(float(a) for a in self.arrivals)
            if any(a < 0.0 for a in arr):
                raise ValueError("arrival times must be non-negative")
            if any(b < a for a, b in zip(arr, arr[1:])):
                raise ValueError("arrival times must be non-decreasing")
            object.__setattr__(self, "arrivals", arr)

    def segment_chunks(self, seg_idx: int) -> tuple[float, ...]:
        """Non-preemptible chunk schedule of one segment (the whole
        segment when no explicit schedule was given)."""
        if self.chunks is not None:
            return self.chunks[seg_idx]
        return (self.segments[seg_idx][1],)

    def min_inter_arrival(self) -> float:
        """Smallest observed gap (periodic tasks: the period) — the
        conservative 'period' for utilization accounting."""
        if self.arrivals is None or len(self.arrivals) < 2:
            return self.period
        return min(b - a for a, b in zip(self.arrivals, self.arrivals[1:]))


@dataclass(frozen=True)
class StageOverhead:
    """Per-stage preemption cost split (Eq. 5)."""

    e_tile: float = 0.0
    e_store: float = 0.0
    e_load: float = 0.0

    @property
    def pre(self) -> float:  # paid before the preemptor starts
        return self.e_tile + self.e_store

    @property
    def post(self) -> float:  # paid by the preempted job on resume
        return self.e_load

    @property
    def xi(self) -> float:
        return self.e_tile + self.e_store + self.e_load


@dataclass
class ReleaseShedding:
    """Release-time overload shedding against *simulated* backlog.

    Mirrors the gateway's `BacklogMonitor` + `SheddingPolicy` pair
    inside the DES: at every release, each task's pending-job count is
    checked against its ``limits[i]`` engage threshold with the same
    hysteresis (engage above the limit, disengage at half), and while
    any task is engaged ``classify(task_id, overloaded)`` decides the
    releasing job's fate — `SHED_SUBMIT`, `SHED_DROP` (never enters the
    system) or `SHED_BEST_EFFORT` (enters with an infinite absolute
    deadline: EDF orders it after every guaranteed job).

    The DES stays dependency-free: ``classify`` is an opaque callable;
    `repro_torch.traffic.shedding.des_release_shedding` builds one from a
    real `SheddingPolicy` + `AdmissionController` + request contracts,
    with ``limits`` derived from the analysis response bounds exactly
    like `TrafficGateway.open` derives the gateway's.
    """

    limits: tuple[int, ...]
    classify: Callable[[int, tuple[int, ...]], str]
    engaged: dict[int, bool] = field(default_factory=dict)

    def observe(self, task_idx: int, pending: int) -> bool:
        limit = self.limits[task_idx]
        on = self.engaged.get(task_idx, False)
        if not on and pending > limit:
            on = True
        elif on and pending <= max(1, limit // 2):
            on = False
        self.engaged[task_idx] = on
        return on


@dataclass
class SimConfig:
    policy: str = "edf"  # "fifo" | "fifo_no_polling" | "edf"
    horizon: float = 0.0  # 0 -> 120 x max period
    overheads: list[StageOverhead] | None = None  # None -> zero overhead
    #: "instant" — idealized immediate preemption; "window" — limited
    #: preemption at `SimTask.chunks` boundaries only (the runtime's
    #: tile-window semantics), xi charged per actual preemption event
    preemption: str = "instant"
    backlog_limit: int = 64  # pending jobs per task before declaring overload
    #: divergence tolerance, 2nd half vs 1st half of the trace. Growth
    #: is declared only when *both* the mean and the max response rise
    #: past this factor. The paper's detector is backlog accumulation
    #: (`backlog_limit`) alone; this heuristic is a secondary early
    #: signal, so the tolerance is deliberately loose — bounded systems
    #: with near-commensurate periods legitimately drift their worst
    #: phasing/collision rate across a finite trace by tens of percent,
    #: while true divergence (u > 1) grows the response linearly in the
    #: horizon (far past 2x between halves).
    growth_tol: float = 2.0
    #: release-time overload shedding (None -> every release enters).
    #: Duck-typed: anything with `ReleaseShedding`'s observe / engaged /
    #: classify surface works — `repro_torch.traffic.modes.ModeController`
    #: plugs in here to run mixed-criticality mode switching against
    #: the simulated backlog (its committed transitions are drained via
    #: an optional ``drain_events()`` hook into ``mode_switch`` trace
    #: events and `SimResult.mode_switches`)
    shedding: ReleaseShedding | None = None
    #: schedule-trace sink (duck-typed `repro_torch.obs.TraceRecorder` — the
    #: DES stays dependency-free). Resolved once per `simulate` call:
    #: None or a disabled recorder means zero per-event work and zero
    #: events emitted; an enabled recorder receives release / dispatch /
    #: preempt_store / preempt_load / segment_end / complete /
    #: deadline_miss / shed events on the DES's virtual timebase
    trace: object | None = None


@dataclass
class SimResult:
    schedulable: bool
    response_times: list[list[float]]  # per task, completed jobs in order
    max_response: list[float]
    mean_response: list[float]
    preemptions: int
    jobs_released: int
    jobs_completed: int
    overload_detected: bool
    growth_detected: bool
    #: release times of the completed jobs, aligned 1:1 with
    #: ``response_times`` — the join key for matching "the same job"
    #: across runs whose shed sets differ (conformance under overload)
    completed_releases: list[list[float]] = field(default_factory=list)
    #: release-time shedding accounting (all zero without
    #: `SimConfig.shedding`)
    jobs_shed: int = 0
    shed_per_task: list[int] = field(default_factory=list)
    degraded_per_task: list[int] = field(default_factory=list)
    #: committed mixed-criticality transitions, in commit order:
    #: ``(t, mode, survivors)`` tuples drained from a mode-aware
    #: shedding hook (`repro_torch.traffic.modes.ModeController`); empty
    #: without one
    mode_switches: list[tuple[float, str, tuple[str, ...]]] = field(
        default_factory=list
    )

    def max_response_overall(self) -> float:
        vals = [m for m in self.max_response if m > 0.0]
        return max(vals) if vals else 0.0

    def response_percentiles(
        self, task_idx: int, qs=(50, 95, 99)
    ) -> dict[str, float]:
        """Nearest-rank response-time percentiles of one task
        (`repro_torch.obs.metrics.percentile` — the one shared
        implementation)."""
        from repro_torch.obs.metrics import percentile_summary

        return percentile_summary(self.response_times[task_idx], qs)

    def tardiness_percentiles(
        self, task_idx: int, deadline: float, qs=(50, 95, 99)
    ) -> dict[str, float]:
        """Per-task tardiness (``max(0, response - deadline)``)
        percentiles against the given relative deadline."""
        from repro_torch.obs.metrics import percentile_summary

        return percentile_summary(
            [
                max(0.0, r - deadline)
                for r in self.response_times[task_idx]
            ],
            qs,
        )


class _Job:
    __slots__ = (
        "task_id",
        "idx",
        "release",
        "abs_deadline",
        "name",
        "seg_idx",
        "remaining",
        "arrive_stage_t",
        "enter_seq",
        "stage_done",
        "chunk_i",
        "carry",
    )

    def __init__(self, task_id: int, idx: int, release: float, abs_deadline: float):
        self.task_id = task_id
        self.idx = idx
        self.release = release
        self.abs_deadline = abs_deadline
        # task name cached per job when tracing (one lookup per release
        # instead of one per emitted event); "" untraced
        self.name = ""
        self.seg_idx = 0  # next segment to execute
        self.remaining = 0.0  # remaining service of the segment in flight
        self.arrive_stage_t = release
        self.enter_seq = 0  # pool-insertion order (FIFO tie-breaking)
        # per-segment completion flags, for the polling variants
        self.stage_done: list[bool] = []
        # window-boundary (limited-preemption) bookkeeping
        self.chunk_i = 0  # next chunk of the segment in flight
        self.carry = 0.0  # resume overhead owed before the next chunk


class _Stage:
    __slots__ = ("idx", "pool", "running", "run_start", "epoch", "block_until")

    def __init__(self, idx: int):
        self.idx = idx
        self.pool: list[_Job] = []
        self.running: _Job | None = None
        self.run_start = 0.0
        self.epoch = 0
        self.block_until = 0.0  # non-preemptible overhead window end


def _job_key_fifo(j: _Job):
    # pool-insertion order breaks arrival-time ties — the runtime's
    # FIFO deque order (fan-in forwards land in upstream-stage order)
    return (j.arrive_stage_t, j.enter_seq)


def _job_key_edf(j: _Job):
    return (j.abs_deadline, j.release, j.task_id, j.idx)


def simulate(tasks: list[SimTask], cfg: SimConfig) -> SimResult:
    if cfg.policy not in ("fifo", "fifo_no_polling", "edf"):
        raise ValueError(f"unknown policy {cfg.policy!r}")
    if cfg.preemption not in ("instant", "window"):
        raise ValueError(f"unknown preemption model {cfg.preemption!r}")
    n_stages = 1 + max(s for t in tasks for s, _ in t.segments)
    overheads = cfg.overheads or [StageOverhead()] * n_stages
    if len(overheads) < n_stages:
        raise ValueError("overheads shorter than number of stages")
    horizon = cfg.horizon or 120.0 * max(t.period for t in tasks)
    preemptive = cfg.policy == "edf"
    window_mode = cfg.preemption == "window"
    key = _job_key_edf if preemptive else _job_key_fifo
    # trace sink resolved once (`repro_torch.obs.TraceRecorder.sink`):
    # disabled tracing costs one `is not None` test per emission site
    # and emits nothing at all; enabled tracing pays one call + one
    # row tuple per event — the <5% DES budget obs_bench enforces
    tr = (
        cfg.trace.sink()
        if cfg.trace is not None and getattr(cfg.trace, "enabled", False)
        else None
    )
    names = (
        [t.name or f"task{i}" for i, t in enumerate(tasks)]
        if tr is not None
        else []
    )

    stages = [_Stage(k) for k in range(n_stages)]
    # Event heap: (time, kind, prio, seq, data). kinds: 0=release,
    # 1=complete. Simultaneous events mirror the runtime's control
    # flow: releases before completions (the serving loop submits due
    # arrivals before stepping), releases in task order (the gateway's
    # merged schedule), completions in ascending stage index
    # (`PharosServer.step` iterates stages in index order). ``prio`` is
    # the task id for releases and the stage index for completions —
    # data[0] either way.
    evq: list[tuple[float, int, int, int, tuple]] = []
    seq = 0

    def push(t: float, kind: int, data: tuple) -> None:
        nonlocal seq
        heapq.heappush(evq, (t, kind, data[0], seq, data))
        seq += 1

    # Per-task bookkeeping for the FIFO gating variants and metrics.
    n_tasks = len(tasks)
    response: list[list[float]] = [[] for _ in range(n_tasks)]
    # jobs of each task that have completed ALL segments, contiguous prefix
    completed_upto = [-1] * n_tasks
    # per (task, job_idx) segment-completion map for "with polling" gating
    seg_complete: dict[tuple[int, int], list[bool]] = {}
    pending_count = [0] * n_tasks
    completed_releases: list[list[float]] = [[] for _ in range(n_tasks)]
    preemptions = 0
    jobs_released = 0
    jobs_completed = 0
    jobs_shed = 0
    shed_per_task = [0] * n_tasks
    degraded_per_task = [0] * n_tasks
    mode_switches: list[tuple[float, str, tuple[str, ...]]] = []
    # mode-transition drain hook, resolved once like the trace sink: a
    # mode-aware shedding object (`repro_torch.traffic.modes.ModeController`)
    # commits transitions during the observe sweep and the DES stamps
    # them with its virtual clock here
    drain_modes = (
        getattr(cfg.shedding, "drain_events", None)
        if cfg.shedding is not None
        else None
    )
    overload = False
    enter_counter = 0

    # Queue of jobs waiting for their same-task gating condition, per task.
    gated: list[list[_Job]] = [[] for _ in range(n_tasks)]

    def gate_open(job: _Job) -> bool:
        """May `job` enter the pool of its next segment's stage?"""
        t_id, j_idx, s_idx = job.task_id, job.idx, job.seg_idx
        if j_idx == 0:
            return True
        stage_k = tasks[t_id].segments[s_idx][0]
        if cfg.policy == "fifo_no_polling":
            # previous job of this task must have finished ALL its
            # segments mapped to this stage
            prev = seg_complete.get((t_id, j_idx - 1))
            if prev is None:  # previous job fully done and GC'd
                return completed_upto[t_id] >= j_idx - 1
            for si, (st, _w) in enumerate(tasks[t_id].segments):
                if st == stage_k and not prev[si]:
                    return False
            return True
        else:
            # With polling (and EDF) the same-task precedence —
            # job j's segment must not *run* before job j-1's
            # corresponding segment is done — is already enforced by
            # the pool ordering itself: identical visit sequences mean
            # j can never overtake j-1 at any stage (FIFO keeps j-1
            # ahead in insertion order; EDF gives it the earlier
            # deadline), so j reaches the server only after j-1's
            # segment completed. Enqueue immediately — the serving
            # runtime does exactly this, and holding j back to the
            # gate-open instant would hand its queue position to
            # third-party jobs arriving in between (the fan-in
            # tie-breaking drift the conformance harness used to
            # absorb in `quantum_slack`).
            return True

    def enter_stage(job: _Job, now: float) -> None:
        nonlocal enter_counter
        stage_k = tasks[job.task_id].segments[job.seg_idx][0]
        job.arrive_stage_t = now
        enter_counter += 1
        job.enter_seq = enter_counter
        job.remaining = tasks[job.task_id].segments[job.seg_idx][1]
        job.chunk_i = 0
        job.carry = 0.0
        stages[stage_k].pool.append(job)
        dispatch(stages[stage_k], now)

    def try_admit(job: _Job, now: float) -> None:
        if gate_open(job):
            enter_stage(job, now)
        else:
            gated[job.task_id].append(job)

    def recheck_gated(t_id: int, now: float) -> None:
        still = []
        for job in gated[t_id]:
            if gate_open(job):
                enter_stage(job, now)
            else:
                still.append(job)
        gated[t_id] = still

    def advance_completed(t_id: int) -> None:
        """Advance the contiguous fully-completed job prefix."""
        while True:
            flags = seg_complete.get((t_id, completed_upto[t_id] + 1))
            if flags is None or not all(flags):
                break
            completed_upto[t_id] += 1
            seg_complete.pop((t_id, completed_upto[t_id] - 1), None)

    def start_chunk(st: _Stage, job: _Job, now: float) -> None:
        """Window mode: occupy the stage with ``job``'s next
        non-preemptible chunk (plus any resume overhead owed)."""
        quantum = (
            tasks[job.task_id].segment_chunks(job.seg_idx)[job.chunk_i]
            + job.carry
        )
        job.carry = 0.0
        st.running = job
        st.epoch += 1
        st.run_start = now
        push(now + quantum, 1, (st.idx, st.epoch))

    def dispatch(st: _Stage, now: float) -> None:
        """(Re)assign the stage server; possibly preempt (EDF).

        Window mode never preempts here: a busy stage stays busy until
        its chunk-completion event (`on_chunk_boundary`) fires.
        """
        nonlocal preemptions
        if not st.pool and st.running is None:
            return
        if st.running is not None:
            if window_mode or not preemptive or not st.pool:
                return
            best = min(st.pool, key=key)
            if best.abs_deadline >= st.running.abs_deadline:
                return
            if now < st.block_until:
                return  # inside a non-preemptible overhead window
            # --- preemption: drain tile + spill, then swap ---
            ov = overheads[st.idx]
            run = st.running
            done_frac = now - st.run_start
            run.remaining = max(0.0, run.remaining - done_frac) + ov.post
            st.pool.append(run)  # back to the pool, resumes later
            st.pool.remove(best)
            preemptions += 1
            if tr is not None:
                tr((now, "preempt_store", run.name,
                    st.idx, run.release, ov.pre))
                tr((now, "preempt_load", run.name,
                    st.idx, run.release, ov.post))
                tr((now, "dispatch", best.name, st.idx, best.release))
            st.running = best
            st.epoch += 1
            st.block_until = now + ov.pre
            st.run_start = now + ov.pre
            push(st.run_start + best.remaining, 1, (st.idx, st.epoch))
            return
        # idle server: pick next
        nxt = min(st.pool, key=key)
        st.pool.remove(nxt)
        if tr is not None:
            tr((now, "dispatch", nxt.name, st.idx, nxt.release))
        if window_mode:
            start_chunk(st, nxt, now)
            return
        st.running = nxt
        st.epoch += 1
        st.run_start = now
        push(now + nxt.remaining, 1, (st.idx, st.epoch))

    def on_chunk_boundary(st: _Stage, now: float) -> None:
        """Window mode completion event: one non-preemptible chunk
        finished. Either the segment is done, or this is the only point
        where an EDF preemption decision may happen — the runtime's
        tile-window boundary. A boundary preemption charges ``e_store``
        to the preemptor's start and ``e_load`` to the preempted job's
        resume (the drain already happened: the chunk ran to its end)."""
        nonlocal preemptions
        job = st.running
        assert job is not None
        chs = tasks[job.task_id].segment_chunks(job.seg_idx)
        job.chunk_i += 1
        job.remaining = max(0.0, job.remaining - chs[job.chunk_i - 1])
        if job.chunk_i >= len(chs):
            on_complete(st, now)
            return
        if preemptive and st.pool:
            best = min(st.pool, key=key)
            if best.abs_deadline < job.abs_deadline:
                ov = overheads[st.idx]
                job.carry += ov.post  # reload when it resumes
                st.pool.append(job)
                st.pool.remove(best)
                preemptions += 1
                best.carry += ov.e_store  # spill of the preempted job
                if tr is not None:
                    tr((now, "preempt_store", job.name,
                        st.idx, job.release, ov.e_store))
                    tr((now, "preempt_load", job.name,
                        st.idx, job.release, ov.post))
                    tr((now, "dispatch", best.name,
                        st.idx, best.release))
                start_chunk(st, best, now)
                return
        start_chunk(st, job, now)  # keep running: next chunk

    def on_complete(st: _Stage, now: float) -> None:
        nonlocal jobs_completed
        job = st.running
        assert job is not None
        st.running = None
        st.epoch += 1
        t_id, j_idx = job.task_id, job.idx
        seg_complete[(t_id, j_idx)][job.seg_idx] = True
        job.seg_idx += 1
        if job.seg_idx >= len(tasks[t_id].segments):
            # job fully done
            response[t_id].append(now - job.release)
            completed_releases[t_id].append(job.release)
            pending_count[t_id] -= 1
            jobs_completed += 1
            advance_completed(t_id)
            if tr is not None:
                # the bare-float payload is the absolute deadline:
                # response/tardiness/missed derive at read time (t -
                # release, t - deadline) — a dict plus the arithmetic
                # here would triple this site's cost, and a separate
                # deadline_miss event would double it for late jobs
                tr((now, "complete", job.name, st.idx, job.release,
                    job.abs_deadline))
        else:
            if tr is not None and not st.pool:
                # only the idle edge needs an explicit boundary: when
                # the pool is non-empty the same-instant dispatch of
                # the successor marks it (and closes the Chrome span)
                tr((now, "segment_end", job.name,
                    st.idx, job.release))
            try_admit(job, now)
        recheck_gated(t_id, now)
        dispatch(st, now)

    # ---- main loop ----
    release_counts = [0] * n_tasks
    for t_id, t in enumerate(tasks):
        if t.arrivals is not None:
            if t.arrivals:
                push(t.arrivals[0], 0, (t_id,))
        else:
            push(t.phase, 0, (t_id,))

    growth = False
    while evq:
        now, kind, _prio, _s, data = heapq.heappop(evq)
        if now > horizon or overload:
            break
        if kind == 0:
            (t_id,) = data
            t = tasks[t_id]
            j_idx = release_counts[t_id]
            release_counts[t_id] += 1
            # the arrival stream continues whatever this release's fate
            if t.arrivals is not None:
                if j_idx + 1 < len(t.arrivals):
                    push(t.arrivals[j_idx + 1], 0, (t_id,))
            else:
                push(now + t.period, 0, (t_id,))
            verdict = SHED_SUBMIT
            if cfg.shedding is not None:
                # refresh hysteresis for every task (pending counts
                # change between releases as jobs complete), exactly
                # like the gateway's per-release monitor sweep
                for i2 in range(n_tasks):
                    cfg.shedding.observe(i2, pending_count[i2])
                if drain_modes is not None:
                    for sw in drain_modes():
                        mode_switches.append((now, sw.mode, sw.survivors))
                        if tr is not None:
                            tr((now, "mode_switch", "", -1, None, {
                                "mode": sw.mode,
                                "survivors": sw.survivors,
                                "schedulable": sw.schedulable,
                            }))
                overloaded = tuple(
                    i2
                    for i2 in range(n_tasks)
                    if cfg.shedding.engaged.get(i2)
                )
                if overloaded:
                    verdict = cfg.shedding.classify(t_id, overloaded)
            if verdict == SHED_DROP:
                jobs_shed += 1
                shed_per_task[t_id] += 1
                if tr is not None:
                    tr((now, "shed", names[t_id],
                        t.segments[0][0], now))
                # a shed job must not deadlock the same-task gating
                # chain: mark its segments trivially complete so the
                # next job's gate sees through it
                seg_complete[(t_id, j_idx)] = [True] * len(t.segments)
                advance_completed(t_id)
                recheck_gated(t_id, now)
                continue
            jobs_released += 1
            if tr is not None:
                if verdict == SHED_BEST_EFFORT:
                    tr((now, "release", names[t_id],
                        t.segments[0][0], now, {"best_effort": True}))
                else:
                    tr((now, "release", names[t_id],
                        t.segments[0][0], now))
            deadline = (
                math.inf if verdict == SHED_BEST_EFFORT else t.deadline
            )
            if verdict == SHED_BEST_EFFORT:
                degraded_per_task[t_id] += 1
            job = _Job(t_id, j_idx, now, now + deadline)
            if tr is not None:
                job.name = names[t_id]
            seg_complete[(t_id, j_idx)] = [False] * len(t.segments)
            pending_count[t_id] += 1
            if pending_count[t_id] > cfg.backlog_limit:
                overload = True
            try_admit(job, now)
        else:
            st_idx, epoch = data
            st = stages[st_idx]
            if st.epoch != epoch or st.running is None:
                continue  # stale completion (preempted/re-dispatched)
            if window_mode:
                on_chunk_boundary(st, now)
            else:
                on_complete(st, now)

    # ---- verdict ----
    # Theory cap: with every stage utilization < 1, any work-conserving
    # policy bounds a job's response by the sum of per-stage busy
    # periods L_k <= (sum_i e_i^k) / (1 - u_k). Observed responses under
    # this cap are NOT divergence, no matter how the finite-horizon
    # halves drift (near-commensurate periods can push the first
    # collision arbitrarily late).
    # Explicit-arrival tasks use their minimum observed inter-arrival as
    # the utilization-accounting period — at most as many releases can
    # occur in any interval as a periodic task at that gap, so the cap
    # stays a valid upper bound (and degrades to inf for bursty traces
    # whose min gap saturates a stage — conservative direction).
    # Under a preemptive policy the busy-period demand must carry the
    # Eq. 4 overhead inflation: a system whose overhead-inflated
    # utilization reaches 1 can genuinely diverge even though its raw
    # u^k < 1, and a raw-WCET cap would wrongly clear the growth flag
    # for it. Instant preemption inflates by xi per stage visit; window
    # mode charges (e_store + e_load) per actual preemption event, and a
    # segment of c chunks can be preempted at most c - 1 times (only at
    # its own interior boundaries), so the per-visit inflation is
    # (e_store + e_load) * (c - 1) — e_tile is real blocking there, not
    # inserted work.
    theory_cap = 0.0
    acct_periods = [t.min_inter_arrival() for t in tasks]
    for k in range(n_stages):
        xi_k = overheads[k].xi if preemptive else 0.0
        ev_k = overheads[k].e_store + overheads[k].e_load
        e_k = []
        for t in tasks:
            raw = sum(w for st, w in t.segments if st == k)
            if not preemptive or raw <= 0.0:
                e_k.append(raw if raw > 0.0 else 0.0)
                continue
            if window_mode:
                infl = sum(
                    ev_k * (len(t.segment_chunks(si)) - 1)
                    for si, (st, _w) in enumerate(t.segments)
                    if st == k
                )
            else:
                visits = sum(1 for st, _w in t.segments if st == k)
                infl = xi_k * visits
            e_k.append(raw + infl)
        u_k = sum(
            e / p for e, p in zip(e_k, acct_periods) if p > 0.0
        )
        if u_k >= 1.0 - 1e-12 or any(
            e > 0.0 and p <= 0.0 for e, p in zip(e_k, acct_periods)
        ):
            theory_cap = math.inf
            break
        theory_cap += sum(e_k) / (1.0 - u_k)
    max_r, mean_r = [], []
    for t_id in range(n_tasks):
        r = response[t_id]
        max_r.append(max(r) if r else 0.0)
        mean_r.append(sum(r) / len(r) if r else 0.0)
        if len(r) >= 8:
            half = len(r) // 2
            mean1 = sum(r[:half]) / half
            mean2 = sum(r[half:]) / (len(r) - half)
            max1, max2 = max(r[:half]), max(r[half:])
            if (
                mean2 > mean1 * cfg.growth_tol + 1e-12
                and max2 > max1 * cfg.growth_tol + 1e-12
            ):
                growth = True
        elif release_counts[t_id] - shed_per_task[t_id] >= 8:
            # Few completions despite many releases is only divergence
            # when completions actually *lag* the releases: a finite
            # trace whose last jobs are simply cut off by the horizon
            # (explicit-arrival bursts, long tails) must not be flagged.
            # Short traces where the lag is large but under the margin
            # are inherently ambiguous (pipeline fill vs true growth);
            # this heuristic deliberately errs schedulable there and
            # leaves those to the primary detectors (backlog_limit
            # overload and, on longer traces, the two-halves test).
            # Shed jobs never entered the system, so they are not lag.
            entered = release_counts[t_id] - shed_per_task[t_id]
            lag = entered - len(r)
            if lag >= 8 and 2 * lag > entered:
                growth = True  # most released jobs never finished
    if (
        growth
        and theory_cap != math.inf
        and all(m <= theory_cap + 1e-9 for m in max_r)
    ):
        growth = False  # bounded by the busy-period cap -> not divergence
    schedulable = (not overload) and (not growth) and jobs_completed > 0
    return SimResult(
        schedulable=schedulable,
        response_times=response,
        max_response=max_r,
        mean_response=mean_r,
        preemptions=preemptions,
        jobs_released=jobs_released,
        jobs_completed=jobs_completed,
        overload_detected=overload,
        growth_detected=growth,
        completed_releases=completed_releases,
        jobs_shed=jobs_shed,
        shed_per_task=shed_per_task,
        degraded_per_task=degraded_per_task,
        mode_switches=mode_switches,
    )


def simulate_taskset(
    table,
    taskset,
    policy: str,
    horizon: float = 0.0,
    overheads: list[StageOverhead] | None = None,
    mapping_orders: list[list[int]] | None = None,
    arrivals: list[list[float] | None] | None = None,
    chunk_schedules: list[dict[int, tuple[float, ...]]] | None = None,
    preemption: str = "instant",
    shedding: ReleaseShedding | None = None,
    trace: object | None = None,
) -> SimResult:
    """Bridge from `SegmentTable`/`TaskSet` (core.rt) to the simulator.

    ``mapping_orders`` optionally gives, per task, the order in which its
    stages are visited (for non-chained TG baselines); default is
    ascending stage index (the PHAROS pipelined topology).

    ``arrivals`` optionally gives, per task, an explicit release-time
    sequence (see `SimTask.arrivals`); ``None`` entries stay periodic.

    ``chunk_schedules`` (with ``preemption="window"``) gives, per task,
    a stage -> non-preemptible chunk lengths map (e.g.
    `repro_torch.conformance.CostModel.chunk_schedule`); stages without an
    entry run their whole segment as one chunk. Tasks that revisit a
    stage (non-chained mapping orders) cannot carry per-stage chunk
    schedules — the map would be ambiguous per visit.

    ``trace`` optionally forwards a `repro_torch.obs.TraceRecorder` to
    `SimConfig.trace` (None: tracing off, zero events).
    """
    if arrivals is not None and len(arrivals) != len(taskset):
        raise ValueError("arrivals length != taskset size")
    if chunk_schedules is not None and len(chunk_schedules) != len(taskset):
        raise ValueError("chunk_schedules length != taskset size")
    tasks = []
    for i, t in enumerate(taskset.tasks):
        order = (
            mapping_orders[i]
            if mapping_orders is not None
            else table.active_stages(i)
        )
        segs = tuple((k, table.base[i][k]) for k in order if table.base[i][k] > 0)
        arr = arrivals[i] if arrivals is not None else None
        chunks = None
        if chunk_schedules is not None:
            sched = chunk_schedules[i]
            if len({k for k, _w in segs}) != len(segs):
                raise ValueError(
                    "per-stage chunk schedules need chained (no-revisit) "
                    "stage orders"
                )
            chunks = tuple(
                sched.get(k, (w,)) for k, w in segs
            )
        tasks.append(
            SimTask(
                segments=segs,
                period=t.period,
                deadline=t.deadline,
                name=t.name,
                arrivals=tuple(arr) if arr is not None else None,
                chunks=chunks,
            )
        )
    if overheads is None and policy == "edf":
        overheads = [
            StageOverhead(e_tile=o / 3.0, e_store=o / 3.0, e_load=o / 3.0)
            for o in table.overhead
        ]
    cfg = SimConfig(
        policy=policy,
        horizon=horizon,
        overheads=overheads,
        preemption=preemption,
        shedding=shedding,
        trace=trace,
    )
    return simulate(tasks, cfg)
