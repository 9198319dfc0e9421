"""Cross-layer conformance harness: analysis vs DES vs serving runtime.

PHAROS's safety story rests on three layers telling the same story
about one scenario:

1. the **analysis** (`core.rt`): Eq. 3 schedulability + busy-period
   response bounds — sound upper bounds;
2. the **DES** (`scheduler.des`): event-driven simulation on the same
   WCETs — tighter, still model-level;
3. the **runtime** (`pipeline.serve` on a `VirtualClock` driven by a
   `CostModel`): the executing control flow, real GEMM windows, virtual
   time charged per window from the same WCETs.

The harness runs one scenario through all three under one policy and
enforces the soundness ordering

    analytical bound  >=  DES response  >=  runtime response (~)

together with verdict agreement: analysis-schedulable implies
DES-schedulable implies the runtime accumulates no backlog. Every
failure is reported as a `Violation` naming the two layers that
disagree and by how much — this is the differential-oracle methodology
real-time frameworks (Cheddar, MAST) use to validate analyses against
simulation, applied across our stack.

Preemption model and clock semantics: all three layers model the
**same limited-preemption discipline** — preemption only at tile-window
boundaries. The analysis carries it as a per-stage blocking term
(`end_to_end_bounds(blocking=...)`), the DES executes the `CostModel`'s
window chunks with boundary-deferred preemption
(``preemption="window"``), and the runtime realizes it between executed
GEMM windows. Analysis and DES run on their own exact virtual
timebases; the runtime leg runs on a `VirtualClock` advanced
event-to-event by modeled window WCETs (`run_virtual_server`), so every
number compared here is a deterministic model second. The one
wall-clock leg is `run_wallclock_case`, which runs the gateway on a
`WallClock` and compares against a *calibrated* (measured-WCET)
`CostModel` under an explicit noise margin.

Device: every leg that builds a serve bundle, a server or a gateway
takes ``device`` (default ``"cuda"``): the weights, inputs and
accumulators lie there, and on a CUDA device every executed window is
one launch of the hand-written window kernel. There is no fallback:
without a card, pass ``device="cpu"`` (the plain windows).

Modeling notes that make the comparison apples-to-apples:

- All three layers read their WCETs from the same `CostModel`
  (`segment_table()` for analysis/DES, per-window costs for the
  runtime), so a disagreement is a *semantics* bug, never a unit skew.
- The window-boundary deferral inserts **no extra work** (the in-flight
  window completes useful work; accumulators stay resident, so there is
  no spill/reload xi). The layers therefore compare on *raw* WCETs —
  Eq. 3 on raw utilization is the sound verdict for every layer — and
  the window quantum enters the analysis once per stage as the
  limited-preemption **blocking term**, not as Eq. 4 inflation.
  (`CostModel.segment_table`/`des_overheads` still expose the
  conservative inserted-overhead accounting for admission users that
  want Eq. 4 margins.)
- Traffic is **regulated** to the admission contract before the run
  (`regulate_trace`): the analytic layer's premise is a minimum
  inter-arrival of one provisioned period, which raw Poisson/MMPP
  traces violate with probability 1. Unregulated overload is the
  shedding layer's test surface, not conformance's.
- Because the DES defers preemption at the same window boundaries as
  the runtime **and** mirrors its simultaneous-event ordering
  (releases before completions, completions in stage-index order,
  FIFO pools in insertion order — see `scheduler.des`), the DES >=
  runtime comparison needs only a residual-noise tolerance
  (`tol_rel`, plus `quantum_slack` windows absolute — strictly
  tighter than both the `PR2_*` values that absorbed the idealized-DES
  deferral gap and the `PR3_*` value that absorbed fan-in forwarding
  ties, which now agree bit-for-bit).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace

from repro_torch.conformance.costmodel import CostModel
from repro_torch.obs.diff import TraceDiff, trace_diff
from repro_torch.obs.trace import TraceRecorder
from repro_torch.core.rt.response_time import end_to_end_bounds
from repro_torch.core.rt.schedulability import srt_schedulable
from repro_torch.core.rt.task import SegmentTable, TaskSet
from repro_torch.scheduler.des import SimResult, simulate_taskset


#: the registry scenarios whose traffic honours its own contract
#: (overdrive == 1) — the conformance acceptance sweep
DEFAULT_SCENARIOS = (
    "steady_city",
    "rush_hour",
    "sensor_fusion",
    "copilot_decode",
)

POLICIES = ("fifo", "edf")


def regulate_trace(times, min_gap: float) -> list[float]:
    """Clamp a release trace to the admission contract: consecutive
    gaps of at least ``min_gap`` (a leaky-bucket regulator — arrivals
    are delayed, never dropped)."""
    out: list[float] = []
    prev = None
    for t in times:
        t = float(t) if prev is None else max(float(t), prev + min_gap)
        out.append(t)
        prev = t
    return out


#: the DES-vs-runtime tolerance first shipped with an idealized
#: (instant-preemption) DES — kept as the reference point the
#: window-boundary DES must beat (asserted by
#: ``benchmarks/conformance_bench.py`` in CI)
PR2_TOL_REL = 0.02
PR2_QUANTUM_SLACK = 2.0

#: the slack the window-boundary DES needed *before* it adopted the
#: runtime's simultaneous-event tie-breaking (fan-in forwarding ties
#: were worth ~0.36 visit-quanta) — the reference point the aligned
#: DES must beat, asserted in CI alongside the `PR2_*` constants
PR3_QUANTUM_SLACK = 0.75


@dataclass(frozen=True)
class ConformanceConfig:
    #: simulated horizon, in multiples of the longest tenant period
    horizon_periods: float = 40.0
    #: enforce the min-inter-arrival contract on stochastic traces
    regulate: bool = True
    #: DES-vs-runtime schedule-noise tolerance (relative on the DES
    #: max). With the window-boundary DES the systematic deferral gap
    #: is gone, and since the DES adopted the runtime's
    #: simultaneous-event ordering (releases before completions,
    #: completions in stage-index order, FIFO pools in insertion order
    #: — the fan-in forwarding ties that used to cost ~0.36
    #: visit-quanta), the worst residual observed across the registry
    #: is 0.07 visit-quanta (``sensor_fusion``/edf), so both knobs sit
    #: strictly below the `PR3_*` values (0.01 / 0.75), which sat strictly
    #: below the `PR2_*` values before them
    tol_rel: float = 0.01
    #: plus this many worst-case windows of absolute slack
    quantum_slack: float = 0.25
    #: analysis-vs-DES tolerance (bounds are sound: float noise only)
    analysis_tol_rel: float = 1e-9
    #: runtime backlog divergence threshold (mirrors the DES's
    #: `SimConfig.backlog_limit` default)
    backlog_limit: int = 64
    # -- overload (shedding) case (`run_shedding_case`) ---------------
    #: DES-vs-runtime tolerance for the shedding case. Looser than the
    #: contract-honouring knobs above on purpose: under overload the
    #: two layers engage their (identical) shedding machinery against
    #: *their own* backlog observations, so the shed sets differ
    #: slightly and a surviving job may sit behind a job the other
    #: layer shed — noise proportional to the backlog the monitor
    #: tolerates before engaging, not to one tie-break
    shed_tol_rel: float = 0.05
    #: absolute slack of the shedding case, in worst-case windows
    shed_quantum_slack: float = 4.0
    #: surrogate-GEMM dimension cap for the virtual-server leg: timing
    #: comes from the CostModel, so the executed GEMMs only preserve
    #: window/stage structure (keeps LM-tenant chains host-runnable)
    max_dim: int = 512
    seed: int = 0
    #: record DES and runtime schedule traces (`repro_torch.obs`) during
    #: `run_case` and attach a first-divergence `trace_diff` to the
    #: `CaseResult` — a tripped tolerance then names the exact event
    #: where the layers parted ways instead of just the worst job.
    #: Off by default: tracing is opt-in everywhere
    record_traces: bool = False
    # -- wall-clock case (`run_wallclock_case`) -----------------------
    #: horizon of the wall run, in multiples of the longest wall period
    wall_horizon_periods: float = 12.0
    #: timed repetitions per calibration probe
    wall_reps: int = 3
    #: utilization headroom of the wall timebase: periods are scaled so
    #: measured utilization sits at <= 1/headroom of the modeled one
    #: (leaves room for the serving loop's own Python overhead, which
    #: the per-window probes cannot see)
    wall_scale_headroom: float = 4.0
    #: noise margin on measured-vs-predicted wall responses: the host
    #: is not an RTOS — GC, scheduler jitter and JIT cache effects land
    #: on top of the calibrated WCETs, so the wall leg checks
    #: ``measured <= margin * analytic bound`` rather than the model
    #: legs' near-equality
    wall_margin: float = 3.0
    #: calibrated-admission mode (ROADMAP "conformance next steps"):
    #: the wall gateway's tenancy admission runs against the *measured*
    #: WCET contracts (`repro_torch.traffic.admission.calibrated_requests`)
    #: instead of the modeled ones — every tenant must still fit (the
    #: wall timebase carries `wall_scale_headroom` of slack) and the
    #: cached verdict must survive full re-analysis
    calibrated_admission: bool = False


@dataclass(frozen=True)
class TaskConformance:
    """Per-task view of one conformance case."""

    task: str
    analytic_bound: float
    des_max: float
    des_jobs: int
    server_max: float
    server_jobs: int
    in_flight: int


@dataclass(frozen=True)
class Violation:
    """Two adjacent layers disagree; ``lhs`` should not exceed ``rhs``."""

    scenario: str
    policy: str
    task: str
    kind: str  # analytic_vs_des | des_vs_server | verdict_*
    lhs: float
    rhs: float
    detail: str

    @property
    def margin(self) -> float:
        return self.lhs - self.rhs

    def __str__(self) -> str:
        return (
            f"[{self.scenario}/{self.policy}] {self.kind} ({self.task}): "
            f"{self.lhs:.6g} > {self.rhs:.6g} — {self.detail}"
        )


@dataclass(frozen=True)
class CaseResult:
    scenario: str
    policy: str
    analysis_schedulable: bool
    des_schedulable: bool
    server_bounded: bool
    tasks: tuple[TaskConformance, ...]
    violations: tuple[Violation, ...]
    #: DES-vs-runtime first-divergence diagnosis, aligned under the
    #: case's own per-task conformance allowance (None unless
    #: `ConformanceConfig.record_traces`)
    trace_diff: TraceDiff | None = None
    #: host wall-clock seconds this case took (all three layers) —
    #: trend-tracked by ``benchmarks/conformance_bench.py``
    wall_seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations


@dataclass(frozen=True)
class ConformanceReport:
    """Sweep result: scenarios x policies, one `CaseResult` each."""

    cases: tuple[CaseResult, ...]

    @property
    def violations(self) -> tuple[Violation, ...]:
        return tuple(v for c in self.cases for v in c.violations)

    @property
    def ok(self) -> bool:
        return not self.violations

    def case(self, scenario: str, policy: str) -> CaseResult:
        for c in self.cases:
            if c.scenario == scenario and c.policy == policy:
                return c
        raise KeyError((scenario, policy))

    def summary(self) -> str:
        lines = [
            f"{'scenario':14s} {'policy':6s} {'A-sched':7s} "
            f"{'DES-sched':9s} {'srv-ok':6s} {'worst des/bound':15s} "
            f"{'worst srv/des':13s} viol"
        ]
        for c in self.cases:
            r_ad = max(
                (
                    t.des_max / t.analytic_bound
                    for t in c.tasks
                    if math.isfinite(t.analytic_bound)
                    and t.analytic_bound > 0
                ),
                default=float("nan"),
            )
            r_sd = max(
                (
                    t.server_max / t.des_max
                    for t in c.tasks
                    if t.des_max > 0 and t.server_jobs
                ),
                default=float("nan"),
            )
            lines.append(
                f"{c.scenario:14s} {c.policy:6s} "
                f"{str(c.analysis_schedulable):7s} "
                f"{str(c.des_schedulable):9s} "
                f"{str(c.server_bounded):6s} "
                f"{r_ad:15.4f} {r_sd:13.4f} {len(c.violations)}"
            )
        for v in self.violations:
            lines.append(f"  VIOLATION {v}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the virtual-server leg
# ---------------------------------------------------------------------------
def run_virtual_server(
    serve_tasks,
    n_stages: int,
    policy: str,
    cost_model: CostModel,
    traces,
    horizon: float,
    *,
    trace=None,
    device="cuda",
):
    """Drive a cost-model `PharosServer` with explicit release traces on
    a `VirtualClock`, event-to-event (no quantization, no shedding — the
    conformance leg must see the raw runtime). ``trace`` (a
    `repro_torch.obs.TraceRecorder`) captures the runtime's schedule events."""
    from repro_torch.pipeline.serve import PharosServer
    from repro_torch.traffic.clock import VirtualClock

    clk = VirtualClock()
    srv = PharosServer(
        serve_tasks,
        n_stages,
        policy=policy,
        cost_model=cost_model,
        clock=clk.now,
        sleep=clk.sleep,
        trace=trace,
        device=device,
    )
    sched = sorted(
        (t, i) for i, trace in enumerate(traces) for t in trace
    )
    pos = 0
    while True:
        now = clk.now()
        while pos < len(sched) and sched[pos][0] <= now:
            srv.submit(sched[pos][1], sched[pos][0])
            pos += 1
        if now >= horizon:
            break
        srv.step()
        nxt = srv.next_completion_time()
        if pos < len(sched):
            nxt = min(nxt, sched[pos][0])
        nxt = min(nxt, horizon)
        now2 = clk.now()
        if nxt > now2:
            clk.advance(nxt - now2)
    return srv.finalize_report(horizon)


# ---------------------------------------------------------------------------
# one case: scenario x policy through all three layers
# ---------------------------------------------------------------------------
def run_case(
    built,
    policy: str,
    *,
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> CaseResult:
    """Run one `BuiltScenario` through analysis, DES and the virtual
    runtime under ``policy`` and compare."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    cfg = cfg or ConformanceConfig()
    # rtlint: disable=clock-domain -- harness self-timing: wall_seconds
    # reports how long the conformance run itself took, not model time
    t_start = time.perf_counter()
    scenario = built.scenario.name
    taskset = built.taskset
    preemptive = policy == "edf"

    serve_tasks, _requests, _arrivals = built.serve_bundle(
        period_scale=1.0, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    cm = CostModel.from_exec_model(
        built.design, list(built.workloads), serve_tasks
    )
    # zero-overhead WCET view: window-boundary deferral inserts no work
    # (see module docstring), so analysis and DES run on raw WCETs and
    # the quantum enters the analysis as the blocking term instead of
    # as Eq. 4 inflation
    table = SegmentTable(
        base=cm.segment_table().base,
        overhead=[0.0] * cm.n_stages,
    )
    periods = [t.period for t in taskset.tasks]
    horizon = cfg.horizon_periods * max(periods)

    traces = built.des_arrivals(horizon)
    if cfg.regulate:
        traces = [
            [t for t in regulate_trace(tr, p) if t < horizon]
            for tr, p in zip(traces, periods)
        ]

    # per-stage blocking term: the longest non-preemptible window a
    # boundary-deferred preemptor can wait behind
    quanta = cm.stage_window_quantum()

    # layer 1: analysis (blocking-aware under EDF: limited preemption
    # adds at most one in-flight window per stage visit)
    sched_a = srt_schedulable(table, taskset, preemptive)
    bounds = end_to_end_bounds(table, taskset, policy, blocking=quanta)

    # layer 2: DES on the same WCETs with the runtime's own
    # limited-preemption semantics — jobs execute the CostModel's
    # window chunks and preemption defers to chunk boundaries, so the
    # DES-vs-runtime gap is tie-breaking noise, not a quantum
    des_tr = TraceRecorder() if cfg.record_traces else None
    srv_tr = TraceRecorder() if cfg.record_traces else None
    des: SimResult = simulate_taskset(
        table,
        taskset,
        policy,
        horizon=horizon,
        overheads=None,
        arrivals=traces,
        chunk_schedules=cm.chunk_schedule(),
        preemption="window",
        trace=des_tr,
    )

    # layer 3: the executing runtime in model-driven virtual time
    srv = run_virtual_server(
        serve_tasks, built.design.n_stages, policy, cm, traces, horizon,
        trace=srv_tr, device=device,
    )

    # ---- compare ----
    # per-task schedule-noise allowance: the DES now defers preemption
    # at the same window boundaries as the runtime, so the residual gap
    # is simultaneous-event tie-breaking (fractions of a window), not
    # the systematic one-window-per-stage deferral `PR2_*` tolerated
    visit_quanta = [
        sum(q for q, b in zip(quanta, row) if b > 0.0)
        for row in table.base
    ]
    violations: list[Violation] = []
    task_rows: list[TaskConformance] = []
    allow_by_task: dict[str, float] = {}
    for i, t in enumerate(taskset.tasks):
        r_des = des.response_times[i]
        r_srv = srv.response_times.get(t.name, [])
        des_max = max(r_des) if r_des else 0.0
        bound = bounds[i]
        if r_des and math.isfinite(bound):
            lhs = des_max
            if lhs > bound * (1.0 + cfg.analysis_tol_rel) + 1e-12:
                violations.append(
                    Violation(
                        scenario, policy, t.name, "analytic_vs_des",
                        lhs, bound,
                        "DES response exceeds the analytical bound",
                    )
                )
        # Same-task jobs complete in release order in both layers, so
        # index j names the *same job* on each side — compare job-wise.
        # A job only one side completed carries no ordering claim: the
        # other side not finishing it by the horizon means it was the
        # slower one on exactly that job (the runtime-slower direction
        # is still caught through in_flight/backlog below).
        allow = des_max * cfg.tol_rel + cfg.quantum_slack * visit_quanta[i]
        allow_by_task[t.name] = allow
        worst = None  # (excess, job index)
        for j, (rd, rs) in enumerate(zip(r_des, r_srv)):
            if rs > rd + allow and (worst is None or rs - rd > worst[0]):
                worst = (rs - rd, j)
        if worst is not None:
            j = worst[1]
            violations.append(
                Violation(
                    scenario, policy, t.name, "des_vs_server",
                    r_srv[j], r_des[j],
                    f"runtime response of job {j} exceeds the DES "
                    "beyond the window-quantization tolerance",
                )
            )
        task_rows.append(
            TaskConformance(
                task=t.name,
                analytic_bound=bound,
                des_max=des_max,
                des_jobs=len(r_des),
                server_max=max(r_srv) if r_srv else 0.0,
                server_jobs=len(r_srv),
                in_flight=srv.in_flight.get(t.name, 0),
            )
        )

    server_bounded = srv.jobs_completed > 0 and all(
        row.in_flight <= cfg.backlog_limit for row in task_rows
    )
    if sched_a and not des.schedulable:
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_analysis_des",
                1.0, 0.0,
                "analysis says schedulable but the DES detected "
                f"divergence (overload={des.overload_detected}, "
                f"growth={des.growth_detected})",
            )
        )
    if des.schedulable and not server_bounded:
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_des_server",
                float(max((r.in_flight for r in task_rows), default=0)),
                float(cfg.backlog_limit),
                "DES says schedulable but the runtime accumulated "
                "backlog",
            )
        )
    # ---- trace-level differential diagnosis ----
    # Align the two event streams under the same per-task allowance the
    # job-wise compare used: a tripped des_vs_server tolerance then
    # carries the *first* event where the layers parted ways, turning a
    # failed number into a pinpointed schedule divergence.
    diff = None
    if cfg.record_traces:
        diff = trace_diff(
            des_tr, srv_tr, time_tol=allow_by_task,
            names=("des", "runtime"),
        )
        if diff.divergence is not None:
            violations = [
                replace(v, detail=f"{v.detail}; first divergence: "
                        f"{diff.divergence}")
                if v.kind == "des_vs_server" else v
                for v in violations
            ]
    return CaseResult(
        scenario=scenario,
        policy=policy,
        analysis_schedulable=sched_a,
        des_schedulable=des.schedulable,
        server_bounded=server_bounded,
        tasks=tuple(task_rows),
        violations=tuple(violations),
        trace_diff=diff,
        # rtlint: disable=clock-domain -- harness self-timing (see t_start)
        wall_seconds=time.perf_counter() - t_start,
    )


# ---------------------------------------------------------------------------
# the sharded case: K pipeline shards, each held to the full contract
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardedCaseResult:
    """One scenario placed across K pipeline shards, every shard run
    through the full three-layer `run_case` plus a bit-exactness check
    of its per-shard O(stages) admission verdict."""

    scenario: str
    policy: str
    n_shards: int
    placement: str
    assignment: tuple[int, ...]
    cases: tuple[CaseResult, ...]  # one per non-empty shard
    admission_violations: tuple[Violation, ...]

    @property
    def violations(self) -> tuple[Violation, ...]:
        return self.admission_violations + tuple(
            v for c in self.cases for v in c.violations
        )

    @property
    def ok(self) -> bool:
        return not self.violations


def run_sharded_case(
    built,
    policy: str,
    *,
    shards: int,
    placement="least_loaded",
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> ShardedCaseResult:
    """Place ``built``'s tenants across ``shards`` replicas of its
    pipeline and hold **every shard** to the whole conformance
    contract: each shard's tenant subset runs through analysis, DES and
    virtual runtime (`run_case` on `BuiltScenario.subset` — same
    design, same traffic, restricted tenant set), and each shard's
    incremental Eq. 3 admission verdict is checked bit-exact against a
    full `srt_schedulable` re-analysis of the subset
    (``verdict_shard_admission`` on disagreement). With ``shards == 1``
    this degenerates to exactly `run_case` plus the admission check —
    the K=1 equivalence the tests pin."""
    from repro_torch.traffic.admission import AdmissionController
    from repro_torch.traffic.shard import plan_shards

    cfg = cfg or ConformanceConfig()
    preemptive = policy == "edf"
    # the same plan-construction path ShardedGateway.from_built uses,
    # so the contract checked here is the plan the gateway runs
    placement, plan = plan_shards(
        built.requests,
        shards,
        placement,
        n_stages=built.design.n_stages,
        preemptive=preemptive,
    )
    cases: list[CaseResult] = []
    adm_violations: list[Violation] = []
    for k, members in enumerate(plan.members):
        if not members:
            continue
        sub = built.subset(
            members, name=f"{built.scenario.name}#s{k}of{shards}"
        )
        cases.append(run_case(sub, policy, cfg=cfg, device=device))
        ctl = AdmissionController(
            [0.0] * built.design.n_stages, preemptive=preemptive
        )
        for r in sub.requests:
            ctl.admit(r)
        if not ctl.verify():
            adm_violations.append(
                Violation(
                    sub.scenario.name, policy, "*",
                    "verdict_shard_admission",
                    1.0, 0.0,
                    f"shard {k}'s cached Eq. 3 verdict disagrees with "
                    "the full re-analysis of its tenant subset",
                )
            )
    return ShardedCaseResult(
        scenario=built.scenario.name,
        policy=policy,
        n_shards=shards,
        placement=placement.name,
        assignment=plan.assignment,
        cases=tuple(cases),
        admission_violations=tuple(adm_violations),
    )


# ---------------------------------------------------------------------------
# the DSE case: every claimed-feasible design held to the serving stack
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DSECaseResult:
    """`run_dse_case` result: the DSE's feasibility claims checked
    against analysis, DES, runtime **and** a provisioned
    `ShardedGateway` serving the scenario's traffic."""

    scenario: str
    policy: str
    method: str
    #: feasible designs the search claimed in total
    n_claimed: int
    #: max_util of each design actually pushed through the three layers
    checked_utils: tuple[float, ...]
    n_shards: int
    placement: str
    assignment: tuple[int, ...]
    admitted: int
    released: int
    #: one full three-layer `run_case` per checked design
    cases: tuple[CaseResult, ...]
    dse_violations: tuple[Violation, ...]

    @property
    def violations(self) -> tuple[Violation, ...]:
        return self.dse_violations + tuple(
            v for c in self.cases for v in c.violations
        )

    @property
    def ok(self) -> bool:
        return not self.violations


def run_dse_case(
    scenario,
    policy: str = "edf",
    *,
    platform=None,
    shards: int = 2,
    placement="least_loaded",
    check_top: int = 2,
    max_m: int = 3,
    beam_width: int = 4,
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> DSECaseResult:
    """Differentially verify the DSE's feasibility claims end to end.

    The PHAROS pitch is that the SRT-guided DSE finds *feasible*
    designs — so every design it claims feasible must actually be
    feasible in the deployed stack, not just under Eq. 3 on the design
    table. This case:

    1. runs `explore` on the scenario's provisioning problem and takes
       the best ``check_top`` claimed-feasible designs;
    2. materializes each one (`traffic.scenarios.materialize`) and runs
       the full three-layer `run_case` on it — the analysis leg must
       agree the design is schedulable (``verdict_dse_claim``), and the
       usual bound/ordering checks must hold;
    3. provisions the best design into a `ShardedGateway`
       (`repro_torch.core.dse.provision`) and serves the scenario's traffic:
       every tenant must be admitted on its shard
       (``verdict_dse_admission``), each shard's cached Eq. 3 verdict
       must survive full re-analysis (``verdict_dse_verify``), every
       shard must complete work inside the horizon (``dse_no_jobs``),
       and no shard may accumulate backlog (``verdict_dse_backlog``).
    """
    from repro_torch.core.dse.explore import explore
    from repro_torch.core.dse.provision import provision
    from repro_torch.core.perfmodel.hardware import paper_platform
    from repro_torch.traffic.scenarios import (
        get_scenario,
        materialize,
        resolve_problem,
    )

    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    cfg = cfg or ConformanceConfig()
    platform = platform or paper_platform(16)
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    workloads, taskset = resolve_problem(scenario, platform)
    res = explore(
        workloads,
        taskset,
        platform,
        method="beam",
        max_m=max_m,
        beam_width=beam_width,
    )
    if res.best is None:
        raise ValueError(
            f"scenario {scenario.name!r} has no feasible design to check"
        )
    claimed = [res.best] + [
        dp for dp in res.succ_pts if dp is not res.best
    ]
    claimed = claimed[: max(1, check_top)]

    violations: list[Violation] = []
    cases: list[CaseResult] = []
    for rank, dp in enumerate(claimed):
        built = materialize(
            scenario, workloads, taskset, dp, seed=cfg.seed
        )
        case = run_case(built, policy, cfg=cfg, device=device)
        cases.append(case)
        if not case.analysis_schedulable:
            violations.append(
                Violation(
                    scenario.name, policy, "*", "verdict_dse_claim",
                    dp.max_util, 1.0,
                    f"DSE claimed design #{rank} feasible "
                    f"(max_util={dp.max_util:.4f}) but the serve-path "
                    "analysis disagrees",
                )
            )

    # -- the provisioned gateway: DSE design -> shard plan -> traffic --
    plan = provision(
        scenario,
        platform,
        design=res.best,
        shards=shards,
        placement=placement,
        policy=policy,
        seed=cfg.seed,
    )
    gw = plan.sharded_gateway(max_dim=cfg.max_dim, device=device)
    decisions = gw.open()
    admitted = sum(1 for d in decisions if d.admitted)
    for d in decisions:
        if not d.admitted:
            violations.append(
                Violation(
                    scenario.name, policy, d.request.name,
                    "verdict_dse_admission",
                    d.max_util, 1.0,
                    "DSE-provisioned tenant rejected by its shard's "
                    f"Eq. 3 admission: {d.reason}",
                )
            )
    if not gw.verify():
        violations.append(
            Violation(
                scenario.name, policy, "*", "verdict_dse_verify",
                1.0, 0.0,
                "a shard's cached Eq. 3 verdict disagrees with the "
                "full re-analysis of its provisioned contract",
            )
        )
    horizon = cfg.horizon_periods * max(t.period for t in taskset.tasks)
    report = gw.run(horizon)
    released = report.total_released()
    for rep in report.reports:
        if rep is None:
            continue
        sr = rep.server_report
        worst = max(sr.in_flight.values(), default=0)
        if sr.jobs_completed == 0:
            violations.append(
                Violation(
                    scenario.name, policy, "*", "dse_no_jobs",
                    0.0, 1.0,
                    "a DSE-provisioned shard completed no jobs inside "
                    "the horizon",
                )
            )
        elif worst > cfg.backlog_limit:
            violations.append(
                Violation(
                    scenario.name, policy, "*", "verdict_dse_backlog",
                    float(worst), float(cfg.backlog_limit),
                    "a DSE-provisioned shard accumulated backlog the "
                    "claimed-feasible analysis says cannot happen",
                )
            )
    return DSECaseResult(
        scenario=scenario.name,
        policy=policy,
        method=res.method,
        n_claimed=len(res.succ_pts),
        checked_utils=tuple(dp.max_util for dp in claimed),
        n_shards=plan.n_shards,
        placement=plan.placement,
        assignment=plan.plan.assignment,
        admitted=admitted,
        released=released,
        cases=tuple(cases),
        dse_violations=tuple(violations),
    )


# ---------------------------------------------------------------------------
# the shedding case: overdriven traffic, shedding armed in DES & runtime
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SheddingTaskRow:
    """Per-task view of one overload-conformance case."""

    task: str
    des_completed: int
    des_shed: int
    server_completed: int
    server_shed: int
    matched_jobs: int
    des_max: float
    server_max: float
    in_flight: int


@dataclass(frozen=True)
class SheddingCaseResult:
    """DES-with-shedding vs runtime-with-shedding on overdriven traffic
    (`run_shedding_case`)."""

    scenario: str
    policy: str
    shed_policy: str
    analysis_schedulable: bool
    des_overloaded: bool
    server_bounded: bool
    tasks: tuple[SheddingTaskRow, ...]
    violations: tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def total_shed(self) -> tuple[int, int]:
        """(DES, runtime) shed totals."""
        return (
            sum(t.des_shed for t in self.tasks),
            sum(t.server_shed for t in self.tasks),
        )


def run_shedding_case(
    built,
    policy: str = "edf",
    *,
    shed_policy: str = "reject_newest",
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> SheddingCaseResult:
    """Overload conformance: drive **unregulated** (overdriven) traffic
    through the DES and the virtual runtime with the *same* shedding
    machinery armed in both — identical policy, identical analysis-
    derived engage limits (`des_release_shedding` mirrors what
    `TrafficGateway.open` computes) — and check that the layers still
    agree:

    - the analysis's restored promise: the provisioned set is Eq. 3
      schedulable, so shedding must keep the DES backlog bounded
      (``verdict_shed_des``) and the runtime backlog bounded whenever
      the DES's is (``verdict_shed_server``) — the verdict chain
      under overload;
    - job-wise ordering on the *surviving* traffic: jobs are matched
      across layers by their release time (the shed sets may differ —
      each layer sheds against its own backlog observations), and every
      matched job's runtime response must not exceed its DES response
      beyond the shedding tolerance (``shed_des_vs_server``,
      `ConformanceConfig.shed_tol_rel` / ``shed_quantum_slack``).
    """
    from repro_torch.pipeline.serve import PharosServer
    from repro_torch.traffic.admission import AdmissionController
    from repro_torch.traffic.arrival import TraceArrivals
    from repro_torch.traffic.clock import VirtualClock
    from repro_torch.traffic.gateway import TrafficGateway
    from repro_torch.traffic.shedding import (
        BacklogMonitor,
        des_release_shedding,
        get_policy,
    )

    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    cfg = cfg or ConformanceConfig()
    scenario = built.scenario.name
    taskset = built.taskset
    preemptive = policy == "edf"
    policy_obj = get_policy(shed_policy)

    serve_tasks, _requests, _arrivals = built.serve_bundle(
        period_scale=1.0, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    cm = CostModel.from_exec_model(
        built.design, list(built.workloads), serve_tasks
    )
    table = SegmentTable(
        base=cm.segment_table().base,
        overhead=[0.0] * cm.n_stages,
    )
    periods = [t.period for t in taskset.tasks]
    horizon = cfg.horizon_periods * max(periods)
    # deliberately NOT regulated: overdriven traffic contradicting the
    # analysis is this case's whole premise
    traces = built.des_arrivals(horizon)
    quanta = cm.stage_window_quantum()

    sched_a = srt_schedulable(table, taskset, preemptive)

    # one seed controller defines the shedding limits both layers use
    seed_ctl = AdmissionController(
        [0.0] * built.design.n_stages, preemptive=preemptive
    )
    for r in built.requests:
        seed_ctl.admit(r)

    des: SimResult = simulate_taskset(
        table,
        taskset,
        policy,
        horizon=horizon,
        overheads=None,
        arrivals=traces,
        chunk_schedules=cm.chunk_schedule(),
        preemption="window",
        shedding=des_release_shedding(
            policy_obj, seed_ctl, built.requests, monitor=BacklogMonitor()
        ),
    )

    clk = VirtualClock()
    srv = PharosServer(
        serve_tasks,
        built.design.n_stages,
        policy=policy,
        cost_model=cm,
        clock=clk.now,
        sleep=clk.sleep,
        device=device,
    )
    gateway = TrafficGateway(
        srv,
        AdmissionController(
            [0.0] * built.design.n_stages, preemptive=preemptive
        ),
        list(built.requests),
        [TraceArrivals(times=tuple(tr)) for tr in traces],
        shedding=policy_obj,
        monitor=BacklogMonitor(),
        clock=clk,
    )
    report = gateway.run(horizon, warmup=True)
    sr = report.server_report

    visit_quanta = [
        sum(q for q, b in zip(quanta, row) if b > 0.0)
        for row in table.base
    ]
    violations: list[Violation] = []
    rows: list[SheddingTaskRow] = []
    for i, t in enumerate(taskset.tasks):
        r_des = des.response_times[i]
        # match "the same job" across layers by release time: both
        # sides release the identical trace floats, so equality is
        # exact. Completions are re-sorted by release first — a
        # demoted (best-effort) job may legitimately be overtaken by a
        # later guaranteed job of its own task, so completion order is
        # not release order under degrade policies.
        des_pairs = sorted(zip(des.completed_releases[i], r_des))
        srv_pairs = sorted(
            zip(
                sr.completed_releases.get(t.name, []),
                sr.response_times.get(t.name, []),
            )
        )
        r_srv = sr.response_times.get(t.name, [])
        des_max = max(r_des) if r_des else 0.0
        allow = (
            des_max * cfg.shed_tol_rel
            + cfg.shed_quantum_slack * visit_quanta[i]
        )
        matched = 0
        worst = None  # (excess, release, rs, rd)
        di = 0
        for rel, rs in srv_pairs:
            while di < len(des_pairs) and des_pairs[di][0] < rel:
                di += 1
            if di >= len(des_pairs) or des_pairs[di][0] != rel:
                continue  # the DES shed (or never finished) this one
            rd = des_pairs[di][1]
            di += 1
            matched += 1
            if rs > rd + allow and (worst is None or rs - rd > worst[0]):
                worst = (rs - rd, rel, rs, rd)
        if worst is not None:
            violations.append(
                Violation(
                    scenario, policy, t.name, "shed_des_vs_server",
                    worst[2], worst[3],
                    f"surviving job released at {worst[1]:.6g} responds "
                    "later in the runtime than in the DES beyond the "
                    "shedding tolerance",
                )
            )
        if matched == 0 and r_des and r_srv:
            # the join is by exact release-float equality; both layers
            # completing jobs with zero overlap means the stamps have
            # drifted (e.g. a non-zero clock origin) and the per-job
            # check above is comparing nothing — fail loudly instead
            # of green-lighting a vacuous case
            violations.append(
                Violation(
                    scenario, policy, t.name, "shed_no_matched_jobs",
                    float(len(r_srv)), 0.0,
                    "both layers completed jobs but none matched by "
                    "release time — the DES and runtime release stamps "
                    "have diverged and the survivor comparison is "
                    "vacuous",
                )
            )
        rows.append(
            SheddingTaskRow(
                task=t.name,
                des_completed=len(r_des),
                des_shed=des.shed_per_task[i],
                server_completed=len(r_srv),
                server_shed=report.tenant(t.name).shed,
                matched_jobs=matched,
                des_max=des_max,
                server_max=max(r_srv) if r_srv else 0.0,
                in_flight=sr.in_flight.get(t.name, 0),
            )
        )

    # only a *dropping* policy can restore the analysis's boundedness
    # promise under sustained overdrive — demote-only policies keep all
    # the work, so both layers legitimately diverge (together); the
    # matched-job and server-verdict checks above/below still hold them
    # to each other
    if (
        sched_a
        and getattr(policy_obj, "drops", True)
        and des.overload_detected
    ):
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_shed_des",
                1.0, 0.0,
                "provisioned set is Eq. 3 schedulable but the DES "
                "backlog diverged despite release-time (drop) shedding",
            )
        )
    server_bounded = sr.jobs_completed > 0 and all(
        r.in_flight <= cfg.backlog_limit for r in rows
    )
    if not des.overload_detected and not server_bounded:
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_shed_server",
                float(max((r.in_flight for r in rows), default=0)),
                float(cfg.backlog_limit),
                "DES-with-shedding stayed bounded but the runtime "
                "accumulated backlog",
            )
        )
    return SheddingCaseResult(
        scenario=scenario,
        policy=policy,
        shed_policy=shed_policy,
        analysis_schedulable=sched_a,
        des_overloaded=des.overload_detected,
        server_bounded=server_bounded,
        tasks=tuple(rows),
        violations=tuple(violations),
    )


# ---------------------------------------------------------------------------
# the migration case: live tenant re-homing under the co-simulation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MigrationTenantRow:
    """Per-tenant view of one migration conformance case. Survivor
    counts are completed jobs inside the compared window (releases at
    least one analytic response bound before the horizon — the tail a
    layer may legitimately leave in flight is excluded)."""

    tenant: str
    migrated: bool
    donor: int
    target: int | None
    committed: bool
    aborted: bool
    held: int
    runtime_survivors: int
    des_survivors: int
    runtime_misses: int
    des_misses: int


@dataclass(frozen=True)
class MigrationCaseResult:
    """`run_migration_case` result: live migrations executed on the
    shared-clock co-simulated elastic gateway, replayed shard-by-shard
    through the DES on the *realized* release stamps, and held to:
    zero deadline violations in either layer during any handover,
    exact DES/runtime survivor-set agreement for every tenant, a
    committed Eq. 3 proof behind every re-home, and bit-exact per-shard
    admission verdicts after all the churn."""

    scenario: str
    policy: str
    n_shards: int
    commits: int
    aborts: int
    final_assignment: tuple[tuple[str, int], ...]
    tenants: tuple[MigrationTenantRow, ...]
    violations: tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations


def run_migration_case(
    built,
    policy: str = "edf",
    *,
    shards: int = 2,
    placement="least_loaded",
    plans=None,
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> MigrationCaseResult:
    """Live-migration conformance: run ``built`` on an **elastic**
    `ShardedGateway` (shared-clock co-simulation) with a
    `MigrationController` executing ``plans`` (default: re-home the
    first tenant slack-aware at 30% of the horizon), then replay each
    shard through the DES using the runtime's own realized release
    stamps as explicit arrival traces — the cross-layer join is the
    release float, exactly as in `run_shedding_case`.

    Checks, each a named `Violation` on failure:

    - ``migration_no_commit``   — vacuity: at least one plan committed.
    - ``migration_drain_stuck`` — every started drain finished inside
      the horizon.
    - ``migration_uncommitted_member`` — every committed tenant is an
      admitted member of its target shard (proof-before-commit held).
    - ``migration_survivor_mismatch`` — per tenant and shard, the DES
      and the runtime completed exactly the same job set (release
      stamps) outside the horizon tail.
    - ``migration_deadline_miss_runtime`` / ``..._des`` — zero
      deadline violations in either layer, handovers included.
    - ``migration_no_post_commit_service`` — each migrated tenant
      completed at least one job on its target shard (the post-commit
      Eq. 3 contract was actually exercised).
    - ``verdict_shard_admission`` — after all churn, every shard's
      cached Eq. 3 verdict survives full re-analysis.
    """
    from repro_torch.traffic.migration import MigrationController, MigrationPlan
    from repro_torch.traffic.shard import ShardedGateway

    cfg = cfg or ConformanceConfig()
    scenario = built.scenario.name
    periods = [t.period for t in built.taskset.tasks]
    horizon = cfg.horizon_periods * max(periods)
    names = [r.name for r in built.requests]
    n = len(names)

    rec = TraceRecorder()
    gw = ShardedGateway.from_built(
        built,
        shards=shards,
        placement=placement,
        policy=policy,
        seed=cfg.seed,
        max_dim=cfg.max_dim,
        elastic=True,
        trace=rec,
        device=device,
    )
    if plans is None:
        plans = [MigrationPlan(tenant=names[0], at=0.3 * horizon)]
    ctl = MigrationController(plans, trace=rec)
    gw.run(horizon, shared_clock=True, controller=ctl)

    violations: list[Violation] = []
    commits = len(ctl.committed)
    aborts = len(ctl.aborted)
    if commits == 0:
        violations.append(
            Violation(
                scenario, policy, "*", "migration_no_commit",
                0.0, 1.0,
                "no migration committed — the case proves nothing",
            )
        )
    for tenant in ctl.in_progress():
        violations.append(
            Violation(
                scenario, policy, tenant, "migration_drain_stuck",
                1.0, 0.0,
                "drain did not complete inside the horizon",
            )
        )
    for r in ctl.committed:
        target_gw = gw.gateways[r.target]
        if r.tenant not in target_gw.admission.names():
            violations.append(
                Violation(
                    scenario, policy, r.tenant,
                    "migration_uncommitted_member",
                    1.0, 0.0,
                    f"committed to shard {r.target} but not an admitted "
                    "member there",
                )
            )

    # ---- the DES replay: per shard, on the realized release stamps ----
    serve_tasks, _reqs, _arr = built.serve_bundle(
        period_scale=1.0, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    cm = built.conformance_cost_model(serve_tasks)
    table = SegmentTable(
        base=cm.segment_table().base,
        overhead=[0.0] * cm.n_stages,
    )
    idx = {nm: i for i, nm in enumerate(names)}
    realized: list[list[list[float]]] = [
        [[] for _ in range(n)] for _ in range(shards)
    ]
    for e in rec.events:
        if e.layer == "gateway" and e.kind == "release":
            realized[e.shard][idx[e.task]].append(e.release)
    des_runs = [
        simulate_taskset(
            table,
            built.taskset,
            policy,
            horizon=horizon,
            overheads=None,
            arrivals=[sorted(tr) for tr in realized[k]],
            chunk_schedules=cm.chunk_schedule(),
            preemption="window",
        )
        for k in range(shards)
    ]

    # tail: a release may legitimately still be in flight at the
    # horizon; outside one analytic response bound the layers must
    # agree exactly on who survived
    bounds = end_to_end_bounds(
        table, built.taskset, policy, blocking=cm.stage_window_quantum()
    )
    by_record = {r.tenant: r for r in ctl.records}
    rows: list[MigrationTenantRow] = []
    for i, nm in enumerate(names):
        cutoff = horizon - bounds[i]
        deadline = built.taskset.tasks[i].deadline
        rt_surv: set[tuple[int, float]] = set()
        rt_misses = 0
        for k in range(shards):
            sr = gw.gateways[k].server.report
            rt_surv |= {
                (k, rel)
                for rel in sr.completed_releases.get(nm, [])
                if rel <= cutoff
            }
            rt_misses += gw.gateways[k].server.report.deadline_misses.get(
                nm, 0
            )
        des_surv: set[tuple[int, float]] = set()
        des_misses = 0
        for k, des in enumerate(des_runs):
            des_surv |= {
                (k, rel)
                for rel in des.completed_releases[i]
                if rel <= cutoff
            }
            des_misses += sum(
                1
                for rel, resp in zip(
                    des.completed_releases[i], des.response_times[i]
                )
                if rel <= cutoff and resp > deadline + 1e-9
            )
        if rt_surv != des_surv:
            delta = rt_surv.symmetric_difference(des_surv)
            violations.append(
                Violation(
                    scenario, policy, nm, "migration_survivor_mismatch",
                    float(len(delta)), 0.0,
                    f"DES and runtime disagree on {len(delta)} completed "
                    f"jobs (runtime {len(rt_surv)}, DES {len(des_surv)})",
                )
            )
        if rt_misses:
            violations.append(
                Violation(
                    scenario, policy, nm,
                    "migration_deadline_miss_runtime",
                    float(rt_misses), 0.0,
                    "runtime violated a deadline during the migrated run",
                )
            )
        if des_misses:
            violations.append(
                Violation(
                    scenario, policy, nm, "migration_deadline_miss_des",
                    float(des_misses), 0.0,
                    "DES violated a deadline during the migrated run",
                )
            )
        r = by_record.get(nm)
        if r is not None and r.committed:
            post = [
                (k, rel)
                for (k, rel) in sorted(rt_surv)
                if k == r.target and rel >= (r.committed_at or 0.0)
            ]
            if not post:
                violations.append(
                    Violation(
                        scenario, policy, nm,
                        "migration_no_post_commit_service",
                        0.0, 1.0,
                        "no job completed on the target shard after the "
                        "commit — the re-homed contract was never "
                        "exercised",
                    )
                )
        rows.append(
            MigrationTenantRow(
                tenant=nm,
                migrated=r is not None,
                donor=r.donor if r is not None else -1,
                target=r.target if r is not None else None,
                committed=bool(r is not None and r.committed),
                aborted=bool(r is not None and r.aborted),
                held=r.held if r is not None else 0,
                runtime_survivors=len(rt_surv),
                des_survivors=len(des_surv),
                runtime_misses=rt_misses,
                des_misses=des_misses,
            )
        )

    if not gw.verify():
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_shard_admission",
                1.0, 0.0,
                "a shard's cached Eq. 3 verdict disagrees with the full "
                "re-analysis after migration churn",
            )
        )
    return MigrationCaseResult(
        scenario=scenario,
        policy=policy,
        n_shards=shards,
        commits=commits,
        aborts=aborts,
        final_assignment=tuple(sorted(ctl.final_assignment().items())),
        tenants=tuple(rows),
        violations=tuple(violations),
    )


# ---------------------------------------------------------------------------
# the mode-switch case: mixed-criticality overload transitions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModeSwitchTaskRow:
    """Per-task view of one mode-switch conformance case.

    The ``*_misses`` columns count **per-class guarantee** violations
    in the SRT sense: jobs whose response exceeds the survivor set's
    analytic bound plus the transition allowance (see
    `run_mode_switch_case`). Tenants outside the survivor set carry no
    guarantee in HI mode, so their columns are definitionally zero."""

    task: str
    criticality: str
    des_completed: int
    des_shed: int
    des_degraded: int
    des_misses: int
    server_completed: int
    server_shed: int
    server_degraded: int
    server_misses: int
    matched_jobs: int
    des_max: float
    server_max: float


@dataclass(frozen=True)
class ModeSwitchCaseResult:
    """DES-with-modes vs runtime-with-modes on overdriven
    mixed-criticality traffic (`run_mode_switch_case`)."""

    scenario: str
    policy: str
    action: str
    analysis_schedulable: bool
    #: every committed HI entry carried a schedulable Eq. 3 re-proof of
    #: its survivor set (in both layers)
    hi_proof_schedulable: bool
    #: committed transitions, ``(t, mode, survivors)`` per layer
    des_switches: tuple[tuple[float, str, tuple[str, ...]], ...]
    server_switches: tuple[tuple[float, str, tuple[str, ...]], ...]
    #: the agreed HI-mode guarantee set (first HI entry)
    survivors: tuple[str, ...]
    tasks: tuple[ModeSwitchTaskRow, ...]
    violations: tuple[Violation, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    def hi_miss_totals(self) -> tuple[int, int]:
        """(DES, runtime) deadline-miss totals over the HI class."""
        hi = [t for t in self.tasks if t.criticality == "HI"]
        return (
            sum(t.des_misses for t in hi),
            sum(t.server_misses for t in hi),
        )


def _hi_entries(switches):
    """The HI-entry transitions of one layer's switch log."""
    return [s for s in switches if s[1] == "hi"]


def run_mode_switch_case(
    built,
    policy: str = "edf",
    *,
    action: str = "degrade",
    cfg: ConformanceConfig | None = None,
    device="cuda",
) -> ModeSwitchCaseResult:
    """Mixed-criticality mode-switch conformance: drive **unregulated**
    overdriven traffic through the DES and the virtual runtime with a
    `repro_torch.traffic.modes.ModeController` armed in both — identical
    criticality contracts, identical analysis-derived engage limits —
    and check that the overload mode machinery tells one story:

    - **switches happen**: both layers must commit at least one HI
      entry (``mode_no_switch``) — an overdriven scenario that never
      trips the monitor makes every other check vacuous;
    - **survivor agreement**: every HI entry's survivor set — the Eq. 3
      re-proved HI guarantee set — must be identical in both layers and
      across repeated entries (``mode_survivor_mismatch``). Survivors
      are a pure function of the criticality contracts and the
      admission analysis, never of the traffic, so this holds exactly
      even when the two layers switch at slightly different times;
    - **the proof is real**: every committed HI entry must carry a
      schedulable re-proof (``mode_unschedulable_survivors``);
    - **per-class Eq. 3 guarantee**: zero HI deadline misses in either
      layer over the whole run, transitions included
      (``mode_hi_miss_des`` / ``mode_hi_miss_server``). "Miss" is the
      SRT (bounded-tardiness) sense every other case in this harness
      uses: a HI job misses when its response exceeds the **survivor
      set's own analytic bound** (`end_to_end_bounds` over the HI
      subset, blocking-aware) plus the **transition allowance** — the
      LO backlog the `BacklogMonitor` hysteresis tolerates before the
      switch commits (engage limit x per-job service, summed over the
      LO tenants) — plus the case's overload schedule-noise tolerance.
      The gate applies where the action can actually protect the HI
      class: a *dropping* action under any policy, a *demoting* action
      only under EDF (demotion works by deadline ordering; FIFO keeps
      demoted jobs in their pool positions, so degrade-under-FIFO
      carries no HI guarantee and the rows report misses without
      gating them — the same carve-out `run_shedding_case` makes for
      demote-only boundedness);
    - job-wise ordering on matched HI jobs (release-time join, same as
      `run_shedding_case`, under the same overload tolerances
      `ConformanceConfig.shed_tol_rel`/``shed_quantum_slack``):
      ``mode_des_vs_server``, with the ``mode_no_matched_jobs``
      vacuity guard.
    """
    from repro_torch.pipeline.serve import PharosServer
    from repro_torch.traffic.admission import CRITICALITY_HI, AdmissionController
    from repro_torch.traffic.arrival import TraceArrivals
    from repro_torch.traffic.clock import VirtualClock
    from repro_torch.traffic.gateway import TrafficGateway
    from repro_torch.traffic.modes import ModeController

    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    cfg = cfg or ConformanceConfig()
    scenario = built.scenario.name
    taskset = built.taskset
    preemptive = policy == "edf"

    serve_tasks, _requests, _arrivals = built.serve_bundle(
        period_scale=1.0, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    cm = CostModel.from_exec_model(
        built.design, list(built.workloads), serve_tasks
    )
    table = SegmentTable(
        base=cm.segment_table().base,
        overhead=[0.0] * cm.n_stages,
    )
    periods = [t.period for t in taskset.tasks]
    horizon = cfg.horizon_periods * max(periods)
    # unregulated on purpose: the LO overdrive is what trips the mode
    traces = built.des_arrivals(horizon)
    quanta = cm.stage_window_quantum()

    sched_a = srt_schedulable(table, taskset, preemptive)

    # twin mode controllers, one per layer, over that layer's own
    # admission state — identical contracts in, so identical limits
    # and identical survivor proofs out
    des_ctl = AdmissionController(
        [0.0] * built.design.n_stages, preemptive=preemptive
    )
    for r in built.requests:
        des_ctl.admit(r)
    des_modes = ModeController(
        des_ctl, list(built.requests), action=action
    )

    des: SimResult = simulate_taskset(
        table,
        taskset,
        policy,
        horizon=horizon,
        overheads=None,
        arrivals=traces,
        chunk_schedules=cm.chunk_schedule(),
        preemption="window",
        shedding=des_modes,
    )

    clk = VirtualClock()
    srv = PharosServer(
        serve_tasks,
        built.design.n_stages,
        policy=policy,
        cost_model=cm,
        clock=clk.now,
        sleep=clk.sleep,
        device=device,
    )
    gw_ctl = AdmissionController(
        [0.0] * built.design.n_stages, preemptive=preemptive
    )
    gw_modes = ModeController(
        gw_ctl, list(built.requests), action=action
    )
    gateway = TrafficGateway(
        srv,
        gw_ctl,
        list(built.requests),
        [TraceArrivals(times=tuple(tr)) for tr in traces],
        modes=gw_modes,
        clock=clk,
    )
    report = gateway.run(horizon, warmup=True)
    sr = report.server_report

    visit_quanta = [
        sum(q for q, b in zip(quanta, row) if b > 0.0)
        for row in table.base
    ]
    crit = {r.name: r.criticality for r in built.requests}
    violations: list[Violation] = []

    # -- transition agreement ----------------------------------------
    des_hi = _hi_entries(des.mode_switches)
    srv_hi = _hi_entries(report.mode_switches)
    if not des_hi or not srv_hi:
        violations.append(
            Violation(
                scenario, policy, "*", "mode_no_switch",
                float(bool(des_hi)) + float(bool(srv_hi)), 2.0,
                "overdriven scenario never committed a HI entry in "
                f"{'the DES' if not des_hi else 'the runtime'} — the "
                "mode-switch case is vacuous",
            )
        )
    survivor_sets = {s[2] for s in des_hi} | {s[2] for s in srv_hi}
    survivors = des_hi[0][2] if des_hi else (
        srv_hi[0][2] if srv_hi else ()
    )
    if len(survivor_sets) > 1:
        violations.append(
            Violation(
                scenario, policy, "*", "mode_survivor_mismatch",
                float(len(survivor_sets)), 1.0,
                "HI-entry survivor sets disagree across layers or "
                f"entries: {sorted(survivor_sets)}",
            )
        )
    hi_proof = all(
        s.schedulable
        for mc in (des_modes, gw_modes)
        for s in mc.switches
        if s.mode == "hi"
    )
    if not hi_proof:
        violations.append(
            Violation(
                scenario, policy, "*", "mode_unschedulable_survivors",
                0.0, 1.0,
                "a committed HI entry carried a failing Eq. 3 re-proof "
                "— the HI guarantee is vacuous",
            )
        )

    # -- per-class guarantee allowance -------------------------------
    # the survivor subset's own analytic bounds (blocking-aware, same
    # formula as `run_case`) ...
    name_to_idx = {t.name: i for i, t in enumerate(taskset.tasks)}
    surv_idx = [name_to_idx[n] for n in survivors if n in name_to_idx]
    hi_bounds: dict[str, float] = {}
    if surv_idx:
        hi_table = SegmentTable(
            base=[table.base[i] for i in surv_idx],
            overhead=list(table.overhead),
        )
        hi_ts = TaskSet(tasks=tuple(taskset.tasks[i] for i in surv_idx))
        for t2, b in zip(
            hi_ts.tasks,
            end_to_end_bounds(hi_table, hi_ts, policy, blocking=quanta),
        ):
            hi_bounds[t2.name] = b
    # ... plus the transition allowance: the backlog (engage limit x
    # per-job service) the hysteresis tolerates from each non-survivor
    # before the switch commits — work the HI class may still sit
    # behind across the transition
    limits = des_modes.limits()
    carryover = sum(
        limits[i] * sum(table.base[i])
        for i, r in enumerate(built.requests)
        if r.name not in hi_bounds
    )
    # where the action can actually protect the HI class: dropping
    # removes LO work under any policy; demotion works through
    # deadline ordering, so it only bites under EDF (see docstring)
    guarantee_armed = action == "drop" or preemptive

    # -- per-task rows + per-class guarantees ------------------------
    rows: list[ModeSwitchTaskRow] = []
    for i, t in enumerate(taskset.tasks):
        r_des = des.response_times[i]
        r_srv = sr.response_times.get(t.name, [])
        des_pairs = sorted(zip(des.completed_releases[i], r_des))
        srv_pairs = sorted(
            zip(
                sr.completed_releases.get(t.name, []),
                r_srv,
            )
        )
        des_max = max(r_des) if r_des else 0.0
        allow = (
            des_max * cfg.shed_tol_rel
            + cfg.shed_quantum_slack * visit_quanta[i]
        )
        # SRT "miss": response beyond the survivor-set bound plus the
        # transition allowance (non-survivors carry no guarantee)
        miss_allow = hi_bounds.get(t.name, math.inf) + carryover + allow
        des_misses = sum(1 for r in r_des if r > miss_allow)
        srv_misses = sum(1 for r in r_srv if r > miss_allow)
        matched = 0
        worst = None
        di = 0
        for rel, rs in srv_pairs:
            while di < len(des_pairs) and des_pairs[di][0] < rel:
                di += 1
            if di >= len(des_pairs) or des_pairs[di][0] != rel:
                continue
            rd = des_pairs[di][1]
            di += 1
            matched += 1
            if (
                crit[t.name] == CRITICALITY_HI
                and rs > rd + allow
                and (worst is None or rs - rd > worst[0])
            ):
                worst = (rs - rd, rel, rs, rd)
        if worst is not None:
            violations.append(
                Violation(
                    scenario, policy, t.name, "mode_des_vs_server",
                    worst[2], worst[3],
                    f"HI job released at {worst[1]:.6g} responds later "
                    "in the runtime than in the DES beyond the "
                    "overload tolerance",
                )
            )
        if matched == 0 and r_des and r_srv:
            violations.append(
                Violation(
                    scenario, policy, t.name, "mode_no_matched_jobs",
                    float(len(r_srv)), 0.0,
                    "both layers completed jobs but none matched by "
                    "release time — the release stamps have diverged "
                    "and the HI-job comparison is vacuous",
                )
            )
        if t.name in hi_bounds and guarantee_armed:
            if des_misses:
                violations.append(
                    Violation(
                        scenario, policy, t.name, "mode_hi_miss_des",
                        float(des_misses), 0.0,
                        "HI tenant exceeded its survivor-set bound "
                        "plus the transition allowance in the DES — "
                        "the per-class Eq. 3 guarantee is broken at "
                        "the model layer",
                    )
                )
            if srv_misses:
                violations.append(
                    Violation(
                        scenario, policy, t.name, "mode_hi_miss_server",
                        float(srv_misses), 0.0,
                        "HI tenant exceeded its survivor-set bound "
                        "plus the transition allowance in the runtime "
                        "— the per-class Eq. 3 guarantee is broken at "
                        "the serving layer",
                    )
                )
        rows.append(
            ModeSwitchTaskRow(
                task=t.name,
                criticality=crit[t.name],
                des_completed=len(r_des),
                des_shed=des.shed_per_task[i],
                des_degraded=des.degraded_per_task[i],
                des_misses=des_misses,
                server_completed=len(r_srv),
                server_shed=report.tenant(t.name).shed,
                server_degraded=report.tenant(t.name).degraded,
                server_misses=srv_misses,
                matched_jobs=matched,
                des_max=des_max,
                server_max=max(r_srv) if r_srv else 0.0,
            )
        )

    return ModeSwitchCaseResult(
        scenario=scenario,
        policy=policy,
        action=action,
        analysis_schedulable=sched_a,
        hi_proof_schedulable=hi_proof,
        des_switches=tuple(des.mode_switches),
        server_switches=tuple(report.mode_switches),
        survivors=survivors,
        tasks=tuple(rows),
        violations=tuple(violations),
    )


# ---------------------------------------------------------------------------
# the wall-clock case: calibrated CostModel vs the real clock
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class WallClockTask:
    """Per-task view of one wall-clock conformance case (wall seconds)."""

    task: str
    measured_median: float
    measured_max: float
    jobs: int
    predicted_des_max: float
    predicted_bound: float
    in_flight: int


@dataclass(frozen=True)
class WallClockCase:
    """One `run_wallclock_case` result: the gateway on a real clock vs
    the calibrated `CostModel`'s predictions."""

    scenario: str
    policy: str
    #: model-seconds -> wall-seconds conversion applied to periods
    period_scale: float
    margin: float
    horizon_s: float
    tasks: tuple[WallClockTask, ...]
    violations: tuple[Violation, ...]
    #: which WCETs tenancy admission ran against ("model"/"calibrated")
    admission_mode: str = "model"

    @property
    def ok(self) -> bool:
        return not self.violations


def run_wallclock_case(
    built,
    policy: str = "edf",
    *,
    cfg: ConformanceConfig | None = None,
    trace=None,
    device="cuda",
) -> WallClockCase:
    """ROADMAP's calibrated wall-clock conformance case: run the
    `TrafficGateway` on a **real** `WallClock` and check the observed
    response times against the *calibrated* `CostModel`'s predictions.

    Procedure:

    1. calibrate per-(task, layer) window WCETs on this host
       (`CostModel.calibrate` — measured, not modeled);
    2. rescale the scenario's periods onto the wall timebase with
       `wall_scale_headroom` of utilization slack (the probes measure
       pure window execution; the serving loop adds Python overhead the
       model cannot see);
    3. release the contract-regulated traces through the gateway on the
       wall clock, executing real GEMM windows;
    4. compare each task's **median** measured response against the
       blocking-aware analytic bound on the *measured* WCET table,
       under the explicit `wall_margin` (the host is not an RTOS: a GC
       pause or scheduler throttle can blow any single job's response,
       so the per-job max is reported but only the typical-path median
       gates — this leg checks calibrated-model fidelity, not hard
       real-time).

    The DES prediction on the measured chunks is reported alongside for
    reference. Violations use kind ``wall_vs_model`` (median response
    above margin * bound), ``wall_no_jobs`` (a tenant finished nothing
    inside the horizon) and ``verdict_wall_backlog`` (runtime
    accumulated backlog the measured-WCET analysis says cannot happen).

    With ``cfg.calibrated_admission`` the gateway's tenancy admission
    runs against the **measured** WCET contracts
    (`repro_torch.traffic.admission.calibrated_requests` on the calibrated
    `CostModel`) instead of the modeled ones — the ROADMAP's
    calibrated-cost-model admission mode. Two extra violation kinds
    guard it: ``calibrated_admission_reject`` (a tenant the measured
    analysis must fit was rejected) and
    ``verdict_calibrated_admission`` (cached verdict vs full measured
    re-analysis disagree).

    ``trace`` (a `repro_torch.obs.TraceRecorder`) captures the wall run's
    gateway and server schedule events. Callers that retry on host
    throttle should pass one shared recorder across attempts (tagging
    each via `repro_torch.obs.TraceRecorder.annotate`), so a discarded first
    attempt's measurements stay visible instead of being lost.
    """
    from repro_torch.core.rt.task import Task, TaskSet
    from repro_torch.pipeline.serve import PharosServer
    from repro_torch.traffic.admission import AdmissionController
    from repro_torch.traffic.arrival import TraceArrivals
    from repro_torch.traffic.clock import WallClock
    from repro_torch.traffic.gateway import TrafficGateway

    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    cfg = cfg or ConformanceConfig()
    scenario = built.scenario.name

    # 1. calibrate on the same GEMM geometry the wall run will execute
    serve_model, _req, _arr = built.serve_bundle(
        period_scale=1.0, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    probe = PharosServer(
        serve_model, built.design.n_stages, policy=policy, device=device
    )
    measured = CostModel.calibrate(probe, reps=cfg.wall_reps)
    modeled = CostModel.from_exec_model(
        built.design, list(built.workloads), serve_model
    )

    # 2. wall timebase: scale every period by headroom x the worst
    # measured/modeled segment ratio, so measured utilization is at
    # most modeled utilization / headroom on every stage
    ratio = max(
        measured.segment_cost(i, k) / modeled.segment_cost(i, k)
        for i in range(modeled.n_tasks)
        for k in range(modeled.n_stages)
        if modeled.segment_cost(i, k) > 0.0
    )
    scale = cfg.wall_scale_headroom * ratio
    serve_tasks, requests, arrivals = built.serve_bundle(
        period_scale=scale, seed=cfg.seed, max_dim=cfg.max_dim,
        device=device,
    )
    wall_taskset = TaskSet(
        tasks=tuple(
            Task(
                workload=w,
                period=t.period * scale,
                deadline=t.deadline * scale,
                sporadic=t.sporadic,
                name=t.name,
            )
            for w, t in zip(built.workloads, built.taskset.tasks)
        )
    )
    periods = [t.period for t in wall_taskset.tasks]
    horizon = cfg.wall_horizon_periods * max(periods)

    # 3. predictions from the measured model (wall seconds throughout)
    table = SegmentTable(
        base=measured.segment_table().base,
        overhead=[0.0] * measured.n_stages,
    )
    quanta = measured.stage_window_quantum()
    bounds = end_to_end_bounds(table, wall_taskset, policy, blocking=quanta)
    traces = [p.arrivals(horizon) for p in arrivals]
    if cfg.regulate:
        traces = [
            [x for x in regulate_trace(tr, p) if x < horizon]
            for tr, p in zip(traces, periods)
        ]
    des: SimResult = simulate_taskset(
        table,
        wall_taskset,
        policy,
        horizon=horizon,
        overheads=None,
        arrivals=traces,
        chunk_schedules=measured.chunk_schedule(),
        preemption="window",
    )

    # 4. the wall run: same regulated traces, replayed on the real
    # clock. Admission runs on raw WCETs (zero inserted overhead):
    # window-boundary deferral blocks, it does not inflate utilization
    # — the same premise every other conformance leg uses. In
    # calibrated-admission mode the contracts are re-based onto the
    # *measured* WCETs first, so tenancy admission answers against
    # what this host actually does.
    from repro_torch.traffic.admission import calibrated_requests

    if cfg.calibrated_admission:
        gw_requests = list(calibrated_requests(measured, requests))
    else:
        gw_requests = list(requests)
    srv = PharosServer(
        serve_tasks, built.design.n_stages, policy=policy, trace=trace,
        device=device,
    )
    admission = AdmissionController(
        [0.0] * built.design.n_stages,
        preemptive=(policy == "edf"),
    )
    gateway = TrafficGateway(
        srv,
        admission,
        gw_requests,
        [TraceArrivals(times=tuple(tr)) for tr in traces],
        clock=WallClock(),
        trace=trace,
    )
    report = gateway.run(horizon, warmup=True)
    sr = report.server_report

    violations: list[Violation] = []
    if cfg.calibrated_admission:
        # the measured analysis at `wall_scale_headroom` slack must
        # admit every tenant, and the cached verdict must agree with a
        # full re-analysis of the measured contracts
        for d in report.decisions:
            if not d.admitted:
                violations.append(
                    Violation(
                        scenario, policy, d.request.name,
                        "calibrated_admission_reject",
                        d.max_util, 1.0,
                        "measured-WCET contract rejected despite the "
                        f"{cfg.wall_scale_headroom:g}x provisioning "
                        f"headroom: {d.reason}",
                    )
                )
        if not admission.verify():
            violations.append(
                Violation(
                    scenario, policy, "*",
                    "verdict_calibrated_admission",
                    1.0, 0.0,
                    "calibrated admission's cached Eq. 3 verdict "
                    "disagrees with the full measured re-analysis",
                )
            )
    task_rows: list[WallClockTask] = []
    for i, t in enumerate(wall_taskset.tasks):
        rts = sorted(sr.response_times.get(t.name, []))
        measured_median = rts[len(rts) // 2] if rts else 0.0
        des_r = des.response_times[i]
        row = WallClockTask(
            task=t.name,
            measured_median=measured_median,
            measured_max=rts[-1] if rts else 0.0,
            jobs=len(rts),
            predicted_des_max=max(des_r) if des_r else 0.0,
            predicted_bound=bounds[i],
            in_flight=sr.in_flight.get(t.name, 0),
        )
        task_rows.append(row)
        if not rts:
            violations.append(
                Violation(
                    scenario, policy, t.name, "wall_no_jobs",
                    0.0, 1.0,
                    "tenant completed no jobs inside the wall horizon",
                )
            )
        elif (
            math.isfinite(bounds[i])
            and measured_median > cfg.wall_margin * bounds[i]
        ):
            violations.append(
                Violation(
                    scenario, policy, t.name, "wall_vs_model",
                    measured_median, cfg.wall_margin * bounds[i],
                    "median wall-clock response exceeds the calibrated "
                    f"analytic bound x{cfg.wall_margin:g} margin",
                )
            )
    worst_backlog = max((r.in_flight for r in task_rows), default=0)
    if sr.jobs_completed == 0 or worst_backlog > cfg.backlog_limit:
        violations.append(
            Violation(
                scenario, policy, "*", "verdict_wall_backlog",
                float(worst_backlog), float(cfg.backlog_limit),
                "measured-WCET analysis says bounded but the wall run "
                "accumulated backlog",
            )
        )
    return WallClockCase(
        scenario=scenario,
        policy=policy,
        period_scale=scale,
        margin=cfg.wall_margin,
        horizon_s=horizon,
        tasks=tuple(task_rows),
        violations=tuple(violations),
        admission_mode=(
            "calibrated" if cfg.calibrated_admission else "model"
        ),
    )


def run_conformance(
    scenarios=DEFAULT_SCENARIOS,
    policies=POLICIES,
    *,
    platform=None,
    cfg: ConformanceConfig | None = None,
    max_m: int = 3,
    beam_width: int = 4,
    prebuilt: dict | None = None,
    device="cuda",
) -> ConformanceReport:
    """Sweep ``scenarios x policies`` and collect every violation.

    Each scenario is resolved once (`traffic.scenarios.build` runs the
    DSE) and reused across policies; ``prebuilt`` maps scenario names
    to already-resolved `BuiltScenario`s to skip their DSE entirely.
    """
    from repro_torch.core.perfmodel.hardware import paper_platform
    from repro_torch.traffic.scenarios import build, get_scenario

    platform = platform or paper_platform(16)
    cfg = cfg or ConformanceConfig()
    cases = []
    for name in scenarios:
        built = (prebuilt or {}).get(name) or build(
            get_scenario(name),
            platform,
            max_m=max_m,
            beam_width=beam_width,
            seed=cfg.seed,
        )
        for policy in policies:
            cases.append(run_case(built, policy, cfg=cfg, device=device))
    return ConformanceReport(cases=tuple(cases))
