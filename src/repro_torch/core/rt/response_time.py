"""Analytical response-time bounds for chained pipeline stages (§5.3).

The paper reports response-time *statistics* from simulation (Fig. 8)
and relies on Eq. 3 for schedulability. For completeness we also provide
safe analytical upper bounds per scheduling policy, built from classical
uniprocessor busy-period analysis, chained across stages:

- Each stage is a single work-conserving server (the accelerator).
- Stage-k release jitter of task i equals the sum of upstream response
  bounds (a job reaches stage k only after finishing stages < k).
- FIFO: a job's response time at a stage is bounded by the length of the
  synchronous busy period of that stage with jitter-inflated arrivals —
  FIFO serves in arrival order, so a job finishes no later than the end
  of the busy period containing its arrival.
- EDF (implicit deadlines, u <= 1): without jitter, uniprocessor EDF
  meets all deadlines, so R <= d. With release jitter J, a safe bound is
  R <= d + J_max (jitter can delay completion at most by itself under a
  deadline-ordered work-conserving server) — we additionally cap by the
  jitter-inflated busy period, taking the tighter of the two.
- Limited preemption (the runtime's tile-window and the DES's
  ``preemption="window"`` semantics): preemption happens only at
  non-preemptible chunk boundaries, so a job additionally suffers a
  *blocking term* ``B^k`` — the longest non-preemptible chunk of work
  on stage k that may be in flight when it gains priority. EDF picks
  earliest-deadline work whenever any is pending, so within one busy
  interval at most **one** later-deadline chunk can be in service
  (after its boundary, no later-deadline work restarts while
  earlier-deadline work waits); the stage bound therefore gains a
  single ``B^k`` in both the deadline term and the busy period.
  FIFO needs no blocking term: it never preempts, and every chunk in
  service when a job arrives belongs to an earlier arrival already
  counted by its busy period.

These bounds require strict u^k < 1 for a finite busy period; at u == 1
the theory still promises *bounded* tardiness but the busy-period fixed
point diverges, and we return ``inf`` (documented conservatism).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.rt.task import SegmentTable, TaskSet

_MAX_ITERS = 10_000


def busy_period(
    wcets: list[float],
    periods: list[float],
    jitters: list[float] | None = None,
    blocking: float = 0.0,
) -> float:
    """Longest synchronous busy period: least L > 0 with
    ``L = B + sum_i ceil((L + J_i) / p_i) * e_i``. Returns inf if
    u >= 1. ``blocking`` is the limited-preemption term ``B``: at most
    one non-preemptible chunk of excluded (lower-priority) work may be
    in service when the busy period starts.
    """
    if jitters is None:
        jitters = [0.0] * len(wcets)
    active = [
        (e, p, j) for e, p, j in zip(wcets, periods, jitters) if e > 0.0
    ]
    if not active:
        return blocking if blocking > 0.0 else 0.0
    if any(math.isinf(j) for _, _, j in active):
        # an active task with unbounded release jitter (its upstream
        # stage saturated) makes this stage's busy period unbounded too
        return math.inf
    u = sum(e / p for e, p, _ in active)
    if u >= 1.0 - 1e-12:
        return math.inf
    L = blocking + sum(e for e, _, _ in active)
    for _ in range(_MAX_ITERS):
        nxt = blocking + sum(
            math.ceil((L + j) / p) * e for e, p, j in active
        )
        if nxt <= L + 1e-15:
            return nxt
        L = nxt
    return math.inf


@dataclass
class StageBounds:
    """Per-stage response bounds ``R_i^k`` (0 for skipped stages)."""

    per_task: list[float]


def fifo_stage_bound(
    table: SegmentTable,
    taskset: TaskSet,
    k: int,
    jitters: list[float],
) -> StageBounds:
    """FIFO response bound at stage k: busy-period cap for active tasks."""
    wcets = [table.wcet(i, k, preemptive=False) for i in range(table.n_tasks)]
    periods = [t.period for t in taskset.tasks]
    L = busy_period(wcets, periods, jitters)
    return StageBounds(per_task=[L if e > 0 else 0.0 for e in wcets])


def edf_stage_bound(
    table: SegmentTable,
    taskset: TaskSet,
    k: int,
    jitters: list[float],
    blocking: float = 0.0,
) -> StageBounds:
    """EDF response bound at stage k: min(d_i + J_i + B, busy period).

    ``blocking`` is the stage's limited-preemption term ``B^k`` (the
    longest non-preemptible chunk that can hold an urgent job at a
    window boundary); it enters the deadline term once and the busy
    period once — see the module docstring for why a single ``B``
    suffices under EDF.

    The deadline term is only a valid bound while the stage's busy
    period is finite (its premise — uniprocessor EDF meets deadlines —
    needs ``u < 1``): on a saturated or overloaded stage (``L == inf``)
    claiming ``R <= d + J + B`` would be unsound, so the bound degrades
    to ``inf`` (caught by the cross-layer conformance harness: the DES
    exceeded the "bound" on exactly such stages).
    """
    wcets = [table.wcet(i, k, preemptive=True) for i in range(table.n_tasks)]
    periods = [t.period for t in taskset.tasks]
    L = busy_period(wcets, periods, jitters, blocking=blocking)
    out = []
    for i, e in enumerate(wcets):
        if e <= 0:
            out.append(0.0)
            continue
        if L == math.inf:
            out.append(math.inf)
            continue
        deadline_bound = taskset.tasks[i].deadline + jitters[i] + blocking
        out.append(min(max(deadline_bound, e), L))
    return StageBounds(per_task=out)


def end_to_end_bounds(
    table: SegmentTable,
    taskset: TaskSet,
    policy: str,
    blocking: list[float] | None = None,
) -> list[float]:
    """End-to-end response-time upper bound per task.

    Chains the per-stage bounds: the stage-k jitter of task i is the sum
    of its bounds at stages < k (its segment cannot be released earlier
    than its own arrival nor later than the upstream bound).

    ``blocking`` optionally gives the per-stage limited-preemption
    blocking term ``B^k`` (max non-preemptible chunk on stage k, e.g.
    `repro_torch.conformance.CostModel.stage_window_quantum`) for systems
    whose scheduler preempts only at chunk/window boundaries. It only
    affects EDF; FIFO never preempts, so chunk granularity cannot
    change its schedule.
    """
    if policy not in ("fifo", "edf"):
        raise ValueError(f"unknown policy {policy!r}")
    if blocking is not None and len(blocking) != table.n_stages:
        raise ValueError("blocking vector length != n_stages")
    n = table.n_tasks
    totals = [0.0] * n
    jitters = [0.0] * n
    for k in range(table.n_stages):
        if policy == "fifo":
            sb = fifo_stage_bound(table, taskset, k, jitters)
        else:
            sb = edf_stage_bound(
                table,
                taskset,
                k,
                jitters,
                blocking=blocking[k] if blocking is not None else 0.0,
            )
        for i in range(n):
            if table.base[i][k] > 0.0:
                totals[i] += sb.per_task[i]
                jitters[i] = totals[i]
    return totals
