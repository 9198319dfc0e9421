"""Utilization and SRT-schedulability tests (paper Eqs. 2–5).

The guideline theory [Dong et al., ECRTS'17] states: on a chained
pipeline of accelerators where a job must finish all execution on
``acc^k`` before any execution on ``acc^{k+1}`` (no backtracking), the
system is SRT-schedulable — every job's response time is bounded — if
and only if every accelerator's utilization is at most 1 (Eq. 3), under
both FIFO and EDF.

Preemption overhead (EDF only) is folded into the WCET per Eq. 4–5
before the test, which preserves safety of the sufficient direction:
if the inflated utilizations pass, the real system (whose overhead is
at most the model's) is schedulable.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.rt.task import SegmentTable, TaskSet

#: Strictness slack: utilizations within EPS above 1.0 are treated as 1.0
#: to absorb float roundoff in WCET accumulation.
EPS = 1e-12


def effective_wcets(
    table: SegmentTable, preemptive: bool
) -> list[list[float]]:
    """``e_i^k`` matrix with Eq. 4 applied (xi added iff preemptive)."""
    return table.wcets(preemptive)


def stage_utilization(
    table: SegmentTable, taskset: TaskSet, k: int, preemptive: bool
) -> float:
    """Eq. 2: ``u^k = sum_i e_i^k / p_i``."""
    if len(taskset) != table.n_tasks:
        raise ValueError("taskset size != segment table size")
    return sum(
        table.wcet(i, k, preemptive) / taskset.tasks[i].period
        for i in range(table.n_tasks)
    )


def stage_utilizations(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> list[float]:
    return [
        stage_utilization(table, taskset, k, preemptive)
        for k in range(table.n_stages)
    ]


def max_utilization(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> float:
    """The DSE objective ``max_k u^k`` (paper §4.1)."""
    return max(stage_utilizations(table, taskset, preemptive))


def srt_schedulable(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> bool:
    """Eq. 3: SRT-schedulable iff ``u^k <= 1`` for every stage.

    ``preemptive=True`` applies the EDF overhead inflation first; the
    paper notes SG+EDF loses the *iff* guarantee once overhead exists —
    passing this test with inflated WCETs restores a sufficient
    condition (overhead-inclusive utilization <= 1).
    """
    return max_utilization(table, taskset, preemptive) <= 1.0 + EPS


def utilization_headroom(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> float:
    """Max proportional period *shrink* factor keeping the system
    schedulable: scaling all periods to ``x%`` scales every ``u^k`` by
    ``1/x%`` (paper §4.1), so headroom = ``1 / max_util``.
    """
    mu = max_utilization(table, taskset, preemptive)
    return float("inf") if mu <= 0 else 1.0 / mu


def stage_slacks(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> list[float]:
    """Per-stage admission slack ``1 - u^k`` — the utilization budget an
    online admission controller may still hand out on each accelerator
    before Eq. 3 flips.

    Clamped at 0 within the same ``EPS`` band `srt_schedulable` treats
    as feasible: a stage whose utilization lands within float roundoff
    above 1.0 passes the Eq. 3 gate, so reporting a (tiny) negative
    slack for it would hand the admission layer negative headroom for a
    system the analysis just called schedulable. Genuinely infeasible
    stages (``u^k > 1 + EPS``) still report their negative slack.
    """
    out = []
    for u in stage_utilizations(table, taskset, preemptive):
        slack = 1.0 - u
        if -EPS <= slack < 0.0:
            slack = 0.0
        out.append(slack)
    return out


def max_admissible_rate(
    table: SegmentTable,
    taskset: TaskSet,
    cand_base: Sequence[float],
    preemptive: bool,
) -> float:
    """Largest release rate (jobs/s) at which a *candidate* task with
    per-stage base WCETs ``cand_base`` keeps every stage at ``u^k <= 1``.

    Eq. 2 is linear in the candidate's rate ``r``: stage k moves to
    ``u^k + r * e_cand^k``, so the bound is
    ``min_k (1 - u^k) / e_cand^k`` over the candidate's active stages.
    Returns ``inf`` for an empty candidate and ``0`` when some active
    stage is already saturated.
    """
    if len(cand_base) != table.n_stages:
        raise ValueError("candidate WCET vector length != n_stages")
    rate = float("inf")
    for k, b in enumerate(cand_base):
        if b <= 0.0:
            continue
        e = b + (table.overhead[k] if preemptive else 0.0)
        slack = 1.0 - stage_utilization(table, taskset, k, preemptive)
        rate = min(rate, max(0.0, slack) / e)
    return rate


def task_rate_sensitivity(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> list[float]:
    """Per-task max rate *multiplier* keeping Eq. 3 satisfied.

    Scaling only task i's rate by ``s`` moves stage k to
    ``u^k + (s - 1) * u_i^k``; the largest admissible ``s`` is
    ``min_k 1 + (1 - u^k) / u_i^k`` over task i's active stages — the
    admission layer's sensitivity report ("how much more of *this*
    traffic fits"). On an already-infeasible set the multiplier drops
    below 1: the rate *reduction* that would restore Eq. 3 on the
    task's worst stage.
    """
    utils = stage_utilizations(table, taskset, preemptive)
    out = []
    for i, t in enumerate(taskset.tasks):
        s_max = float("inf")
        for k in range(table.n_stages):
            e = table.wcet(i, k, preemptive)
            if e <= 0.0:
                continue
            u_ik = e / t.period
            s_max = min(s_max, 1.0 + (1.0 - utils[k]) / u_ik)
        out.append(s_max)
    return out


def density_check(
    table: SegmentTable, taskset: TaskSet, preemptive: bool
) -> list[float]:
    """Per-task chain density ``sum_k e_i^k / p_i`` — diagnostic only.

    A task whose *chain* WCET exceeds its period still admits bounded
    response times in the SRT model (jobs of the same task may overlap
    across pipeline stages), so this is not a schedulability gate; it is
    reported because density > M signals a hopeless configuration.
    """
    out = []
    for i, t in enumerate(taskset.tasks):
        chain = sum(table.wcet(i, k, preemptive) for k in range(table.n_stages))
        out.append(chain / t.period)
    return out
