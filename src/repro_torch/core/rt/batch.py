"""Batched (vectorized) RT analysis over arrays of candidate designs.

The DSE evaluates thousands of candidate designs per beam iteration;
calling the scalar Eq. 2/3 and busy-period routines once per candidate
makes Python interpreter overhead the bottleneck. This module provides
numpy-vectorized versions that evaluate a whole *stack* of candidate
`SegmentTable`s at once: ``base`` is a ``[C, n_tasks, n_stages]`` array
(candidate-major), ``overhead`` a ``[n_stages]`` or ``[C, n_stages]``
array, and every function returns per-candidate results.

Bit-compatibility contract: every function here produces **bit-identical
float64 results** to its scalar counterpart in
`repro_torch.core.rt.schedulability` / `repro_torch.core.rt.response_time`. That is
not best-effort — the property suite asserts exact ``==`` over
randomized designs — and it is what lets the DSE swap the batched
evaluator in without perturbing a single search decision. The rules
that make it hold:

- only the *candidate* axis is vectorized; reductions over tasks and
  stages run as explicit Python loops in the same order as the scalar
  code (float addition is not associative — numpy's pairwise ``sum``
  would diverge in the last ulp);
- inactive entries contribute exact ``0.0`` terms (adding ``0.0`` is an
  identity on every finite float), mirroring the scalar ``e > 0``
  filters without changing accumulation order;
- fixed-point iterations (`batched_busy_period`) update all still-
  converging candidates with the same update expression the scalar
  loop uses; converged/diverged lanes are frozen by masking.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.rt.schedulability import EPS
from repro_torch.core.rt.task import TaskSet

#: scalar `busy_period` limits, shared so the lockstep never drifts
_MAX_ITERS = 10_000
_DIVERGE_EPS = 1e-12
_CONVERGE_EPS = 1e-15


def _as_batch(base) -> np.ndarray:
    a = np.asarray(base, dtype=np.float64)
    if a.ndim != 3:
        raise ValueError(f"base must be [C, n_tasks, n_stages], got {a.shape}")
    return a


def _overhead_rows(overhead, n_cand: int, n_stages: int) -> np.ndarray:
    ov = np.asarray(overhead, dtype=np.float64)
    if ov.ndim == 1:
        ov = np.broadcast_to(ov, (n_cand, n_stages))
    if ov.shape != (n_cand, n_stages):
        raise ValueError("overhead must be [n_stages] or [C, n_stages]")
    return ov


def batched_wcets(base, overhead, preemptive: bool) -> np.ndarray:
    """``e_i^k`` per candidate (Eq. 4): ``b + xi`` when preemptive and
    the stage is active, ``b`` otherwise, ``0`` on skipped stages."""
    b = _as_batch(base)
    if not preemptive:
        return np.where(b > 0.0, b, 0.0)
    ov = _overhead_rows(overhead, b.shape[0], b.shape[2])
    return np.where(b > 0.0, b + ov[:, None, :], 0.0)


def batched_stage_utilizations(
    base, overhead, taskset: TaskSet, preemptive: bool
) -> np.ndarray:
    """Eq. 2 per candidate: ``u^k = sum_i e_i^k / p_i`` -> [C, K]."""
    b = _as_batch(base)
    if len(taskset) != b.shape[1]:
        raise ValueError("taskset size != segment table size")
    e = batched_wcets(b, overhead, preemptive)
    util = np.zeros((b.shape[0], b.shape[2]))
    # task-order accumulation matches the scalar generator sum exactly
    for i, t in enumerate(taskset.tasks):
        util += e[:, i, :] / t.period
    return util


def batched_max_utilization(
    base, overhead, taskset: TaskSet, preemptive: bool
) -> np.ndarray:
    """``max_k u^k`` per candidate — the DSE objective vector."""
    return batched_stage_utilizations(
        base, overhead, taskset, preemptive
    ).max(axis=1)


def batched_srt_schedulable(
    base, overhead, taskset: TaskSet, preemptive: bool
) -> np.ndarray:
    """Eq. 3 verdict per candidate (bool array)."""
    return (
        batched_max_utilization(base, overhead, taskset, preemptive)
        <= 1.0 + EPS
    )


def batched_tenant_utilizations(
    base, overhead, periods, preemptive: bool
) -> np.ndarray:
    """Per-*tenant* Eq. 2 contribution vectors -> ``[T, K]``.

    The serving-side dual of `batched_stage_utilizations`: instead of
    summing one shared taskset per candidate design, this prices every
    tenant of one design independently — ``base`` is ``[T, n_stages]``
    (one `TaskRequest.base` row per tenant), ``periods`` is ``[T]``,
    and row ``t`` is exactly ``TaskRequest.utilization`` of tenant
    ``t``: ``e^k / p`` with the Eq. 4 overhead applied iff preemptive
    and the stage is active. Bit-identical to the scalar method (same
    IEEE ops, no reductions), which is what lets the admission,
    rate-limit and placement hot paths score thousands of tenants in
    one array pass without perturbing a single decision.
    """
    b = np.asarray(base, dtype=np.float64)
    if b.ndim != 2:
        raise ValueError(f"base must be [T, n_stages], got {b.shape}")
    p = np.asarray(periods, dtype=np.float64)
    if p.shape != (b.shape[0],):
        raise ValueError("periods must align 1:1 with base rows")
    e = batched_wcets(b[None, :, :], overhead, preemptive)[0]
    return e / p[:, None]


def batched_admission_check(
    tenant_utils, current_util, util_cap: float = 1.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized `AdmissionController.check` core over ``[T, K]``
    per-tenant utilization vectors against one cached Eq. 2 state.

    Returns ``(after, bottleneck, ok)``: the post-admit stage
    utilizations ``[T, K]``, the argmax stage per tenant (first max on
    ties, matching the scalar ``max(range, key=...)``), and the Eq. 3
    verdict ``after[bottleneck] <= util_cap + EPS`` — the same EPS
    band `srt_schedulable` applies. Each row is an *independent*
    non-committing check against ``current_util``, exactly like a
    Python loop over the scalar ``check``.
    """
    du = np.asarray(tenant_utils, dtype=np.float64)
    if du.ndim != 2:
        raise ValueError(f"tenant_utils must be [T, K], got {du.shape}")
    cur = np.asarray(current_util, dtype=np.float64)
    if cur.shape != (du.shape[1],):
        raise ValueError("current_util must be [n_stages]")
    after = du + cur[None, :]
    bottleneck = after.argmax(axis=1)
    peak = after[np.arange(after.shape[0]), bottleneck]
    ok = peak <= util_cap + EPS
    return after, bottleneck, ok


def batched_stage_slacks(
    base, overhead, taskset: TaskSet, preemptive: bool
) -> np.ndarray:
    """Per-candidate `stage_slacks`: ``1 - u^k`` with the same tiny-
    negative clamp the scalar version applies inside the EPS band."""
    slack = 1.0 - batched_stage_utilizations(
        base, overhead, taskset, preemptive
    )
    return np.where((slack < 0.0) & (slack >= -EPS), 0.0, slack)


def batched_busy_period(
    wcets: np.ndarray,
    periods,
    jitters: np.ndarray | None = None,
    blocking=0.0,
) -> np.ndarray:
    """Vectorized `busy_period`: least ``L > 0`` with
    ``L = B + sum_i ceil((L + J_i) / p_i) * e_i`` per candidate.

    ``wcets``/``jitters`` are ``[C, n]``, ``periods`` ``[n]``,
    ``blocking`` scalar or ``[C]``. Candidates whose utilization is
    within ``1e-12`` of 1 (or that fail to converge in the scalar
    iteration cap) return ``inf``, exactly like the scalar routine.
    """
    e = np.asarray(wcets, dtype=np.float64)
    C, n = e.shape
    p = np.asarray(periods, dtype=np.float64)
    j = (
        np.zeros_like(e)
        if jitters is None
        else np.asarray(jitters, dtype=np.float64)
    )
    # the scalar loop never sees inactive tasks' jitters; zero them so
    # the exact-0.0-term trick below stays valid even when an upstream
    # stage handed an inactive task an infinite jitter
    j = np.where(e > 0.0, j, 0.0)
    blk = np.broadcast_to(
        np.asarray(blocking, dtype=np.float64), (C,)
    ).copy()

    # zero-WCET tasks contribute exact 0.0 terms in every expression
    # below, so summing over all tasks in task order reproduces the
    # scalar loop's active-only accumulation bit-for-bit
    u = np.zeros(C)
    wsum = np.zeros(C)
    for i in range(n):
        u += e[:, i] / p[i]
        wsum += e[:, i]
    no_active = ~(e > 0.0).any(axis=1)
    # an active task with infinite jitter diverges the busy period
    # (mirrors the scalar guard added for saturated upstream stages)
    inf_jitter = (np.isinf(j) & (e > 0.0)).any(axis=1)
    diverged = ((u >= 1.0 - _DIVERGE_EPS) | inf_jitter) & ~no_active

    L = blk + wsum
    out = np.where(diverged, np.inf, L)
    pending = np.flatnonzero(~diverged)
    for _ in range(_MAX_ITERS):
        if pending.size == 0:
            break
        Lp = out[pending]
        # accumulate the ceil terms from 0 and add blocking last — the
        # scalar expression is ``blocking + sum(...)``, and float
        # addition order decides the last ulp
        acc = np.zeros(pending.size)
        for i in range(n):
            acc += np.ceil((Lp + j[pending, i]) / p[i]) * e[pending, i]
        nxt = blk[pending] + acc
        out[pending] = nxt
        pending = pending[~(nxt <= Lp + _CONVERGE_EPS)]
    else:
        out[pending] = np.inf
    # scalar early-returns `blocking if blocking > 0 else 0.0` for an
    # all-skip row; the fixed point above already lands there, but the
    # blocking == 0 case must be exact +0.0, not a -0.0 survivor
    out[no_active & (blk <= 0.0)] = 0.0
    return out


def batched_end_to_end_bounds(
    base,
    overhead,
    taskset: TaskSet,
    policy: str,
    blocking=None,
) -> np.ndarray:
    """Vectorized `end_to_end_bounds` -> ``[C, n_tasks]``.

    Chains per-stage FIFO/EDF busy-period bounds with upstream-response
    jitter exactly like the scalar routine; ``blocking`` is the
    per-stage limited-preemption term (``[K]`` or ``[C, K]``, EDF only).
    """
    if policy not in ("fifo", "edf"):
        raise ValueError(f"unknown policy {policy!r}")
    b = _as_batch(base)
    C, n, K = b.shape
    periods = [t.period for t in taskset.tasks]
    deadlines = np.asarray([t.deadline for t in taskset.tasks])
    if blocking is None:
        blk = np.zeros((C, K))
    else:
        blk = np.asarray(blocking, dtype=np.float64)
        if blk.ndim == 1:
            blk = np.broadcast_to(blk, (C, K))
        if blk.shape != (C, K):
            raise ValueError("blocking must be [n_stages] or [C, n_stages]")
    e = batched_wcets(b, overhead, preemptive=(policy == "edf"))

    totals = np.zeros((C, n))
    jitters = np.zeros((C, n))
    for k in range(K):
        ek = e[:, :, k]
        if policy == "fifo":
            L = batched_busy_period(ek, periods, jitters)
            sb = np.where(ek > 0.0, L[:, None], 0.0)
        else:
            bk = blk[:, k]
            L = batched_busy_period(ek, periods, jitters, blocking=bk)
            # (d_i + J_i) + B in the scalar association order
            dl = (deadlines[None, :] + jitters) + bk[:, None]
            sb = np.minimum(np.maximum(dl, ek), L[:, None])
            sb = np.where(ek > 0.0, sb, 0.0)
            sb = np.where(
                (ek > 0.0) & np.isinf(L)[:, None], np.inf, sb
            )
        active = b[:, :, k] > 0.0
        totals = np.where(active, totals + sb, totals)
        jitters = totals.copy()
    return totals
