"""Online SRT admission control over the paper's static analysis.

The DSE uses Eq. 3 (`srt_schedulable`) once, at design time. A serving
deployment faces a *stream* of tenancy changes: new tasks asking for
capacity, old ones leaving, traffic models being re-provisioned. The
`AdmissionController` answers admit/reject **online** against the same
analysis:

- It caches each stage's utilization sum (Eq. 2). An admit check adds
  the candidate's per-stage contribution and compares against the cap —
  O(n_stages), not a full re-analysis over all admitted tasks.
- The cache is *exact*, not approximate: contributions are accumulated
  left-to-right in admission order, and every removal triggers a full
  recompute in the surviving order — so a cached verdict equals the
  verdict of rebuilding the `SegmentTable` and re-running
  `srt_schedulable` bit-for-bit (asserted by `verify`, and by the test
  suite on every decision).
- `headroom_report` exposes the sensitivity side: per-stage slack, the
  max admissible rate for a probe WCET vector (`max_admissible_rate`
  semantics), and per-tenant rate multipliers.

Guaranteed vs best-effort: only *guaranteed* requests consume Eq. 2
budget. A ``best_effort=True`` request is always admitted but carries no
response-time guarantee (its jobs run at infinite deadline in the
serving runtime) and contributes nothing to the cached utilization.

Calibrated-admission mode: `calibrated_requests` /
`AdmissionController.from_cost_model` swap every contract's modeled
per-stage WCETs for a `repro_torch.conformance.CostModel`'s — typically a
`CostModel.calibrate` measurement of the serving host — so admission
runs against what the host actually does instead of what the TPU exec
model predicts (`run_wallclock_case` exercises the mode end to end).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.rt.batch import (
    batched_admission_check,
    batched_tenant_utilizations,
)
from repro_torch.core.rt.response_time import end_to_end_bounds
from repro_torch.core.rt.schedulability import EPS, srt_schedulable
from repro_torch.core.rt.task import LayerDesc, SegmentTable, Task, TaskSet, Workload

#: criticality levels a tenant contract may carry, most critical first
#: (Vestal-style, extensible: the overload `ModeController` in
#: `repro_torch.traffic.modes` guarantees every level strictly above its
#: configured shed threshold). "HI" is safety-critical — survives an
#: overload mode switch with a re-proved Eq. 3 contract; "LO" is
#: mission/best-effort work the switch sheds or demotes.
CRITICALITY_HI = "HI"
CRITICALITY_LO = "LO"
CRITICALITY_LEVELS = (CRITICALITY_HI, CRITICALITY_LO)


@dataclass(frozen=True)
class TaskRequest:
    """A candidate tenant: per-stage base WCETs + traffic contract.

    ``base[k]`` is ``b^k`` (pure segment length on stage k, 0 when the
    stage is skipped) — one row of a `SegmentTable`. ``period`` is the
    analysis period: the minimum inter-arrival for (spo)radic traffic or
    the provisioned period (`ArrivalProcess.analysis_period`) for
    stochastic traffic. ``value`` feeds the shed-by-value policy;
    ``criticality`` (one of `CRITICALITY_LEVELS`) feeds the overload
    `ModeController` — "HI" tenants keep their guarantee through a mode
    switch, "LO" tenants are shed or demoted.
    """

    name: str
    base: tuple[float, ...]
    period: float
    deadline: float = 0.0  # 0 -> implicit (= period)
    value: float = 1.0
    best_effort: bool = False
    criticality: str = CRITICALITY_LO

    def __post_init__(self) -> None:
        if self.period <= 0 or not math.isfinite(self.period):
            raise ValueError("analysis period must be positive and finite")
        if any(b < 0 for b in self.base):
            raise ValueError("negative WCET")
        if not any(b > 0 for b in self.base):
            raise ValueError("request has no active stage")
        if self.criticality not in CRITICALITY_LEVELS:
            raise ValueError(
                f"unknown criticality {self.criticality!r}; "
                f"expected one of {CRITICALITY_LEVELS}"
            )
        if self.deadline == 0.0:
            object.__setattr__(self, "deadline", self.period)

    def wcet(self, k: int, overhead: float, preemptive: bool) -> float:
        b = self.base[k]
        if b <= 0.0:
            return 0.0
        return b + (overhead if preemptive else 0.0)

    def utilization(self, overheads: Sequence[float], preemptive: bool):
        return tuple(
            self.wcet(k, overheads[k], preemptive) / self.period
            for k in range(len(self.base))
        )


@dataclass(frozen=True)
class AdmissionDecision:
    request: TaskRequest
    admitted: bool
    reason: str
    #: Eq. 2 per-stage utilization had/has the request been admitted
    stage_utils: tuple[float, ...]
    #: argmax stage of ``stage_utils`` — the bottleneck accelerator
    bottleneck: int
    guaranteed: bool = True

    @property
    def max_util(self) -> float:
        return max(self.stage_utils)


@dataclass(frozen=True)
class StageHeadroom:
    stage: int
    utilization: float
    slack: float
    #: max extra jobs/s of the probe WCET through this stage (inf if
    #: the probe skips it)
    probe_rate: float


@dataclass(frozen=True)
class HeadroomReport:
    """Sensitivity snapshot of the admitted set (see `headroom_report`)."""

    stages: tuple[StageHeadroom, ...]
    #: max admissible release rate of the probe task (min over stages)
    probe_max_rate: float
    #: per admitted tenant: max rate multiplier keeping Eq. 3
    tenant_rate_multipliers: dict[str, float]

    @property
    def bottleneck(self) -> int:
        return max(self.stages, key=lambda s: s.utilization).stage


def calibrated_requests(
    cost_model, requests: Sequence[TaskRequest]
) -> tuple[TaskRequest, ...]:
    """The same tenant contracts with measured per-stage WCETs.

    ``cost_model`` is a `repro_torch.conformance.CostModel` whose task order
    matches ``requests`` (both come from the scenario's serve bundle);
    each request keeps its period/deadline/value — the traffic contract
    — while ``base`` becomes the model's `segment_cost` row. With a
    `CostModel.calibrate` model this is serving-host calibration; with
    `CostModel.from_exec_model` it reproduces the modeled contracts.
    """
    if cost_model.n_tasks != len(requests):
        raise ValueError(
            f"cost model prices {cost_model.n_tasks} tasks, "
            f"got {len(requests)} requests"
        )
    return tuple(
        TaskRequest(
            name=r.name,
            base=tuple(
                cost_model.segment_cost(i, k)
                for k in range(cost_model.n_stages)
            ),
            period=r.period,
            deadline=r.deadline,
            value=r.value,
            best_effort=r.best_effort,
            criticality=r.criticality,
        )
        for i, r in enumerate(requests)
    )


class AdmissionController:
    """Incremental Eq. 2/3 oracle for online admission.

    ``util_cap`` defaults to 1.0 (Eq. 3). Deployments wanting margin for
    model error can run at e.g. 0.9; the comparison keeps the same EPS
    float tolerance as `srt_schedulable` so cached and full verdicts
    coincide exactly at cap 1.0.
    """

    def __init__(
        self,
        overheads: Sequence[float],
        *,
        preemptive: bool = True,
        util_cap: float = 1.0,
    ):
        if not overheads:
            raise ValueError("need at least one stage")
        self.overheads = tuple(float(o) for o in overheads)
        self.preemptive = preemptive
        self.util_cap = util_cap
        self._util = [0.0] * len(self.overheads)
        self._admitted: list[TaskRequest] = []  # guaranteed, in order
        self._best_effort: list[TaskRequest] = []
        self.decisions: list[AdmissionDecision] = []

    # -- construction -------------------------------------------------
    @classmethod
    def from_table(
        cls,
        table: SegmentTable,
        taskset: TaskSet,
        *,
        preemptive: bool = True,
        util_cap: float = 1.0,
    ) -> "AdmissionController":
        """Seed a controller with a design's already-resident tasks."""
        ctl = cls(
            table.overhead, preemptive=preemptive, util_cap=util_cap
        )
        for i, t in enumerate(taskset.tasks):
            dec = ctl.admit(
                TaskRequest(
                    name=t.name,
                    base=tuple(table.base[i]),
                    period=t.period,
                    deadline=t.deadline,
                )
            )
            if not dec.admitted:
                raise ValueError(
                    f"seed task {t.name!r} itself violates Eq. 3 "
                    f"(max util {dec.max_util:.3f})"
                )
        return ctl

    @classmethod
    def from_cost_model(
        cls,
        cost_model,
        requests: Sequence[TaskRequest],
        *,
        preemptive: bool = True,
        util_cap: float = 1.0,
        strict: bool = True,
    ) -> "AdmissionController":
        """Calibrated-admission mode: a controller whose resident set
        was admitted against a `CostModel`'s (typically *measured*)
        WCETs instead of the requests' modeled ones.

        Overheads are zero — the window-boundary runtime blocks, it
        does not inflate utilization (the conformance premise) — and
        every contract is re-based via `calibrated_requests` before
        admission. ``strict`` raises if a measured contract does not
        fit; ``strict=False`` records the rejection in ``decisions``
        and continues (the conformance case turns it into a violation).
        """
        ctl = cls(
            [0.0] * cost_model.n_stages,
            preemptive=preemptive,
            util_cap=util_cap,
        )
        for req in calibrated_requests(cost_model, requests):
            dec = ctl.admit(req)
            if strict and not dec.admitted:
                raise ValueError(
                    f"measured contract {req.name!r} violates Eq. 3 "
                    f"on the calibrated host: {dec.reason}"
                )
        return ctl

    # -- properties ---------------------------------------------------
    @property
    def n_stages(self) -> int:
        return len(self.overheads)

    @property
    def admitted(self) -> tuple[TaskRequest, ...]:
        return tuple(self._admitted)

    @property
    def best_effort(self) -> tuple[TaskRequest, ...]:
        return tuple(self._best_effort)

    def utilizations(self) -> tuple[float, ...]:
        return tuple(self._util)

    def names(self) -> list[str]:
        return [r.name for r in self._admitted]

    # -- the O(n_stages) admit check ----------------------------------
    def check(self, req: TaskRequest) -> AdmissionDecision:
        """Admission verdict without committing (O(n_stages))."""
        if len(req.base) != self.n_stages:
            raise ValueError(
                f"request spans {len(req.base)} stages, "
                f"controller has {self.n_stages}"
            )
        if req.best_effort:
            return AdmissionDecision(
                request=req,
                admitted=True,
                reason="best-effort: admitted without guarantee",
                stage_utils=tuple(self._util),
                bottleneck=int(
                    max(range(self.n_stages), key=self._util.__getitem__)
                ),
                guaranteed=False,
            )
        du = req.utilization(self.overheads, self.preemptive)
        after = tuple(u + d for u, d in zip(self._util, du))
        bottleneck = int(max(range(self.n_stages), key=after.__getitem__))
        ok = after[bottleneck] <= self.util_cap + EPS
        reason = (
            f"max util {after[bottleneck]:.4f} <= cap {self.util_cap}"
            if ok
            else (
                f"stage {bottleneck} would reach "
                f"{after[bottleneck]:.4f} > cap {self.util_cap}"
            )
        )
        return AdmissionDecision(
            request=req,
            admitted=ok,
            reason=reason,
            stage_utils=after,
            bottleneck=bottleneck,
        )

    # -- the batched admit check (one array pass, T tenants) ----------
    def score_many(
        self, base, periods
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The batched admission core: Eq. 3 verdicts for ``T``
        guaranteed candidates in one array pass.

        ``base`` is ``[T, n_stages]`` (one `TaskRequest.base` row per
        candidate), ``periods`` ``[T]``. Returns ``(after, bottleneck,
        ok)`` exactly as `repro_torch.core.rt.batch.batched_admission_check`:
        every row is an independent, non-committing check against the
        *current* cached utilization — bit-identical to a Python loop
        over `check` (the property suite asserts exact ``==``). This is
        the array layer `check_many` (and the placement/autoscale
        scoring) build on; it never sees best-effort requests, which
        consume no Eq. 2 budget.
        """
        b = np.asarray(base, dtype=np.float64)
        if b.ndim != 2 or b.shape[1] != self.n_stages:
            raise ValueError(
                f"base must be [T, {self.n_stages}], got {b.shape}"
            )
        du = batched_tenant_utilizations(
            b, self.overheads, periods, self.preemptive
        )
        return batched_admission_check(du, self._util, self.util_cap)

    def check_many(
        self, reqs: Sequence[TaskRequest]
    ) -> list[AdmissionDecision]:
        """Batched `check`: score every pending request in one array
        pass, bit-identical per-decision to ``[self.check(r) for r in
        reqs]`` (non-committing — no request sees another's admission).

        Best-effort rows short-circuit exactly like the scalar path
        (always admitted, no Eq. 2 contribution); guaranteed rows run
        through `score_many`. Decision objects (reason strings
        included) reproduce the scalar ones field-for-field.
        """
        for r in reqs:
            if len(r.base) != self.n_stages:
                raise ValueError(
                    f"request spans {len(r.base)} stages, "
                    f"controller has {self.n_stages}"
                )
        guaranteed = [i for i, r in enumerate(reqs) if not r.best_effort]
        out: list[AdmissionDecision | None] = [None] * len(reqs)
        if guaranteed:
            after, bottleneck, ok = self.score_many(
                [reqs[i].base for i in guaranteed],
                [reqs[i].period for i in guaranteed],
            )
            after_rows = after.tolist()
            for j, i in enumerate(guaranteed):
                k = int(bottleneck[j])
                admitted = bool(ok[j])
                peak = after_rows[j][k]
                reason = (
                    f"max util {peak:.4f} <= cap {self.util_cap}"
                    if admitted
                    else (
                        f"stage {k} would reach "
                        f"{peak:.4f} > cap {self.util_cap}"
                    )
                )
                out[i] = AdmissionDecision(
                    request=reqs[i],
                    admitted=admitted,
                    reason=reason,
                    stage_utils=tuple(after_rows[j]),
                    bottleneck=k,
                )
        for i, r in enumerate(reqs):
            if out[i] is None:
                out[i] = self.check(r)  # best-effort short-circuit
        return out  # type: ignore[return-value]

    def admit(self, req: TaskRequest) -> AdmissionDecision:
        """Check and, on success, commit the request."""
        # refuse duplicates before anything reaches the decision log, so
        # the log never carries an admitted=True entry that was not
        # actually committed
        if not req.best_effort and any(
            r.name == req.name for r in self._admitted
        ):
            raise ValueError(f"duplicate tenant name {req.name!r}")
        dec = self.check(req)
        self.decisions.append(dec)
        if not dec.admitted:
            return dec
        if req.best_effort:
            self._best_effort.append(req)
            return dec
        self._admitted.append(req)
        # commit = the same left-to-right accumulation a full recompute
        # in admission order performs, so the cache stays bit-exact
        du = req.utilization(self.overheads, self.preemptive)
        for k in range(self.n_stages):
            self._util[k] += du[k]
        return dec

    def release(self, name: str) -> TaskRequest:
        """Remove a tenant and rebuild the cache exactly (no drift)."""
        for pool in (self._admitted, self._best_effort):
            for i, r in enumerate(pool):
                if r.name == name:
                    pool.pop(i)
                    self._recompute()
                    return r
        raise KeyError(name)

    def _recompute(self) -> None:
        util = [0.0] * self.n_stages
        for r in self._admitted:
            du = r.utilization(self.overheads, self.preemptive)
            for k in range(self.n_stages):
                util[k] += du[k]
        self._util = util

    # -- full re-analysis view ----------------------------------------
    def to_analysis(self) -> tuple[SegmentTable, TaskSet] | None:
        """Materialize the admitted set for the offline tools (DES,
        response bounds, `srt_schedulable`). None when empty."""
        if not self._admitted:
            return None
        table = SegmentTable(
            base=[list(r.base) for r in self._admitted],
            overhead=list(self.overheads),
        )
        placeholder = Workload("traffic", (LayerDesc("seg", 1, 1, 1),))
        tasks = tuple(
            Task(
                workload=placeholder,
                period=r.period,
                deadline=r.deadline,
                name=r.name,
            )
            for r in self._admitted
        )
        return table, TaskSet(tasks=tasks)

    def verify(self) -> bool:
        """Cached verdict == full `srt_schedulable` re-analysis."""
        view = self.to_analysis()
        if view is None:
            return True
        table, ts = view
        full = srt_schedulable(table, ts, preemptive=self.preemptive)
        cached = max(self._util) <= 1.0 + EPS
        return full == cached

    def response_bounds(self, policy: str | None = None) -> dict[str, float]:
        """End-to-end response bounds of the admitted set (full
        analysis — O(tasks x stages), for reports, not the admit path)."""
        view = self.to_analysis()
        if view is None:
            return {}
        table, ts = view
        pol = policy or ("edf" if self.preemptive else "fifo")
        bounds = end_to_end_bounds(table, ts, pol)
        return {r.name: b for r, b in zip(self._admitted, bounds)}

    # -- sensitivity --------------------------------------------------
    def max_rate(self, base: Sequence[float]) -> float:
        """Max admissible release rate of a probe with WCETs ``base``
        (O(n_stages); `core.rt.max_admissible_rate` on the cache)."""
        rate = float("inf")
        for k, b in enumerate(base):
            if b <= 0.0:
                continue
            e = b + (self.overheads[k] if self.preemptive else 0.0)
            slack = self.util_cap - self._util[k]
            rate = min(rate, max(0.0, slack) / e)
        return rate

    def headroom_report(
        self, probe: Sequence[float] | None = None
    ) -> HeadroomReport:
        """Per-stage slack + max admissible probe rate + per-tenant rate
        multipliers — the "how much more traffic fits" answer."""
        probe = tuple(probe) if probe is not None else (0.0,) * self.n_stages
        stages = []
        for k in range(self.n_stages):
            slack = self.util_cap - self._util[k]
            b = probe[k]
            if b > 0.0:
                e = b + (self.overheads[k] if self.preemptive else 0.0)
                p_rate = max(0.0, slack) / e
            else:
                p_rate = float("inf")
            stages.append(
                StageHeadroom(
                    stage=k,
                    utilization=self._util[k],
                    slack=slack,
                    probe_rate=p_rate,
                )
            )
        mult = {}
        for r in self._admitted:
            du = r.utilization(self.overheads, self.preemptive)
            s_max = float("inf")
            for k, u_ik in enumerate(du):
                if u_ik <= 0.0:
                    continue
                slack = max(0.0, self.util_cap - self._util[k])
                s_max = min(s_max, 1.0 + slack / u_ik)
            mult[r.name] = s_max
        return HeadroomReport(
            stages=tuple(stages),
            probe_max_rate=min(s.probe_rate for s in stages),
            tenant_rate_multipliers=mult,
        )
