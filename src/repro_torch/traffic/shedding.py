"""Overload shedding: what to do when reality contradicts the analysis.

Admission guarantees Eq. 3 for the *modeled* traffic. Live systems still
overload — stochastic arrivals exceed their provisioned rate, WCETs were
optimistic, a stage degrades. The `BacklogMonitor` watches the observed
per-tenant backlog against what the analysis promises (bounded response
=> bounded backlog) and engages a `SheddingPolicy` while the two
disagree; the policy decides, per released job, whether it is submitted,
dropped, or demoted to best-effort:

- `RejectNewest`   — admission-order LIFO: tenants admitted last lose
  their jobs first (the earliest tenants keep their contract).
- `ShedByValue`    — drop jobs of the lowest value-density tenant first
  (value per unit of bottleneck utilization), safety tenants last.
- `DegradeToBestEffort` — same ordering as `ShedByValue` but demotes to
  the no-guarantee class instead of dropping: the work still runs when
  capacity allows, it just stops competing with guaranteed deadlines.

Policies only act on tenants with *observed* backlog; a tenant inside
its analysis envelope is never shed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Protocol, Sequence

from repro_torch.traffic.admission import AdmissionController, TaskRequest

#: shedding verdicts for one released job
SUBMIT = "submit"
DROP = "drop"
BEST_EFFORT = "best_effort"


@dataclass
class BacklogMonitor:
    """Detects analysis contradiction from observed backlog.

    If the admitted set is schedulable, each tenant's pending-job count
    is bounded by ``ceil(R_bound / period) + 1`` (jobs released inside
    one response-bound window). We engage shedding when the observed
    pending count exceeds ``margin`` times that bound (or ``fallback``
    jobs when the analytic bound is infinite/unavailable), and
    disengage at half the trigger level — hysteresis, so the gateway
    does not flap at the boundary.
    """

    margin: float = 2.0
    fallback: int = 8
    engaged: dict[int, bool] = field(default_factory=dict)

    def limit_for(self, bound: float, period: float) -> int:
        if not math.isfinite(bound) or bound <= 0:
            return self.fallback
        return max(2, math.ceil(self.margin * (bound / period + 1.0)))

    def observe(self, task_idx: int, pending: int, limit: int) -> bool:
        """Update hysteresis state; True while shedding is engaged."""
        on = self.engaged.get(task_idx, False)
        if not on and pending > limit:
            on = True
        elif on and pending <= max(1, limit // 2):
            on = False
        self.engaged[task_idx] = on
        return on

    def any_engaged(self) -> bool:
        return any(self.engaged.values())


class SheddingPolicy(Protocol):
    name: str
    #: whether the policy actually *removes* work (drops releases).
    #: Dropping policies can restore the analysis's boundedness promise
    #: under sustained overdrive; demote-only policies cannot — the
    #: overload conformance case (`run_shedding_case`) keys its verdict
    #: claim on this.
    drops: bool

    def classify(
        self,
        task_idx: int,
        overloaded: Sequence[int],
        admission: AdmissionController,
        requests: Sequence[TaskRequest],
    ) -> str:
        """Verdict for one released job of ``task_idx`` given the set of
        currently-overloaded tenant indices: SUBMIT, DROP or
        BEST_EFFORT."""
        ...


def _value_density(
    req: TaskRequest, admission: AdmissionController
) -> float:
    """Value per unit of bottleneck-stage utilization demand."""
    du = req.utilization(admission.overheads, admission.preemptive)
    demand = max(du) if any(du) else 1e-12
    return req.value / max(demand, 1e-12)


@dataclass(frozen=True)
class RejectNewest:
    """Shed jobs of the most recently admitted overloaded tenants."""

    name: str = "reject_newest"
    #: a dropping policy actually removes work, so it can restore the
    #: analysis's boundedness promise under sustained overdrive;
    #: demote-only policies cannot (the work still runs) — overload
    #: conformance (`run_shedding_case`) keys its verdict claim on this
    drops: bool = True

    def classify(self, task_idx, overloaded, admission, requests):
        if task_idx not in overloaded:
            return SUBMIT
        # Tenants earlier in admission order keep their releases; the
        # newest overloaded tenant(s) shed. Order = position of the
        # request name in the controller's admission log.
        order = admission.names()

        def rank(i):
            try:
                return order.index(requests[i].name)
            except ValueError:
                return len(order)  # unknown/best-effort: shed first

        newest = max(overloaded, key=rank)
        return DROP if task_idx == newest else SUBMIT


@dataclass(frozen=True)
class ShedByValue:
    """Shed the lowest value-density overloaded tenant's jobs."""

    name: str = "shed_by_value"
    drops: bool = True

    def classify(self, task_idx, overloaded, admission, requests):
        if task_idx not in overloaded:
            return SUBMIT
        cheapest = min(
            overloaded,
            key=lambda i: _value_density(requests[i], admission),
        )
        return DROP if task_idx == cheapest else SUBMIT


@dataclass(frozen=True)
class DegradeToBestEffort:
    """Demote instead of drop: overloaded low-value tenants keep running
    without a deadline guarantee."""

    name: str = "degrade_best_effort"
    drops: bool = False

    def classify(self, task_idx, overloaded, admission, requests):
        if task_idx not in overloaded:
            return SUBMIT
        cheapest = min(
            overloaded,
            key=lambda i: _value_density(requests[i], admission),
        )
        return BEST_EFFORT if task_idx == cheapest else SUBMIT


def des_release_shedding(
    policy: SheddingPolicy,
    admission: AdmissionController,
    requests: Sequence[TaskRequest],
    *,
    monitor: BacklogMonitor | None = None,
    bound_policy: str | None = None,
):
    """Mirror the gateway's backlog-triggered shedding *inside* the DES.

    Builds a `repro_torch.scheduler.des.ReleaseShedding` whose per-task engage
    limits come from the admitted set's analysis response bounds exactly
    like `TrafficGateway.open` derives the gateway's
    (``monitor.limit_for(bound, period)``), and whose classify hook
    calls this module's ``policy`` with the same arguments the gateway
    passes. `scheduler.des.simulate(cfg.shedding=...)` then sheds at
    release time against the *simulated* backlog — same hysteresis,
    same policy, same limits — so DES, runtime and analysis can be
    conformance-checked under overload.
    """
    from repro_torch.scheduler.des import ReleaseShedding

    monitor = monitor or BacklogMonitor()
    bounds = admission.response_bounds(bound_policy)
    limits = tuple(
        monitor.limit_for(bounds.get(r.name, float("inf")), r.period)
        for r in requests
    )

    def classify(task_idx: int, overloaded) -> str:
        return policy.classify(task_idx, list(overloaded), admission, requests)

    return ReleaseShedding(limits=limits, classify=classify)


POLICIES = {
    p.name: p
    for p in (RejectNewest(), ShedByValue(), DegradeToBestEffort())
}


def get_policy(name: str) -> SheddingPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown shedding policy {name!r}; have {sorted(POLICIES)}"
        ) from None
