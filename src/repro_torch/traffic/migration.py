"""Slack-aware live tenant migration across `ShardedGateway` shards.

A production fleet rebalances tenants without ever breaking an Eq. 3
contract mid-flight. The `MigrationController` implements the
drain-and-rehome discipline on an **elastic** sharded gateway
(`ShardedGateway.from_built(..., elastic=True)`) running under the
shared-clock co-simulation (``shared_clock=True``), which gives every
shard one consistent "now" to hand jobs over in:

1. **drain** — at the plan's start time the tenant's not-yet-due
   releases are pulled from the donor shard's live schedule
   (`TrafficGateway.extract_future`: new releases stop; jobs already
   released keep running). A ``migrate_start`` event is emitted.
2. **wait**  — the handover happens only once the donor reports zero
   in-flight jobs for the tenant (``server.pending == 0``): the
   guarantee the donor proved at admission keeps holding for every job
   it ever released, so no deadline can be violated *during* the
   handover.
3. **prove** — the tenant's Eq. 3 contribution is released from the
   donor (`TrafficGateway.release_tenant`, which also refreshes the
   donor's backlog limits — never score a shard with a departed
   tenant's load) and the target is chosen **slack-aware** from fresh
   per-shard headroom: among the shards whose
   `AdmissionController.check` admits the tenant, pick the one whose
   post-admit bottleneck utilization is smallest (ties to the lower
   shard index). The proof is the same O(stages) Eq. 3 check every
   admission goes through — nothing is committed yet.
4. **commit / abort** — on success the tenant is admitted on the
   target (`admit_tenant`) and its held releases are re-stamped
   *delayed-never-dropped* onto the target's schedule
   (``s_j = max(orig_j, t_commit, s_{j-1} + period)`` — the same
   min-gap chain the JAX package's `conformance.harness.regulate_trace`
   uses), with a ``migrate_commit`` event. If no shard can prove the contract the
   migration **aborts and restores**: the tenant is re-admitted on the
   donor (always succeeds — the donor was schedulable with it a moment
   ago) and its held releases are re-injected unchanged, with a
   ``migrate_abort`` event. Either way the fleet never runs a tenant
   without a committed Eq. 3 proof.

The controller is a co-simulation hook: `ShardedGateway.run` calls
``bind(sharded)`` once and ``on_tick(rel_now)`` every global iteration
(after the due-release sweep), so drains start and handovers land at
deterministic virtual times.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "MigrationPlan",
    "MigrationRecord",
    "MigrationController",
]


@dataclass(frozen=True)
class MigrationPlan:
    """One requested migration: drain ``tenant`` starting at scenario
    time ``at``; re-home onto ``target`` (a shard index) or, with
    ``target=None``, onto the slack-aware best shard."""

    tenant: str
    at: float
    target: int | None = None

    def __post_init__(self) -> None:
        if self.at < 0.0:
            raise ValueError("migration start time must be >= 0")


@dataclass
class MigrationRecord:
    """What actually happened to one `MigrationPlan`."""

    tenant: str
    requested_at: float
    donor: int = -1
    target: int | None = None
    started_at: float | None = None
    committed_at: float | None = None
    aborted_at: float | None = None
    #: nominal release times withheld during the drain
    held: int = 0
    reason: str = ""

    @property
    def committed(self) -> bool:
        return self.committed_at is not None

    @property
    def aborted(self) -> bool:
        return self.aborted_at is not None


@dataclass
class _Draining:
    plan: MigrationPlan
    record: MigrationRecord
    donor: int
    idx: int  # global tenant index
    held: list[float]  # withheld nominal release times


class MigrationController:
    """Executes `MigrationPlan`s over an elastic sharded gateway.

    Construct with the plans and (optionally) the run's
    `repro_torch.obs.TraceRecorder`, pass as ``controller=`` to
    `ShardedGateway.run(shared_clock=True)`. After the run, `records`
    holds one `MigrationRecord` per plan (request order) and
    `final_assignment` the post-migration tenant -> shard map.
    """

    def __init__(self, plans, *, trace=None):
        self.plans = sorted(plans, key=lambda p: (p.at, p.tenant))
        self.records: list[MigrationRecord] = []
        self._tr = (
            trace
            if trace is not None and getattr(trace, "enabled", False)
            else None
        )
        self._sharded = None
        self._pending: list[MigrationPlan] = list(self.plans)
        self._draining: list[_Draining] = []

    # -- co-simulation hooks ------------------------------------------
    def bind(self, sharded) -> None:
        if not getattr(sharded, "elastic", False):
            raise ValueError(
                "live migration needs an elastic ShardedGateway "
                "(from_built(..., elastic=True)) — subset-built servers "
                "cannot serve a migrated-in tenant"
            )
        self._sharded = sharded
        self._idx = {n: i for i, n in enumerate(sharded.names)}

    def on_tick(self, rel_now: float) -> None:
        """Advance the migration state machine at global time
        ``rel_now`` (seconds since run start)."""
        while self._pending and self._pending[0].at <= rel_now:
            self._start(self._pending.pop(0), rel_now)
        still: list[_Draining] = []
        for d in self._draining:
            gw = self._sharded.gateways[d.donor]
            if gw.server.pending(d.idx) == 0:
                self._handover(d, rel_now)
            else:
                still.append(d)
        self._draining = still

    # -- the state machine --------------------------------------------
    def _start(self, plan: MigrationPlan, now: float) -> None:
        rec = MigrationRecord(tenant=plan.tenant, requested_at=plan.at)
        self.records.append(rec)
        idx = self._idx.get(plan.tenant)
        donor = (
            self._sharded.shard_of_tenant(idx) if idx is not None else None
        )
        if idx is None or donor is None:
            rec.aborted_at = now
            rec.reason = "tenant not active on any shard"
            return
        if plan.target is not None and (
            not 0 <= plan.target < len(self._sharded.gateways)
            or self._sharded.gateways[plan.target] is None
        ):
            rec.aborted_at = now
            rec.reason = f"target shard {plan.target} does not exist"
            return
        rec.donor = donor
        rec.started_at = now
        held = self._sharded.gateways[donor].extract_future(idx)
        rec.held = len(held)
        if self._tr is not None:
            self._tr.emit(
                "migrate_start", now, "gateway", plan.tenant,
                -1, donor,
                attrs={"held": len(held), "requested_target": plan.target},
            )
        self._draining.append(
            _Draining(plan=plan, record=rec, donor=donor, idx=idx, held=held)
        )

    def _candidates(self, d: _Draining) -> list[int]:
        if d.plan.target is not None:
            return [d.plan.target] if d.plan.target != d.donor else []
        return [
            k
            for k, gw in enumerate(self._sharded.gateways)
            if gw is not None and k != d.donor
        ]

    def _handover(self, d: _Draining, now: float) -> None:
        sharded, rec = self._sharded, d.record
        donor_gw = sharded.gateways[d.donor]
        req = donor_gw.release_tenant(d.idx)
        # slack-aware target choice on *fresh* post-release state: the
        # non-committing Eq. 3 check, smallest post-admit bottleneck
        # utilization wins (ties to the lower shard index)
        best, best_util = None, float("inf")
        for k in self._candidates(d):
            dec = sharded.gateways[k].admission.check(req)
            if not dec.admitted:
                continue
            util = dec.stage_utils[dec.bottleneck]
            if util < best_util:
                best, best_util = k, util
        if best is None:
            self._abort(d, req, now)
            return
        dec = sharded.gateways[best].admit_tenant(d.idx)
        if not dec.admitted:  # pragma: no cover — check() just passed
            self._abort(d, req, now)
            return
        # delayed-never-dropped re-stamp: the held releases land on the
        # target no earlier than the commit and at least a period apart
        restamped: list[float] = []
        prev = float("-inf")
        for t in d.held:
            s = max(t, now, prev + req.period)
            restamped.append(s)
            prev = s
        sharded.gateways[best].inject_future(d.idx, restamped)
        rec.target = best
        rec.committed_at = now
        rec.reason = "committed"
        if self._tr is not None:
            self._tr.emit(
                "migrate_commit", now, "gateway", rec.tenant,
                -1, best,
                attrs={"donor": d.donor, "held": len(restamped)},
            )

    def _abort(self, d: _Draining, req, now: float) -> None:
        rec = d.record
        donor_gw = self._sharded.gateways[d.donor]
        dec = donor_gw.admit_tenant(d.idx)
        if not dec.admitted:  # pragma: no cover — donor held it before
            raise RuntimeError(
                f"abort could not restore {rec.tenant!r} on its donor: "
                f"{dec.reason}"
            )
        donor_gw.inject_future(d.idx, d.held)
        rec.target = None
        rec.aborted_at = now
        rec.reason = "no shard could prove the Eq. 3 contract"
        if self._tr is not None:
            self._tr.emit(
                "migrate_abort", now, "gateway", rec.tenant,
                -1, d.donor,
                attrs={"reason": rec.reason, "held": len(d.held)},
            )

    # -- results ------------------------------------------------------
    @property
    def committed(self) -> list[MigrationRecord]:
        return [r for r in self.records if r.committed]

    @property
    def aborted(self) -> list[MigrationRecord]:
        return [r for r in self.records if r.aborted]

    def in_progress(self) -> list[str]:
        """Tenants still draining (non-empty after a run means the
        horizon cut a migration short — the tenant stays on its donor,
        releases withheld)."""
        return [d.record.tenant for d in self._draining]

    def final_assignment(self) -> dict[str, int]:
        """Tenant -> shard after all committed migrations (plan
        assignment with commits applied in commit order)."""
        if self._sharded is None:
            raise RuntimeError("controller was never bound to a run")
        out = {
            n: s
            for n, s in zip(
                self._sharded.names, self._sharded.plan.assignment
            )
        }
        for r in self.records:
            if r.committed and r.target is not None:
                out[r.tenant] = r.target
        return out
