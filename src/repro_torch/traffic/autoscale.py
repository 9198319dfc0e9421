"""Headroom-driven autoscaling: grow/shrink the shard fleet as traffic
ramps, never running a tenant without an Eq. 3 proof.

The `Autoscaler` drives a **ramp** — a sequence of `RampPhase`s, each
naming the tenants active for a duration — as a chain of epochs. Every
epoch runs a static `ShardedGateway` (shared-clock co-simulation) over
the phase's active tenants; *between* epochs the autoscaler re-plans
the fleet from headroom:

- **carry over**  — tenants surviving from the previous phase keep
  their shard (placement stability: no gratuitous re-homing).
- **grow**        — each newly active tenant is placed slack-aware
  (smallest post-admit bottleneck utilization among the shards whose
  Eq. 3 `AdmissionController.check` admits it). When *no* shard can
  prove the contract, the fleet grows by one replica (up to
  ``max_shards``) and the tenant lands there.
- **shrink**      — after placement the emptiest shard (fewest
  tenants, ties to the lightest bottleneck utilization from the fresh
  headroom of its proof controller) is **drained before removal**:
  every one of its tenants must be provably re-admittable on the
  remaining shards — only then are they re-homed (one
  ``migrate_start``/``migrate_commit`` pair each, stamped at the phase
  boundary) and the replica retired. If any tenant fits nowhere else
  the shard stays. Shrinking repeats until blocked or ``min_shards``.

Scoring always uses freshly recomputed utilizations (the proof
controllers mirror each shard's would-be admitted set), never a stale
snapshot — the headroom-staleness discipline
`TrafficGateway.release_tenant` enforces at the gateway layer. The
previous epoch's `ShardedReport.headrooms` is surfaced on each
`EpochResult` so callers can correlate decisions with observed load.

The whole ramp is deterministic: phase boundaries are virtual times,
placement is greedy with fixed tie-breaks, and each epoch's gateway is
built through the same `built_gateway` path as every other run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.rt.batch import batched_tenant_utilizations
from repro_torch.core.rt.schedulability import EPS
from repro_torch.traffic.admission import AdmissionController
from repro_torch.traffic.shard import ShardedGateway, ShardedReport, ShardPlan

__all__ = [
    "RampPhase",
    "EpochResult",
    "AutoscaleReport",
    "Autoscaler",
]


@dataclass(frozen=True)
class RampPhase:
    """One traffic plateau: the *global* tenant indices (into the
    scenario's request list) active for ``duration`` seconds."""

    duration: float
    active: tuple[int, ...]

    def __post_init__(self) -> None:
        if self.duration <= 0.0:
            raise ValueError("phase duration must be > 0")
        if len(set(self.active)) != len(self.active):
            raise ValueError("duplicate tenant indices in phase")


@dataclass
class EpochResult:
    """One phase as actually run."""

    phase: int
    t_start: float
    n_shards: int
    #: global tenant index -> shard for this epoch
    assignment: dict[int, int]
    report: ShardedReport
    #: tenants re-homed off a drained shard at this epoch's boundary
    rehomed: tuple[str, ...] = ()
    grew: int = 0
    shrank: int = 0

    def admitted_count(self) -> int:
        return self.report.admitted_count()

    def tenant_count(self) -> int:
        return len(self.assignment)


@dataclass
class AutoscaleReport:
    epochs: list[EpochResult] = field(default_factory=list)

    def admit_rate(self) -> float:
        """Admitted tenant-phases / active tenant-phases over the whole
        ramp — the gate metric the JAX package's
        `benchmarks/shard_bench.py` compares against every static-K
        fleet."""
        total = sum(e.tenant_count() for e in self.epochs)
        adm = sum(e.admitted_count() for e in self.epochs)
        return adm / total if total else 1.0

    def max_shards_used(self) -> int:
        return max((e.n_shards for e in self.epochs), default=0)

    def shard_counts(self) -> tuple[int, ...]:
        return tuple(e.n_shards for e in self.epochs)

    def final_assignment(self) -> dict[int, int]:
        return dict(self.epochs[-1].assignment) if self.epochs else {}


class Autoscaler:
    """Elastic fleet sizing over one `BuiltScenario`.

    Each epoch's fleet goes through
    `ShardedGateway.from_built(built.subset(...), plan=...)`. (The JAX
    package's docstring names a ``make_gateway`` hook here; neither
    package has one.)

    ``device`` and ``max_dim`` go to every epoch's gateways
    (`built_gateway`).
    """

    def __init__(
        self,
        built,
        *,
        min_shards: int = 1,
        max_shards: int = 8,
        policy: str | None = None,
        seed: int = 0,
        max_dim: int | None = 512,
        trace=None,
        device="cuda",
    ):
        if not 1 <= min_shards <= max_shards:
            raise ValueError("need 1 <= min_shards <= max_shards")
        self.built = built
        self.min_shards = min_shards
        self.max_shards = max_shards
        self.policy = policy or built.scenario.policy
        self.seed = seed
        self.max_dim = max_dim
        self.device = device
        self._tr = (
            trace
            if trace is not None and getattr(trace, "enabled", False)
            else None
        )
        self._preemptive = self.policy == "edf"
        self._n_stages = built.design.n_stages

    # -- proof controllers: fresh Eq. 3 state per planning round ------
    def _controllers(
        self, assign: dict[int, int], n_shards: int
    ) -> list[AdmissionController]:
        ctls = [
            AdmissionController(
                [0.0] * self._n_stages, preemptive=self._preemptive
            )
            for _ in range(n_shards)
        ]
        for i in sorted(assign):
            ctls[assign[i]].admit(self.built.requests[i])
        return ctls

    def _score_shards(
        self, ctls: Sequence[AdmissionController], req
    ) -> tuple[np.ndarray, np.ndarray]:
        """One array pass over all K proof controllers: per-shard
        post-admit bottleneck utilization (``peak``) and Eq. 3 verdict
        (``ok``), value-identical to calling ``ctls[k].check(req)``
        per shard — the same ``du + util`` IEEE additions against each
        controller's cached Eq. 2 state, the same ``util_cap + EPS``
        band. This is what keeps the planning round O(K·stages) in
        numpy instead of O(K) Python `check` calls per tenant."""
        if len(req.base) != self._n_stages:
            raise ValueError(
                f"request spans {len(req.base)} stages, "
                f"fleet has {self._n_stages}"
            )
        du = batched_tenant_utilizations(
            [list(req.base)],
            [0.0] * self._n_stages,
            [req.period],
            self._preemptive,
        )[0]
        cur = np.array(
            [ctl.utilizations() for ctl in ctls], dtype=np.float64
        )
        caps = np.array([ctl.util_cap for ctl in ctls], dtype=np.float64)
        after = du[None, :] + cur
        peak = after.max(axis=1)
        ok = peak <= caps + EPS
        return peak, ok

    def _best_shard(
        self, ctls: Sequence[AdmissionController], req, exclude=()
    ) -> int | None:
        """Slack-aware: admitting shard with the smallest post-admit
        bottleneck utilization; None when no shard proves Eq. 3.
        First-argmin tie-break — the first shard reaching the smallest
        peak wins, exactly like the scalar strict-``<`` scan."""
        peak, ok = self._score_shards(ctls, req)
        score = np.where(ok, peak, np.inf)
        for k in exclude:
            score[k] = np.inf
        if not np.isfinite(score).any():
            return None
        return int(score.argmin())

    # -- one planning round -------------------------------------------
    def _plan_epoch(
        self,
        active: Sequence[int],
        assign: dict[int, int],
        n_shards: int,
        t_now: float,
    ) -> tuple[dict[int, int], int, tuple[str, ...], int, int]:
        """Carry over survivors, place arrivals, grow, then drain-and-
        shrink. Returns (assignment, K, rehomed names, grew, shrank)."""
        active_set = set(active)
        assign = {
            i: s for i, s in sorted(assign.items()) if i in active_set
        }
        grew = shrank = 0

        # place newly active tenants (ascending index: deterministic)
        for i in sorted(active_set - set(assign)):
            req = self.built.requests[i]
            ctls = self._controllers(assign, n_shards)
            best = self._best_shard(ctls, req)
            if best is None and n_shards < self.max_shards:
                n_shards += 1
                grew += 1
                best = n_shards - 1
            if best is None:
                # fleet at max and no shard proves the contract: the
                # tenant still gets the least-bad shard and the epoch's
                # own admission rejects it there (counted, not hidden)
                ctls = self._controllers(assign, n_shards)
                peak, _ = self._score_shards(ctls, req)
                best = int(peak.argmin())
            assign[i] = best

        # drain-and-remove the emptiest shard while everything it holds
        # provably fits elsewhere
        rehomed: list[str] = []
        while n_shards > self.min_shards:
            ctls = self._controllers(assign, n_shards)
            occupancy = [
                (
                    sum(1 for i in sorted(assign) if assign[i] == k),
                    max(ctls[k].utilizations(), default=0.0),
                    -k,
                )
                for k in range(n_shards)
            ]
            victim = min(range(n_shards), key=lambda k: occupancy[k])
            movers = [i for i in sorted(assign) if assign[i] == victim]
            moves: dict[int, int] = {}
            ok = True
            for i in movers:
                req = self.built.requests[i]
                dst = self._best_shard(ctls, req, exclude=(victim,))
                if dst is None:
                    ok = False
                    break
                ctls[dst].admit(req)
                moves[i] = dst
            if not ok:
                break
            for i, dst in sorted(moves.items()):
                assign[i] = dst
                name = self.built.requests[i].name
                rehomed.append(name)
                if self._tr is not None:
                    self._tr.emit(
                        "migrate_start", t_now, "gateway", name,
                        -1, victim,
                        attrs={"held": 0, "requested_target": dst},
                    )
                    self._tr.emit(
                        "migrate_commit", t_now, "gateway", name,
                        -1, dst,
                        attrs={"donor": victim, "held": 0},
                    )
            # retire the replica: higher shards slide down one slot
            assign = {
                i: (s - 1 if s > victim else s)
                for i, s in sorted(assign.items())
            }
            n_shards -= 1
            shrank += 1
        return assign, n_shards, tuple(rehomed), grew, shrank

    # -- the ramp -----------------------------------------------------
    def run_ramp(
        self,
        phases: Sequence[RampPhase],
        *,
        virtual_dt: float | None = None,
        warmup: bool = True,
    ) -> AutoscaleReport:
        out = AutoscaleReport()
        assign: dict[int, int] = {}
        n_shards = self.min_shards
        t_now = 0.0
        for p, phase in enumerate(phases):
            active = sorted(phase.active)
            for i in active:
                if not 0 <= i < len(self.built.requests):
                    raise ValueError(f"tenant index {i} out of range")
            assign, n_shards, rehomed, grew, shrank = self._plan_epoch(
                active, assign, n_shards, t_now
            )
            sub = self.built.subset(
                tuple(active), name=f"{self.built.scenario.name}.p{p}"
            )
            plan = ShardPlan(
                n_shards=n_shards,
                assignment=tuple(assign[i] for i in active),
            )
            gw = ShardedGateway.from_built(
                sub,
                shards=n_shards,
                plan=plan,
                policy=self.policy,
                seed=self.seed,
                max_dim=self.max_dim,
                trace=self._tr,
                device=self.device,
            )
            report = gw.run(
                phase.duration,
                virtual_dt=virtual_dt,
                warmup=warmup,
                shared_clock=True,
            )
            out.epochs.append(
                EpochResult(
                    phase=p,
                    t_start=t_now,
                    n_shards=n_shards,
                    assignment=dict(assign),
                    report=report,
                    rehomed=rehomed,
                    grew=grew,
                    shrank=shrank,
                )
            )
            t_now += phase.duration
        return out
