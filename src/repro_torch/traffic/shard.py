"""Multi-gateway sharding: one pipeline design, K gateway shards.

One `TrafficGateway` fronts one `PharosServer` — one copy of the
pipeline. To scale a deployment past a single pipeline's Eq. 3 budget,
the `ShardedGateway` runs **K replicas of the same stage set**, each
with its own server, admission controller, backlog monitor and
(optional) rate limiter, and *places* every tenant onto exactly one
shard with a pluggable `PlacementPolicy`:

- `HashByTenant`   — stateless: ``crc32(name) % K``. No coordination,
  stable under tenant churn, blind to load.
- `LeastLoaded`    — greedy: each tenant (in request order) goes to the
  shard whose post-placement **max stage utilization** is smallest —
  the classic balls-into-bins balancer on the Eq. 2 vectors.
- `SlackAware`     — greedy on `stage_slacks`: the tenant goes to the
  shard that keeps the most slack on the stages the tenant *actually
  uses* (its active segments), ignoring stages it never touches — the
  placement analogue of the admission layer's headroom report.

Each shard then re-runs the O(stages) Eq. 3 admission over its own
tenant subset, so every shard's schedulability verdict is **bit-exact**
against a full `srt_schedulable` re-analysis of that subset (the same
`AdmissionController.verify` contract the unsharded gateway holds), and
with ``K == 1`` the sharded run reproduces the unsharded
`TrafficGateway` report bit-for-bit — placement degenerates to the
identity and the single shard is built through the very same
constructor path (`built_gateway`).

Stepping modes — `run(shared_clock=...)`:

- **shared-clock co-simulation** (default): all K shards advance in
  lockstep on one global event timeline — each iteration sweeps due
  releases on every shard, steps every server once, and advances every
  shard's clock to the globally earliest next event. For
  non-interacting shards this is observably identical to independent
  clocks (each shard's own events are a subset of the global event
  set, and a cost-model server stepped mid-window is a no-op — see
  ``tests/test_shard.py``'s differential fuzz leg), but it gives
  cross-shard controllers (live migration, `repro_torch.traffic.migration`)
  a consistent "now" to act in.
- **independent clocks** (``shared_clock=False``): the original
  deployment semantics — each shard's gateway runs to the horizon on
  its own `VirtualClock`, one after the other.

Elastic mode — `from_built(..., elastic=True)` builds every shard's
server over the *full* scenario (so any tenant can be re-homed onto
any shard mid-run) but activates only the planned members per shard:
admission, release schedules and backlog monitoring are restricted to
active members exactly as in the subset-built path. This is the
substrate `MigrationController` and `repro_torch.traffic.autoscale` operate
on.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Protocol, Sequence

import numpy as np

from repro_torch.core.rt.batch import batched_tenant_utilizations
from repro_torch.core.rt.schedulability import EPS, stage_slacks
from repro_torch.core.rt.task import LayerDesc, SegmentTable, Task, TaskSet, Workload
from repro_torch.traffic.admission import AdmissionController, TaskRequest
from repro_torch.traffic.gateway import GatewayReport, TenantStats, TrafficGateway
from repro_torch.traffic.ratelimit import RateLimiter
from repro_torch.traffic.shedding import BacklogMonitor, SheddingPolicy


# ---------------------------------------------------------------------------
# placement policies
# ---------------------------------------------------------------------------
class PlacementPolicy(Protocol):
    name: str

    def place(
        self,
        requests: Sequence[TaskRequest],
        n_shards: int,
        *,
        overheads: Sequence[float],
        preemptive: bool,
    ) -> list[int]:
        """Tenant index -> shard index assignment."""
        ...


def _util_vector(req, overheads, preemptive):
    return req.utilization(tuple(overheads), preemptive)


def _tenant_util_matrix(requests, overheads, preemptive) -> np.ndarray:
    """``[T, K]`` Eq. 2 contribution rows, one per tenant — the shared
    precomputation of the vectorized placement policies. Row ``t`` is
    bit-identical to ``requests[t].utilization(overheads, preemptive)``
    (`batched_tenant_utilizations` contract)."""
    return batched_tenant_utilizations(
        [list(r.base) for r in requests],
        list(overheads),
        [r.period for r in requests],
        preemptive,
    )


@dataclass(frozen=True)
class HashByTenant:
    """Stateless ``crc32(tenant name) % K`` placement."""

    name: str = "hash_by_tenant"

    def place(self, requests, n_shards, *, overheads, preemptive):
        return [
            zlib.crc32(r.name.encode()) % n_shards for r in requests
        ]


@dataclass(frozen=True)
class LeastLoaded:
    """Greedy min-max-utilization placement on the Eq. 2 vectors.

    The greedy walk is tenant-sequential by definition (each decision
    feeds the next), but each tenant's scoring sweep over all K shards
    is one array pass: post-placement peaks for every shard at once,
    first-argmin shard wins. Bit-identical to the per-shard Python
    loop: the per-shard load vectors accumulate the same IEEE additions
    in the same order, ``max``/``argmin`` are value- and tie-exact
    (argmin returns the first minimum, matching ``min(range(K),
    key=(peak, s))``)."""

    name: str = "least_loaded"

    def place(self, requests, n_shards, *, overheads, preemptive):
        if not requests:
            return []
        du = _tenant_util_matrix(requests, overheads, preemptive)
        loads = np.zeros((n_shards, len(overheads)))
        out = []
        for t in range(len(requests)):
            after = loads + du[t][None, :]
            best = int(after.max(axis=1).argmin())
            out.append(best)
            loads[best] = after[best]
        return out


def _placement_analysis_view(reqs, overheads):
    """(SegmentTable, TaskSet) of already-placed requests for
    `stage_slacks` — the same materialization `AdmissionController.
    to_analysis` builds."""
    table = SegmentTable(
        base=[list(r.base) for r in reqs], overhead=list(overheads)
    )
    w = Workload("placement", (LayerDesc("seg", 1, 1, 1),))
    ts = TaskSet(
        tasks=tuple(
            Task(workload=w, period=r.period, deadline=r.deadline, name=r.name)
            for r in reqs
        )
    )
    return table, ts


@dataclass(frozen=True)
class SlackAware:
    """Greedy placement maximizing the post-placement `stage_slacks`
    minimum over the tenant's *active* stages (stages it never touches
    do not vote).

    Scores all K shards per tenant in one array pass instead of
    materializing a fresh (`SegmentTable`, `TaskSet`) per
    (tenant, shard) pair and re-summing Eq. 2 from scratch — the
    O(tenants × shards × placed) walk this replaces. Bit-identical to
    the scalar greedy: per-shard utilization accumulates the same
    additions in placement order (matching `stage_utilization`'s
    task-order ``sum`` over ``placed[s] + [r]``), the slack clamp is
    the scalar EPS band, and first-argmax over min-slack matches
    ``max(range(K), key=(min_slack, -s))`` — smallest shard index on
    ties."""

    name: str = "slack_aware"

    def place(self, requests, n_shards, *, overheads, preemptive):
        if not requests:
            return []
        du = _tenant_util_matrix(requests, overheads, preemptive)
        util = np.zeros((n_shards, len(overheads)))
        out = []
        for t, r in enumerate(requests):
            active = [k for k, b in enumerate(r.base) if b > 0.0]
            after = util + du[t][None, :]
            slacks = 1.0 - after
            slacks = np.where(
                (slacks < 0.0) & (slacks >= -EPS), 0.0, slacks
            )
            best = int(slacks[:, active].min(axis=1).argmax())
            out.append(best)
            util[best] = after[best]
        return out


PLACEMENTS = {
    p.name: p for p in (HashByTenant(), LeastLoaded(), SlackAware())
}


def get_placement(name: str) -> PlacementPolicy:
    try:
        return PLACEMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown placement policy {name!r}; have {sorted(PLACEMENTS)}"
        ) from None


# ---------------------------------------------------------------------------
# the plan and the merged report
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardPlan:
    """Tenant -> shard assignment plus the per-shard member lists
    (original tenant indices, ascending — order-preserving, which is
    what makes the K=1 identity exact)."""

    n_shards: int
    assignment: tuple[int, ...]

    @property
    def members(self) -> tuple[tuple[int, ...], ...]:
        return tuple(
            tuple(i for i, s in enumerate(self.assignment) if s == k)
            for k in range(self.n_shards)
        )


@dataclass(frozen=True)
class ShardHeadroom:
    """Remaining capacity of one shard replica — the operator's
    "how much more fits on this copy of the pipeline" answer.

    ``stage_slacks`` follows `repro_torch.core.rt.stage_slacks` semantics
    (``1 - u^k`` with the tiny-negative clamp); `max_admissible_rate`
    is the `repro_torch.core.rt.max_admissible_rate` bound evaluated against
    this shard's admitted set."""

    shard: int
    tenants: tuple[str, ...]
    stage_utilizations: tuple[float, ...]
    stage_slacks: tuple[float, ...]
    #: per admitted tenant: max rate multiplier keeping Eq. 3
    tenant_rate_multipliers: dict[str, float]
    overheads: tuple[float, ...]
    preemptive: bool

    @property
    def bottleneck(self) -> int:
        return int(
            max(
                range(len(self.stage_utilizations)),
                key=self.stage_utilizations.__getitem__,
            )
        )

    def max_admissible_rate(self, base: Sequence[float]) -> float:
        """Largest release rate (jobs/s) of a probe task with per-stage
        WCETs ``base`` this shard can still absorb under Eq. 3."""
        if len(base) != len(self.stage_slacks):
            raise ValueError("probe WCET vector length != n_stages")
        rate = float("inf")
        for k, b in enumerate(base):
            if b <= 0.0:
                continue
            e = b + (self.overheads[k] if self.preemptive else 0.0)
            rate = min(rate, max(0.0, self.stage_slacks[k]) / e)
        return rate


def _shard_headroom(shard: int, gw: TrafficGateway) -> ShardHeadroom:
    """Headroom snapshot of one shard from its admission controller."""
    from repro_torch.core.rt.schedulability import (
        stage_slacks as rt_stage_slacks,
    )

    ctl = gw.admission
    view = ctl.to_analysis()
    if view is None:
        slacks = tuple(1.0 for _ in range(ctl.n_stages))
    else:
        table, ts = view
        slacks = tuple(rt_stage_slacks(table, ts, ctl.preemptive))
    hr = ctl.headroom_report()
    return ShardHeadroom(
        shard=shard,
        tenants=tuple(ctl.names()),
        stage_utilizations=ctl.utilizations(),
        stage_slacks=slacks,
        tenant_rate_multipliers=dict(hr.tenant_rate_multipliers),
        overheads=ctl.overheads,
        preemptive=ctl.preemptive,
    )


@dataclass(frozen=True)
class ShardedReport:
    """Per-shard `GatewayReport`s plus the plan that produced them.
    Empty shards carry ``None``.

    Aggregate totals are computed once on first access and memoized
    (the report is a finished-run snapshot — per-tenant stats no longer
    change), so a benchmark polling ``total_released`` per batch reads
    three cached ints instead of re-walking K×T tenant stat rows."""

    plan: ShardPlan
    reports: tuple[GatewayReport | None, ...]
    #: per-shard remaining capacity (`ShardHeadroom`; None for empty
    #: shards) — the ROADMAP's shard-aware headroom report
    headrooms: tuple[ShardHeadroom | None, ...] = ()

    def tenant(self, name: str) -> TenantStats:
        for rep in self.reports:
            if rep is None:
                continue
            for t in rep.tenants:
                if t.name == name:
                    return t
        raise KeyError(name)

    def shard_of(self, name: str) -> int:
        for k, rep in enumerate(self.reports):
            if rep is not None and any(t.name == name for t in rep.tenants):
                return k
        raise KeyError(name)

    @property
    def tenants(self) -> tuple[TenantStats, ...]:
        return tuple(
            t
            for rep in self.reports
            if rep is not None
            for t in rep.tenants
        )

    def admitted_count(self) -> int:
        return sum(1 for t in self.tenants if t.admitted)

    def _totals(self) -> tuple[int, int, int]:
        """(shed, rate_limited, released) in one walk, memoized.
        Frozen dataclasses still own their ``__dict__``, so the cache
        rides along without thawing the report."""
        cached = self.__dict__.get("_totals_cache")
        if cached is None:
            shed = limited = released = 0
            for r in self.reports:
                if r is None:
                    continue
                shed += r.total_shed()
                limited += r.total_rate_limited()
                released += r.total_released()
            cached = (shed, limited, released)
            object.__setattr__(self, "_totals_cache", cached)
        return cached

    def total_shed(self) -> int:
        return self._totals()[0]

    def total_rate_limited(self) -> int:
        return self._totals()[1]

    def total_released(self) -> int:
        return self._totals()[2]


def plan_shards(
    requests: Sequence[TaskRequest],
    shards: int,
    placement: "PlacementPolicy | str | None" = None,
    *,
    n_stages: int,
    preemptive: bool,
) -> tuple[PlacementPolicy, ShardPlan]:
    """Resolve a placement policy (by name or instance; default
    `HashByTenant`) and compute the tenant -> shard plan. This is the
    single plan-construction path shared by `ShardedGateway.from_built`
    and the JAX package's conformance harness's ``run_sharded_case``
    (the harness is not ported yet) — what the harness checks is, by
    construction, the plan the gateway runs."""
    if shards < 1:
        raise ValueError("need at least one shard")
    if isinstance(placement, str):
        placement = get_placement(placement)
    placement = placement or HashByTenant()
    assignment = placement.place(
        requests,
        shards,
        overheads=[0.0] * n_stages,
        preemptive=preemptive,
    )
    return placement, ShardPlan(
        n_shards=shards, assignment=tuple(assignment)
    )


# ---------------------------------------------------------------------------
# building one gateway (the shared constructor path)
# ---------------------------------------------------------------------------
def built_gateway(
    built,
    *,
    policy: str | None = None,
    seed: int = 0,
    max_dim: int | None = 512,
    shedding: SheddingPolicy | None = None,
    monitor: BacklogMonitor | None = None,
    ratelimit: RateLimiter | None = None,
    make_modes=None,
    trace=None,
    shard: int = -1,
    active: Sequence[int] | None = None,
    device="cuda",
) -> TrafficGateway:
    """One deterministic cost-model `TrafficGateway` over a
    `BuiltScenario` (or a `BuiltScenario.subset`), on its own
    `VirtualClock`: the server executes surrogate GEMM windows while
    virtual time is charged per window from the conformance
    `CostModel`'s exec-model WCETs. This is the single constructor path
    both the unsharded gateway and every `ShardedGateway` shard go
    through — K=1 equivalence is structural, not coincidental.

    ``trace`` (a `repro_torch.obs.TraceRecorder`) is handed to both the
    gateway and its server; ``shard`` tags every emitted event with the
    replica index (-1: unsharded). ``make_modes(admission, requests)``
    builds a fresh `repro_torch.traffic.modes.ModeController` over the
    gateway's own admission controller after it is constructed — the
    mixed-criticality analogue of ``monitor``/``ratelimit``.

    ``device`` holds the server's weights, inputs and accumulators: on
    a CUDA device every window is one launch of the window kernel, on
    the CPU its plain version. The weights are drawn on the CPU from
    ``seed`` whatever the device, so one seed serves the same chains
    everywhere.
    """
    from repro_torch.pipeline.serve import PharosServer
    from repro_torch.traffic.clock import VirtualClock

    policy = policy or built.scenario.policy
    serve_tasks, _reqs, _arr = built.serve_bundle(
        period_scale=1.0, seed=seed, max_dim=max_dim, device=device
    )
    cost_model = built.conformance_cost_model(serve_tasks)
    clk = VirtualClock()
    server = PharosServer(
        serve_tasks,
        built.design.n_stages,
        policy=policy,
        cost_model=cost_model,
        clock=clk.now,
        sleep=clk.sleep,
        trace=trace,
        trace_shard=shard,
        device=device,
    )
    admission = AdmissionController(
        [0.0] * built.design.n_stages,
        preemptive=(policy == "edf"),
    )
    requests = list(built.requests)
    modes = make_modes(admission, requests) if make_modes else None
    return TrafficGateway(
        server,
        admission,
        requests,
        list(built.arrivals),
        shedding=shedding,
        monitor=monitor,
        ratelimit=ratelimit,
        modes=modes,
        clock=clk,
        trace=trace,
        shard=shard,
        active=active,
    )


# ---------------------------------------------------------------------------
# the sharded gateway
# ---------------------------------------------------------------------------
class ShardedGateway:
    """K independent `TrafficGateway` shards over one pipeline design.

    ``gateways[k]`` serves the tenants ``plan.members[k]`` (original
    indices, order preserved); empty shards hold ``None``. Use
    `from_built` for the batteries-included scenario path, or construct
    directly from pre-built per-shard gateways for custom wiring.
    """

    def __init__(
        self,
        plan: ShardPlan,
        gateways: Sequence[TrafficGateway | None],
        names: Sequence[str],
        *,
        elastic: bool = False,
    ):
        if len(gateways) != plan.n_shards:
            raise ValueError("one gateway (or None) per shard required")
        self.plan = plan
        self.gateways = list(gateways)
        self.names = list(names)
        #: built over the full scenario per shard (tenants re-homeable)?
        self.elastic = elastic

    @classmethod
    def from_built(
        cls,
        built,
        *,
        shards: int,
        placement: PlacementPolicy | str | None = None,
        policy: str | None = None,
        seed: int = 0,
        max_dim: int | None = 512,
        shedding: SheddingPolicy | None = None,
        make_monitor=None,
        make_ratelimit=None,
        make_modes=None,
        trace=None,
        elastic: bool = False,
        plan: ShardPlan | None = None,
        device="cuda",
    ) -> "ShardedGateway":
        """Place a `BuiltScenario`'s tenants across ``shards`` replicas.

        ``make_monitor()`` / ``make_ratelimit(sub_requests)`` /
        ``make_modes(admission, sub_requests)`` build one fresh
        `BacklogMonitor` / `RateLimiter` / `ModeController` per shard
        (monitors, buckets and mode state are stateful — shards must
        not share them; each shard runs its own mode machine over its
        own tenant subset).

        ``trace`` (a `repro_torch.obs.TraceRecorder`) is shared by every
        shard's gateway and server — events carry the shard index —
        and receives one ``place`` event per tenant recording the
        placement decision.

        ``elastic=True`` builds each shard's server over the *full*
        scenario with only the planned members active, so tenants can
        later be re-homed across shards by a `MigrationController`
        (subset-built servers have fixed task lists and cannot serve a
        migrated-in tenant). Empty shards still get a (fully inactive)
        gateway in elastic mode — they are valid migration targets.

        ``plan`` overrides placement entirely with an explicit
        `ShardPlan` (assignment indices into ``built.requests``) — the
        autoscaler's path, where the plan is carried over from the
        previous epoch rather than recomputed.

        ``device`` is every shard's server device (`built_gateway`).
        """
        policy = policy or built.scenario.policy
        if plan is not None:
            if plan.n_shards != shards or len(plan.assignment) != len(
                built.requests
            ):
                raise ValueError("explicit plan does not match scenario")
            placement_name = "explicit"
        else:
            _placement, plan = plan_shards(
                built.requests,
                shards,
                placement,
                n_stages=built.design.n_stages,
                preemptive=(policy == "edf"),
            )
            placement_name = _placement.name
        if trace is not None and getattr(trace, "enabled", False):
            for r, k in zip(built.requests, plan.assignment):
                trace.emit(
                    "place", 0.0, "gateway", r.name, -1, k,
                    attrs={"placement": placement_name},
                )
        gateways: list[TrafficGateway | None] = []
        for k, members in enumerate(plan.members):
            if not members and not elastic:
                gateways.append(None)
                continue
            sub = built if elastic else built.subset(members)
            gateways.append(
                built_gateway(
                    sub,
                    policy=policy,
                    seed=seed,
                    max_dim=max_dim,
                    shedding=shedding,
                    monitor=make_monitor() if make_monitor else None,
                    ratelimit=(
                        make_ratelimit(sub.requests)
                        if make_ratelimit
                        else None
                    ),
                    make_modes=make_modes,
                    trace=trace,
                    shard=k,
                    active=members if elastic else None,
                    device=device,
                )
            )
        return cls(
            plan,
            gateways,
            [r.name for r in built.requests],
            elastic=elastic,
        )

    def open(self):
        """Run tenancy admission on every shard; returns the flattened
        decision list (shard-major, request order within each shard)."""
        decisions = []
        for gw in self.gateways:
            if gw is not None:
                decisions.extend(gw.open())
        return decisions

    def verify(self) -> bool:
        """Every shard's cached Eq. 3 verdict equals a full
        `srt_schedulable` re-analysis of its admitted subset."""
        return all(
            gw.admission.verify()
            for gw in self.gateways
            if gw is not None
        )

    def headroom(self) -> tuple[ShardHeadroom | None, ...]:
        """Per-shard remaining-capacity snapshot, computed fresh from
        each shard's *live* admission controller (run `open` first —
        before admission every shard trivially reports full slack).
        Always recompute through this method after a mid-run
        release/admit; a snapshot taken earlier still scores departed
        tenants' load (the headroom-staleness pitfall)."""
        return tuple(
            _shard_headroom(k, gw) if gw is not None else None
            for k, gw in enumerate(self.gateways)
        )

    def shard_of_tenant(self, i: int) -> int | None:
        """Shard currently serving global tenant index ``i`` (live
        membership, not the static plan), or None if nowhere active."""
        for k, gw in enumerate(self.gateways):
            if gw is not None and gw.serves(i):
                return k
        return None

    def run(
        self,
        horizon_s: float,
        *,
        virtual_dt: float | None = None,
        warmup: bool = True,
        shared_clock: bool = True,
        controller=None,
    ) -> ShardedReport:
        """Drive every shard to ``horizon_s``.

        ``shared_clock=True`` (default) co-simulates all K shards on
        one global event timeline; ``controller`` (duck-typed:
        ``bind(sharded)`` + ``on_tick(rel_now)``, e.g. a
        `repro_torch.traffic.migration.MigrationController`) is invoked once
        per global iteration after the due-release sweep.
        ``shared_clock=False`` restores the original independent-clock
        semantics (no controller possible — there is no global now)."""
        if not shared_clock:
            if controller is not None:
                raise ValueError(
                    "cross-shard controllers require shared_clock=True"
                )
            reports = tuple(
                gw.run(horizon_s, virtual_dt=virtual_dt, warmup=warmup)
                if gw is not None
                else None
                for gw in self.gateways
            )
            return ShardedReport(
                plan=self.plan, reports=reports, headrooms=self.headroom()
            )

        from repro_torch.pipeline.serve import DEGENERATE_SAFETY_TICK_S

        live = [gw for gw in self.gateways if gw is not None]
        if not live:
            return ShardedReport(
                plan=self.plan,
                reports=tuple(None for _ in self.gateways),
                headrooms=self.headroom(),
            )
        for gw in live:
            if not hasattr(gw.clock, "advance"):
                raise ValueError(
                    "shared-clock co-simulation needs virtual clocks"
                )
        for gw in live:
            gw.begin_run(horizon_s, virtual_dt=virtual_dt, warmup=warmup)
        if controller is not None:
            controller.bind(self)
        while True:
            rels = [gw.release_due() for gw in live]
            if controller is not None:
                controller.on_tick(max(rels))
                # a handover may have injected new releases due now
                rels = [gw.release_due() for gw in live]
            if all(r >= horizon_s for r in rels):
                break
            ran_any = False
            for gw in live:
                ran_any = gw.server.step() or ran_any
            # the globally earliest next event; every shard's clock
            # advances to it in lockstep. A shard woken at another
            # shard's event time is a no-op: no due arrivals, and a
            # cost-model server stepped mid-window does nothing.
            nxt = min(gw.next_event() for gw in live)
            now = live[0].clock.now()
            if nxt > now:
                for gw in live:
                    gw.clock.advance(nxt - now)
            elif not ran_any:
                tick = max(
                    max(gw._run.virtual_dt for gw in live),
                    DEGENERATE_SAFETY_TICK_S,
                )
                for gw in live:
                    gw.clock.advance(tick)
        reports = tuple(
            gw.finish_run() if gw is not None else None
            for gw in self.gateways
        )
        return ShardedReport(
            plan=self.plan, reports=reports, headrooms=self.headroom()
        )
