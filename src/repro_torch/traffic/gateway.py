"""`TrafficGateway`: the admission-controlled front door of a
`PharosServer`.

The gateway owns the traffic side of serving: each tenant (one
`ServeTask` on the server) comes with a `TaskRequest` (its analysis
contract) and an `ArrivalProcess` (its actual traffic). At ``run``:

1. every tenant is submitted to the `AdmissionController` — rejected
   tenants release nothing (their traffic is refused up front);
2. admitted tenants' arrival traces are merged into one release
   schedule; each due release first spends a token of its tenant's
   `RateLimiter` bucket (if one is armed — a dry bucket refuses the
   release as ``rate_limited``, trimming live traffic back to the
   provisioned contract), is then checked against the `BacklogMonitor`
   and, while observed backlog contradicts the analysis, routed through
   the `SheddingPolicy` (submit / drop / degrade-to-best-effort) — or,
   with ``modes=`` armed instead, through the mixed-criticality
   `repro_torch.traffic.modes.ModeController`: overload commits a HI-mode
   switch (Eq. 3 re-proved for the HI survivor set first, a
   ``mode_switch`` trace event emitted), LO releases are shed/demoted
   and pay a tightened token-bucket cost while the mode holds, and the
   controller switches back when backlog drains;
3. the server is stepped between releases. With a `VirtualClock` the
   whole run is deterministic: when the server carries a
   `repro_torch.conformance.CostModel` the clock jumps event-to-event (every
   executed tile window occupies its stage for the model's per-window
   WCET); otherwise each serving iteration charges the legacy
   ``virtual_dt`` quantum, and idle gaps fast-forward to the next
   arrival.

Clock semantics: the gateway and server must share one timebase —
construct the server with ``clock=clk.now, sleep=clk.sleep`` and hand
the same ``clk`` here. On a `WallClock` the release loop *polls* real
time (releases are stamped with their nominal schedule time; polling
delay shows up as `TenantStats.release_jitter`, not as response time
skew); on a `VirtualClock` the loop *drives* time and releases land
exactly on schedule.

Preemption model: the gateway never preempts anything itself — it only
decides, per release, whether a job enters at all (and in which service
class). Preemption granularity belongs to the server below: FIFO runs
every queued window to completion, EDF preempts between tile windows
only (`pipeline.serve`), which is the limited-preemption semantics the
DES (``preemption="window"``) and the blocking-aware analysis bound
model — see the JAX package's `repro.conformance` for the harness that holds all of them
to it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

from repro_torch.pipeline.serve import DEGENERATE_SAFETY_TICK_S, PharosServer
from repro_torch.traffic.admission import (
    AdmissionController,
    AdmissionDecision,
    TaskRequest,
)
from repro_torch.traffic.arrival import ArrivalProcess, merge_arrivals
from repro_torch.traffic.clock import WallClock
from repro_torch.traffic.modes import ModeController
from repro_torch.traffic.ratelimit import RateLimiter
from repro_torch.traffic.shedding import (
    BEST_EFFORT,
    DROP,
    BacklogMonitor,
    SheddingPolicy,
)


@dataclass
class TenantStats:
    name: str
    admitted: bool
    scheduled: int = 0  # arrivals inside the horizon
    released: int = 0  # submitted with a guarantee
    degraded: int = 0  # submitted best-effort
    shed: int = 0  # dropped by the shedding policy
    rate_limited: int = 0  # refused by a dry token bucket
    release_jitter: list[float] = field(default_factory=list)

    def max_jitter(self) -> float:
        return max(self.release_jitter) if self.release_jitter else 0.0


@dataclass
class GatewayReport:
    tenants: list[TenantStats]
    decisions: list[AdmissionDecision]
    server_report: object  # ServerReport
    #: committed mixed-criticality transitions ``(t, mode, survivors)``
    #: (empty without a `ModeController` armed)
    mode_switches: list[tuple[float, str, tuple[str, ...]]] = field(
        default_factory=list
    )

    def tenant(self, name: str) -> TenantStats:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def total_shed(self) -> int:
        return sum(t.shed for t in self.tenants)

    def total_rate_limited(self) -> int:
        return sum(t.rate_limited for t in self.tenants)

    def total_released(self) -> int:
        return sum(t.released + t.degraded for t in self.tenants)


@dataclass
class _RunState:
    """Release-loop state between `begin_run` and `finish_run` — what the
    shared-clock co-simulation driver (the JAX package's `repro.traffic.shard`) advances
    one event at a time across K gateways."""

    horizon_s: float
    stats: list[TenantStats]
    #: merged release schedule, ``(t_rel, tenant_index)`` ascending;
    #: entries at ``pos`` and beyond are still in the future
    sched: list[tuple[float, int]]
    pos: int
    t0: float
    virtual: bool
    cost_driven: bool
    virtual_dt: float


class TrafficGateway:
    def __init__(
        self,
        server: PharosServer,
        admission: AdmissionController,
        requests: Sequence[TaskRequest],
        arrivals: Sequence[ArrivalProcess],
        *,
        shedding: SheddingPolicy | None = None,
        monitor: BacklogMonitor | None = None,
        ratelimit: RateLimiter | None = None,
        modes: ModeController | None = None,
        clock=None,
        trace=None,
        shard: int = -1,
        active: Sequence[int] | None = None,
    ):
        if not (len(server.tasks) == len(requests) == len(arrivals)):
            raise ValueError(
                "server tasks / requests / arrivals must align 1:1"
            )
        if ratelimit is not None and len(ratelimit) != len(requests):
            raise ValueError("rate limiter buckets must align 1:1 with tenants")
        if modes is not None and shedding is not None:
            raise ValueError(
                "arm either per-job shedding or mixed-criticality modes, "
                "not both — one overload authority per gateway"
            )
        self.server = server
        self.admission = admission
        self.requests = list(requests)
        self.arrivals = list(arrivals)
        self.shedding = shedding
        self.monitor = monitor or BacklogMonitor()
        self.ratelimit = ratelimit
        self.modes = modes
        #: committed mode transitions, ``(t, mode, survivors)`` in
        #: commit order (mirrors `SimResult.mode_switches`)
        self.mode_switches: list[tuple[float, str, tuple[str, ...]]] = []
        self.clock = clock or WallClock()
        # schedule-trace handle (duck-typed `repro.obs.TraceRecorder`), resolved
        # once: disabled tracing emits nothing and costs nothing.
        # ``shard`` tags every event when this gateway is one
        # `ShardedGateway` replica.
        self._tr = (
            trace
            if trace is not None and getattr(trace, "enabled", False)
            else None
        )
        self._tr_shard = shard
        self._admitted_idx: list[int] | None = None
        self._limits: list[int] = []
        # elastic membership: ``active`` names the tenant indices this
        # gateway initially serves (the rest are *present* — the server
        # knows their task geometry — but admit nothing and release
        # nothing until `admit_tenant` activates them mid-run). None
        # keeps the classic fixed-tenancy gateway: every request is a
        # member and mid-run churn is not expected.
        if active is not None:
            bad = [i for i in active if not 0 <= i < len(self.requests)]
            if bad:
                raise ValueError(f"active indices out of range: {bad}")
        self._elastic = active is not None
        self._active: set[int] = (
            set(active) if active is not None else set(range(len(requests)))
        )
        self._ever_active: set[int] = set(self._active)
        self._run: _RunState | None = None

    # -- phase 1: tenancy admission -----------------------------------
    def open(self) -> list[AdmissionDecision]:
        """Run admission for every (active) tenant (idempotent)."""
        if self._admitted_idx is not None:
            return self.admission.decisions
        self._admitted_idx = []
        for i, req in enumerate(self.requests):
            if self._elastic and i not in self._active:
                continue
            dec = self.admission.admit(req)
            if dec.admitted:
                self._admitted_idx.append(i)
            if self._tr is not None:
                self._tr.emit(
                    "admit" if dec.admitted else "reject",
                    self.clock.now(), "gateway", req.name,
                    -1, self._tr_shard,
                    attrs={"max_util": dec.max_util, "reason": dec.reason},
                )
        self._refresh_limits()
        return self.admission.decisions

    def _refresh_limits(self) -> None:
        """Recompute backlog limits from the *current* admitted set's
        response bounds. Called at `open` and after every mid-run
        `admit_tenant`/`release_tenant` — limits derived from a stale
        admitted set would make the backlog monitor (and everything
        scoring headroom through it) judge live traffic against a
        departed tenant's interference."""
        bounds = self.admission.response_bounds()
        self._limits = [
            self.monitor.limit_for(
                bounds.get(req.name, float("inf")), req.period
            )
            for req in self.requests
        ]

    # -- elastic membership (live migration / autoscaling) ------------
    def serves(self, i: int) -> bool:
        """Is tenant ``i`` currently an active member of this gateway?"""
        return i in self._active and (
            self._admitted_idx is None or i in self._admitted_idx
        )

    def admit_tenant(self, i: int) -> AdmissionDecision:
        """Mid-run activation of tenant ``i``: run the Eq. 3 admit
        against this gateway's *current* admitted set, and on success
        make the tenant an active member. Backlog limits are recomputed
        from the post-admit bounds (fresh, never stale)."""
        if self._admitted_idx is None:
            self.open()
        dec = self.admission.admit(self.requests[i])
        if self._tr is not None:
            self._tr.emit(
                "admit" if dec.admitted else "reject",
                self.clock.now(), "gateway", self.requests[i].name,
                -1, self._tr_shard,
                attrs={"max_util": dec.max_util, "reason": dec.reason},
            )
        if dec.admitted:
            if i not in self._admitted_idx:
                self._admitted_idx.append(i)
                self._admitted_idx.sort()
            self._active.add(i)
            self._ever_active.add(i)
            self._refresh_limits()
            if self._run is not None:
                self._run.stats[i].admitted = True
        return dec

    def release_tenant(self, i: int) -> TaskRequest:
        """Mid-run release of tenant ``i``: drop its Eq. 3 contribution
        (`AdmissionController.release` rebuilds the utilization cache
        exactly) and deactivate it. Backlog limits are recomputed so no
        later overload verdict or headroom snapshot scores this gateway
        with the departed tenant's load."""
        req = self.admission.release(self.requests[i].name)
        if self._admitted_idx is not None and i in self._admitted_idx:
            self._admitted_idx.remove(i)
        self._active.discard(i)
        self._refresh_limits()
        return req

    def extract_future(self, i: int) -> list[float]:
        """Remove tenant ``i``'s not-yet-due releases from the live
        schedule (drain: stop new releases) and return their nominal
        times (relative to the run's ``t0``, ascending)."""
        st = self._require_run()
        held = [t for t, j in st.sched[st.pos:] if j == i]
        st.sched[st.pos:] = [e for e in st.sched[st.pos:] if e[1] != i]
        st.stats[i].scheduled -= len(held)
        return held

    def inject_future(self, i: int, times: Iterable[float]) -> None:
        """Merge releases for tenant ``i`` (times relative to the run's
        ``t0``) into the live schedule — the re-home side of a
        migration handover."""
        st = self._require_run()
        ev = [(float(t), i) for t in times]
        st.sched[st.pos:] = sorted(st.sched[st.pos:] + ev)
        st.stats[i].scheduled += len(ev)

    def _require_run(self) -> _RunState:
        if self._run is None:
            raise RuntimeError(
                "no run in progress — begin_run() first"
            )
        return self._run

    # -- phase 2: the release loop ------------------------------------
    # The loop is decomposed into four primitives so that a shared-clock
    # driver (`ShardedGateway.run(shared_clock=True)`) can interleave K
    # gateways event-by-event on one timebase: `begin_run` freezes the
    # run state, `release_due` performs the due-release sweep,
    # `next_event` exposes the earliest future event, `finish_run`
    # assembles the report. `run` composes them and is bit-identical to
    # the pre-decomposition loop.
    def begin_run(
        self,
        horizon_s: float,
        *,
        virtual_dt: float | None = None,
        warmup: bool = True,
    ) -> None:
        """Open, merge arrival schedules and freeze the run state."""
        self.open()
        stats = [
            TenantStats(name=req.name, admitted=(i in self._admitted_idx))
            for i, req in enumerate(self.requests)
        ]
        admitted = list(self._admitted_idx)
        sched = merge_arrivals(
            [self.arrivals[i] for i in admitted], horizon_s
        )
        sched = [(t, admitted[j]) for t, j in sched]
        for _, i in sched:
            stats[i].scheduled += 1

        virtual = hasattr(self.clock, "advance")
        # with a CostModel on the server, virtual time is event-driven
        # (per-window WCETs), not quantized — virtual_dt only survives
        # as a degenerate-progress safety tick
        cost_driven = (
            virtual and getattr(self.server, "cost_model", None) is not None
        )
        if virtual and virtual_dt is None:
            # default serving quantum: a fraction of the tightest
            # analysis period, so even the fastest tenant gets many
            # scheduling opportunities per period
            p_min = min(
                (self.requests[i].period for i in admitted),
                default=1.0,
            )
            virtual_dt = p_min / 20.0
        if warmup:
            self.server.warmup()
        self._run = _RunState(
            horizon_s=horizon_s,
            stats=stats,
            sched=sched,
            pos=0,
            t0=self.clock.now(),
            virtual=virtual,
            cost_driven=cost_driven,
            virtual_dt=virtual_dt if virtual_dt is not None else 0.0,
        )

    def release_due(self) -> float:
        """Release every due arrival; returns elapsed run time.

        Due arrivals are released *before* the caller's horizon check so
        jobs landing between the last tick and the horizon still flow
        through the shedding path — every scheduled arrival ends up
        released, degraded or shed, never silently dropped.

        When a rate limiter is armed (and mixed-criticality modes are
        not — `ModeController.release_cost` can change mid-sweep, so
        those sweeps stay scalar), the whole due batch's token-bucket
        verdicts are computed in one `RateLimiter.allow_many` array
        pass up front. `allow_many` is bit-identical to looping
        `allow` in schedule order, and nothing else in the sweep feeds
        back into bucket state, so the batched sweep reproduces the
        scalar one decision-for-decision."""
        st = self._require_run()
        rel = self.clock.now() - st.t0
        end = st.pos
        n = len(st.sched)
        while end < n and (
            st.sched[end][0] <= rel or rel >= st.horizon_s
        ):
            end += 1
        if end == st.pos:
            return rel
        due = st.sched[st.pos:end]
        st.pos = end
        rl_ok = None
        if (
            self.ratelimit is not None
            and self.modes is None
            and len(due) > 1
        ):
            rl_ok = self.ratelimit.allow_many(
                [st.t0 + t for t, _ in due], [i for _, i in due]
            )
        for j, (sched_t, i) in enumerate(due):
            self._release(
                i,
                st.t0 + sched_t,
                max(0.0, rel - sched_t),
                st.stats,
                rl_allowed=None if rl_ok is None else bool(rl_ok[j]),
            )
        return rel

    def next_event(self) -> float:
        """Earliest future event on this gateway's timeline (absolute
        clock time): next modeled window boundary, next scheduled
        arrival, or the horizon — whichever comes first."""
        st = self._require_run()
        nxt = self.server.next_completion_time()
        if st.pos < len(st.sched):
            nxt = min(nxt, st.t0 + st.sched[st.pos][0])
        return min(nxt, st.t0 + st.horizon_s)

    def finish_run(self) -> GatewayReport:
        """Finalize the server report and close the run. Elastic
        gateways report only ever-active tenants (the rest were never
        members here — their stats rows belong to other shards)."""
        st = self._require_run()
        self._run = None
        tenants = (
            [st.stats[i] for i in sorted(self._ever_active)]
            if self._elastic
            else st.stats
        )
        return GatewayReport(
            tenants=tenants,
            decisions=list(self.admission.decisions),
            server_report=self.server.finalize_report(self.clock.now()),
            mode_switches=list(self.mode_switches),
        )

    def run(
        self,
        horizon_s: float,
        *,
        virtual_dt: float | None = None,
        warmup: bool = True,
    ) -> GatewayReport:
        self.begin_run(horizon_s, virtual_dt=virtual_dt, warmup=warmup)
        st = self._run
        while True:
            rel = self.release_due()
            if rel >= horizon_s:
                break
            ran = self.server.step()
            if st.cost_driven:
                # advance to the next modeled window boundary or the
                # next scheduled arrival, whichever comes first
                nxt = self.next_event()
                now2 = self.clock.now()
                if nxt > now2:
                    self.clock.advance(nxt - now2)
                elif not ran:
                    # degenerate safety: no progress and no future
                    # event — force time forward so the loop terminates
                    # even with a zero serving quantum
                    self.clock.advance(
                        max(st.virtual_dt, DEGENERATE_SAFETY_TICK_S)
                    )
            elif st.virtual:
                if not ran and st.pos < len(st.sched):
                    # idle: fast-forward to the next arrival
                    self.clock.advance(
                        max(st.virtual_dt, st.sched[st.pos][0] - rel)
                    )
                else:
                    self.clock.advance(st.virtual_dt)
            elif not ran:
                self.clock.sleep(1e-4)
        return self.finish_run()

    def _release(
        self,
        i: int,
        release_time: float,
        jitter: float,
        stats: list[TenantStats],
        rl_allowed: bool | None = None,
    ) -> None:
        # the token bucket polices the traffic contract before anything
        # else sees the release: a dry bucket refuses it outright
        # (lazily refilled from the nominal release timestamp, so
        # virtual and wall runs decide identically). In HI mode the
        # ModeController tightens LO tenants' buckets by charging
        # `release_cost` tokens per release instead of one.
        # ``rl_allowed`` carries a verdict `release_due` already
        # computed in its batched `allow_many` pass (bucket state is
        # already charged); None means decide here, scalar.
        if self.ratelimit is not None:
            allowed = (
                rl_allowed
                if rl_allowed is not None
                else self.ratelimit.allow(
                    i,
                    release_time,
                    cost=(
                        self.modes.release_cost(i)
                        if self.modes is not None
                        else 1.0
                    ),
                )
            )
            if not allowed:
                stats[i].rate_limited += 1
                if self._tr is not None:
                    self._tr.emit(
                        "rate_limited", self.clock.now(), "gateway",
                        self.requests[i].name, -1, self._tr_shard,
                        release=release_time,
                    )
                return
        # refresh overload state for every admitted tenant (pending
        # counts change between releases as jobs complete)
        if self.modes is not None:
            # the mode controller owns hysteresis (its monitor) *and*
            # the per-release verdict; transitions it commits during
            # the sweep are stamped with the gateway clock and emitted
            # as mode_switch events
            for j in self._admitted_idx:
                self.modes.observe(j, self.server.pending(j))
            for sw in self.modes.drain_events():
                now = self.clock.now()
                self.mode_switches.append((now, sw.mode, sw.survivors))
                if self._tr is not None:
                    self._tr.emit(
                        "mode_switch", now, "gateway", "",
                        -1, self._tr_shard,
                        attrs={
                            "mode": sw.mode,
                            "survivors": sw.survivors,
                            "schedulable": sw.schedulable,
                        },
                    )
            overloaded = [
                j
                for j in self._admitted_idx
                if self.modes.engaged.get(j)
            ]
            verdict = "submit"
            if overloaded:
                verdict = self.modes.classify(
                    i, overloaded, self.admission, self.requests
                )
        else:
            for j in self._admitted_idx:
                self.monitor.observe(
                    j, self.server.pending(j), self._limits[j]
                )
            overloaded = [
                j
                for j in self._admitted_idx
                if self.monitor.engaged.get(j)
            ]
            verdict = "submit"
            if overloaded and self.shedding is not None:
                verdict = self.shedding.classify(
                    i, overloaded, self.admission, self.requests
                )
        if verdict == DROP:
            stats[i].shed += 1
            if self._tr is not None:
                self._tr.emit(
                    "shed", self.clock.now(), "gateway",
                    self.requests[i].name, -1, self._tr_shard,
                    release=release_time,
                )
            return
        best_effort = verdict == BEST_EFFORT
        if self._tr is not None:
            self._tr.emit(
                "release", self.clock.now(), "gateway",
                self.requests[i].name, -1, self._tr_shard,
                release=release_time,
                attrs={"best_effort": True} if best_effort else None,
            )
        self.server.submit(i, release_time, best_effort=best_effort)
        if best_effort:
            stats[i].degraded += 1
        else:
            stats[i].released += 1
        stats[i].release_jitter.append(jitter)
