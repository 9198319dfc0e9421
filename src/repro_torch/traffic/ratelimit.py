"""Per-tenant token/credit rate limiting in front of admission.

Admission (`AdmissionController`) polices the *contract*: a tenant is
admitted iff its provisioned rate fits Eq. 3. The rate limiter polices
the *traffic*: even an admitted tenant only releases jobs while its
token bucket has credit, so a tenant whose live traffic exceeds its
provisioned rate is trimmed back to the contract at the front door —
before the backlog monitor ever has to engage shedding. Shedding stays
the safety net for modeled-vs-real WCET error; the bucket handles the
much more common "client sends too fast" overload.

Model: one token bucket per tenant — capacity ``burst`` tokens,
refilled continuously at ``rate`` tokens/second, one token per release.
Both knobs come from the tenant's `TaskRequest` via
`RateLimiter.for_requests`: the sustained rate is the provisioned rate
(``rate_scale / period``) and the burst is ``burst_periods`` worth of
it. With ``value_weighted=True`` the tenant's shed-value relative to
the mix mean shapes the bucket — the token-bucket analogue of
`ShedByValue`'s ordering — but only ever *downward* on the sustained
rate: a below-mean-value tenant refills slower than its contract,
while an above-mean tenant keeps the contract rate (never more — the
sustained rate is capped at the provisioned rate, so rate-limited
traffic always satisfies the admission premise) and earns its
advantage as extra burst capacity instead.

State layout: the limiter is **array-backed** — rate/burst/token/
timestamp vectors over all tenants, not per-bucket Python objects — so
the gateway's release sweep can refill and charge a whole event batch
in one `allow_many` pass (the million-tenant hot path). The scalar
`allow`/`tokens` API operates on the same vectors and `allow_many` is
bit-identical to looping it (property-tested exact ``==``, duplicate
tenants in a batch included). `TokenBucket` remains as the single-
bucket reference implementation and the `RateLimiter(buckets)`
construction vocabulary; `bucket(i)` returns a live array-backed view
with the same attribute surface.

Everything is deterministic: buckets are refilled lazily from the
release timestamps themselves (no wall clock), so a virtual-time
gateway run is bit-reproducible and a sharded gateway with one shard
reproduces the unsharded decisions exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.traffic.admission import TaskRequest


@dataclass
class TokenBucket:
    """Classic leaky/token bucket: ``burst`` capacity, ``rate``/s refill.

    Starts full (a tenant may burst immediately after admission).
    ``take`` is lazy-refill: credit accrued since the last call is added
    first, then one token is consumed if available. Timestamps must be
    non-decreasing per bucket (the gateway releases in time order);
    a stale timestamp refills nothing rather than going negative.

    This is the scalar *reference* semantics; `RateLimiter` carries the
    same state as per-tenant arrays and reproduces ``take`` bit-for-bit
    (`allow` single events, `allow_many` whole batches).
    """

    rate: float
    burst: float
    tokens: float = -1.0  # sentinel: initialize to full burst
    last: float = 0.0
    granted: int = 0
    denied: int = 0

    def __post_init__(self) -> None:
        if self.rate <= 0.0 or self.burst < 1.0:
            raise ValueError("need rate > 0 and burst >= 1 token")
        if self.tokens < 0.0:
            self.tokens = float(self.burst)

    def peek(self, now: float) -> float:
        """Credit available at ``now`` (no state change)."""
        return min(
            self.burst, self.tokens + max(0.0, now - self.last) * self.rate
        )

    def take(self, now: float, cost: float = 1.0) -> bool:
        """Spend ``cost`` tokens (default one). A cost above 1 is how
        the mixed-criticality gateway tightens a LO tenant's bucket in
        HI mode (`ModeController.release_cost`): the sustained rate
        divides by the cost without rebuilding the bucket."""
        if cost < 1.0:
            raise ValueError("token cost must be >= 1")
        self.tokens = self.peek(now)
        self.last = max(self.last, now)
        if self.tokens >= cost:
            self.tokens -= cost
            self.granted += 1
            return True
        self.denied += 1
        return False


class _BucketView:
    """Live single-tenant window into the limiter's state arrays —
    the `TokenBucket` attribute surface (rate/burst/tokens/last/
    granted/denied + peek/take) bound to index ``i``."""

    __slots__ = ("_rl", "_i")

    def __init__(self, rl: "RateLimiter", i: int):
        self._rl = rl
        self._i = i

    @property
    def rate(self) -> float:
        return float(self._rl._rate[self._i])

    @property
    def burst(self) -> float:
        return float(self._rl._burst[self._i])

    @property
    def tokens(self) -> float:
        return float(self._rl._tokens[self._i])

    @property
    def last(self) -> float:
        return float(self._rl._last[self._i])

    @property
    def granted(self) -> int:
        return int(self._rl._granted[self._i])

    @property
    def denied(self) -> int:
        return int(self._rl._denied[self._i])

    def peek(self, now: float) -> float:
        return self._rl.tokens(self._i, now)

    def take(self, now: float, cost: float = 1.0) -> bool:
        return self._rl.allow(self._i, now, cost)


class _BucketSeq(Sequence):
    """``limiter.buckets`` compatibility shim: index -> `_BucketView`."""

    __slots__ = ("_rl",)

    def __init__(self, rl: "RateLimiter"):
        self._rl = rl

    def __len__(self) -> int:
        return len(self._rl)

    def __getitem__(self, i: int) -> _BucketView:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return _BucketView(self._rl, range(len(self))[i])


class RateLimiter:
    """Per-tenant bucket array the `TrafficGateway` consults per release.

    Index ``i`` addresses the gateway's tenant ``i`` (the same 1:1
    alignment the gateway keeps between requests, arrivals and server
    tasks). ``allow(i, now)`` spends one token of tenant ``i``'s bucket;
    a ``False`` verdict means the release is refused up front (counted
    as ``rate_limited`` in `TenantStats`, never submitted, never shed).
    ``allow_many`` is the vectorized sweep over a whole due-release
    batch — one lazy refill + charge pass over the state arrays.
    """

    def __init__(self, buckets: Sequence[TokenBucket]):
        if len(buckets) == 0:
            raise ValueError("need at least one bucket")
        self._rate = np.array([b.rate for b in buckets], dtype=np.float64)
        self._burst = np.array([b.burst for b in buckets], dtype=np.float64)
        self._tokens = np.array(
            [b.tokens for b in buckets], dtype=np.float64
        )
        self._last = np.array([b.last for b in buckets], dtype=np.float64)
        self._granted = np.array(
            [b.granted for b in buckets], dtype=np.int64
        )
        self._denied = np.array([b.denied for b in buckets], dtype=np.int64)
        self.buckets = _BucketSeq(self)

    @classmethod
    def from_arrays(cls, rates, bursts) -> "RateLimiter":
        """Provision straight from rate/burst vectors — the soak-scale
        path (`benchmarks/scale_bench.py`), which must not build one
        Python `TokenBucket` per tenant at 10^6 tenants. Buckets start
        full, same as the `TokenBucket` constructor."""
        rl = cls.__new__(cls)
        rl._rate = np.asarray(rates, dtype=np.float64).copy()
        rl._burst = np.asarray(bursts, dtype=np.float64).copy()
        if rl._rate.ndim != 1 or rl._rate.shape != rl._burst.shape:
            raise ValueError("rates/bursts must be equal-length vectors")
        if len(rl._rate) == 0:
            raise ValueError("need at least one bucket")
        if (rl._rate <= 0.0).any() or (rl._burst < 1.0).any():
            raise ValueError("need rate > 0 and burst >= 1 token")
        rl._tokens = rl._burst.copy()
        rl._last = np.zeros_like(rl._rate)
        rl._granted = np.zeros(len(rl._rate), dtype=np.int64)
        rl._denied = np.zeros(len(rl._rate), dtype=np.int64)
        rl.buckets = _BucketSeq(rl)
        return rl

    @classmethod
    def for_requests(
        cls,
        requests: Sequence[TaskRequest],
        *,
        rate_scale: float = 1.0,
        burst_periods: float = 2.0,
        value_weighted: bool = False,
    ) -> "RateLimiter":
        """Provision one bucket per tenant from its analysis contract.

        Tenant i sustains ``rate_scale * min(w_i, 1) / period_i``
        jobs/s with a burst of ``max(1, burst_periods * w_i)`` jobs,
        where ``w_i`` is 1 or, when ``value_weighted``, the tenant's
        value over the mix mean value. The rate weight is capped at 1:
        value can only *slow* a tenant below its contract (and grow its
        burst), never sustain it above the provisioned rate the
        admission analysis accounted for.
        """
        if rate_scale <= 0.0 or burst_periods <= 0.0:
            raise ValueError("rate_scale and burst_periods must be positive")
        if value_weighted:
            mean_v = sum(r.value for r in requests) / len(requests)
            # floor the weight: value 0 is a legal contract (ShedByValue
            # treats it as shed-first), so it must yield a slow bucket,
            # not a zero-rate one the constructor rejects
            weights = [
                max(r.value / mean_v, 0.01) if mean_v > 0 else 1.0
                for r in requests
            ]
        else:
            weights = [1.0] * len(requests)
        return cls.from_arrays(
            [
                rate_scale * min(w, 1.0) / r.period
                for r, w in zip(requests, weights)
            ],
            [max(1.0, burst_periods * w) for w in weights],
        )

    def __len__(self) -> int:
        return len(self._rate)

    def bucket(self, i: int) -> _BucketView:
        """Live view of tenant ``i``'s bucket state."""
        return _BucketView(self, range(len(self))[i])

    def allow(self, i: int, now: float, cost: float = 1.0) -> bool:
        """Spend ``cost`` tokens of tenant ``i`` at time ``now`` —
        `TokenBucket.take` on the state arrays, bit-for-bit."""
        if cost < 1.0:
            raise ValueError("token cost must be >= 1")
        tok = min(
            self._burst[i],
            self._tokens[i]
            + max(0.0, now - self._last[i]) * self._rate[i],
        )
        self._last[i] = max(self._last[i], now)
        if tok >= cost:
            self._tokens[i] = tok - cost
            self._granted[i] += 1
            return True
        self._tokens[i] = tok
        self._denied[i] += 1
        return False

    def allow_many(self, times, indices, costs=None) -> np.ndarray:
        """Vectorized sweep over one due-release batch: verdicts for
        event ``j`` = release of tenant ``indices[j]`` at
        ``times[j]``, bit-identical to looping `allow` in batch order.

        Per-tenant timestamps must be non-decreasing in batch order
        (the gateway's release schedule is globally time-sorted).
        Duplicate tenants in one batch are handled exactly: events are
        swept in occurrence-rank waves — every tenant's first event in
        one vector pass, then every second event, ... — so each wave
        touches each bucket at most once and successive events of one
        tenant still see each other's refill/charge in order. Deep
        duplicate runs (a Zipf-hot tenant can occur hundreds of times
        per batch, making late waves tiny) fall back to a per-run
        scalar sweep once a wave drops below the vectorization
        break-even: the bucket's state is hoisted into Python floats
        once per run, the run replays `TokenBucket.take`'s exact IEEE
        ops per event, and the state is stored back once — same ops,
        same order, still bit-identical.
        """
        idx = np.asarray(indices, dtype=np.intp)
        t = np.asarray(times, dtype=np.float64)
        if idx.shape != t.shape or idx.ndim != 1:
            raise ValueError("times/indices must be equal-length vectors")
        n = len(idx)
        out = np.empty(n, dtype=bool)
        if n == 0:
            return out
        if costs is None:
            cost = np.ones(n, dtype=np.float64)
        else:
            cost = np.asarray(costs, dtype=np.float64)
            if cost.shape != idx.shape:
                raise ValueError("costs must align 1:1 with events")
            if (cost < 1.0).any():
                raise ValueError("token cost must be >= 1")
        # occurrence rank of each event among its tenant's events (in
        # batch order): rank r events form wave r
        order = np.argsort(idx, kind="stable")
        sorted_idx = idx[order]
        run_start = np.empty(n, dtype=bool)
        run_start[0] = True
        run_start[1:] = sorted_idx[1:] != sorted_idx[:-1]
        start_pos = np.flatnonzero(run_start)
        rank_sorted = np.arange(n) - start_pos[np.cumsum(run_start) - 1]
        rank = np.empty(n, dtype=np.intp)
        rank[order] = rank_sorted
        # regroup by rank once: wave r is a contiguous slice (batch
        # order within — stable sort), no per-wave scan over all events
        by_rank = np.argsort(rank, kind="stable")
        wave_counts = np.bincount(rank)
        # wave sizes are non-increasing in r (a tenant in wave r is in
        # every earlier wave), so the vector waves are a prefix and the
        # small-wave residue a suffix of `by_rank`
        n_vec_waves = int((wave_counts >= 32).sum())
        offset = 0
        for r in range(n_vec_waves):
            c = int(wave_counts[r])
            sel = by_rank[offset:offset + c]
            offset += c
            ii = idx[sel]
            tok = np.minimum(
                self._burst[ii],
                self._tokens[ii]
                + np.maximum(0.0, t[sel] - self._last[ii])
                * self._rate[ii],
            )
            self._last[ii] = np.maximum(self._last[ii], t[sel])
            ok = tok >= cost[sel]
            self._tokens[ii] = np.where(ok, tok - cost[sel], tok)
            self._granted[ii] += ok
            self._denied[ii] += ~ok
            out[sel] = ok
        if offset < n:
            run_len = np.diff(np.append(start_pos, n))
            t_l = t.tolist()
            cost_l = cost.tolist()
            for u in np.flatnonzero(run_len > n_vec_waves).tolist():
                s0 = int(start_pos[u])
                ev = order[
                    s0 + n_vec_waves : s0 + int(run_len[u])
                ].tolist()
                i = int(sorted_idx[s0])
                rate = float(self._rate[i])
                burst = float(self._burst[i])
                tokens = float(self._tokens[i])
                last = float(self._last[i])
                granted = denied = 0
                for j in ev:
                    now = t_l[j]
                    tok = min(
                        burst, tokens + max(0.0, now - last) * rate
                    )
                    last = max(last, now)
                    if tok >= cost_l[j]:
                        tokens = tok - cost_l[j]
                        granted += 1
                        out[j] = True
                    else:
                        tokens = tok
                        denied += 1
                        out[j] = False
                self._tokens[i] = tokens
                self._last[i] = last
                self._granted[i] += granted
                self._denied[i] += denied
        return out

    def tokens(self, i: int, now: float) -> float:
        """Credit available to tenant ``i`` at ``now`` (no state
        change) — `TokenBucket.peek` on the state arrays."""
        return float(
            min(
                self._burst[i],
                self._tokens[i]
                + max(0.0, now - self._last[i]) * self._rate[i],
            )
        )

    def totals(self) -> tuple[int, int]:
        """(granted, denied) across every tenant."""
        return (int(self._granted.sum()), int(self._denied.sum()))
