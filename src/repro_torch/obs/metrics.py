"""Deadline-compliance metrics: counters, gauges, histograms and the
registry that rolls a schedule trace up into them.

The catalog `MetricsRegistry.from_trace` populates (names are
``<metric>/<label>``):

- counters  — ``releases/<task>``, ``completions/<task>``,
  ``deadline_misses/<task>``, ``shed/<task>``, ``rate_limited/<task>``,
  ``preemptions/stage<k>``; ``xi_charged/stage<k>`` accumulates the
  Eq. 5 store+load seconds charged on that stage.
- histograms — ``response/<task>`` and ``tardiness/<task>`` (seconds;
  tardiness is ``max(0, completion - absolute deadline)``), exposing
  p50/p95/p99 via `Histogram.percentile`.
- gauges    — ``backlog/<task>`` (in-flight at trace end: releases
  minus completions), ``xi_overhead_fraction`` (total xi seconds over
  the trace makespan), and — set by the caller from the analysis side,
  not derivable from a trace — ``eq3_slack/stage<k>``
  (`set_eq3_slacks`, the per-stage Eq. 3 slack ``1 - u^k``).

Percentiles use the nearest-rank method (`percentile`) so results are
always actual observed values; `SimResult.response_percentiles` /
`ServerReport.response_percentiles` share this one implementation (in
the JAX package, `benchmarks/shard_bench.py` too).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of ``values``.

    Returns ``nan`` for an empty sequence. The nearest-rank method
    always returns an observed value — no interpolation — which keeps
    tail percentiles honest on the small per-task samples a bounded
    horizon produces.
    """
    vals = sorted(values)
    if not vals:
        return math.nan
    if not 0.0 <= q <= 100.0:
        raise ValueError("percentile q must be in [0, 100]")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def percentile_summary(values, qs=(50, 95, 99)) -> dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` via `percentile`."""
    return {f"p{q:g}": percentile(values, q) for q in qs}


@dataclass
class Counter:
    """Monotone accumulator (float-valued: xi seconds count too)."""

    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Histogram:
    """Raw-sample histogram with nearest-rank percentiles."""

    samples: list[float] = field(default_factory=list)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return sum(self.samples)

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self, qs=(50, 95, 99)) -> dict:
        out = {"count": self.count, "sum": self.sum}
        if self.samples:
            out["max"] = max(self.samples)
        out.update(percentile_summary(self.samples, qs))
        return out


class MetricsRegistry:
    """Get-or-create registry of named counters/gauges/histograms."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name, Histogram())

    def set_eq3_slacks(self, slacks) -> None:
        """Publish per-stage Eq. 3 slack gauges (``eq3_slack/stage<k>``)
        from the analysis side (`repro_torch.core.rt.stage_slacks`) — the one
        catalog entry a trace cannot produce on its own."""
        for k, s in enumerate(slacks):
            self.gauge(f"eq3_slack/stage{k}").set(s)

    def snapshot(self) -> dict:
        """JSON-able dump: counters/gauges flat, histograms summarized
        (count, sum, max, p50/p95/p99)."""
        return {
            "counters": {
                k: c.value for k, c in sorted(self.counters.items())
            },
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self.histograms.items())
            },
        }

    # ------------------------------------------------------------------
    @classmethod
    def from_trace(cls, events) -> "MetricsRegistry":
        """Roll a `TraceRecorder` (or event list) up into the standard
        deadline-compliance catalog (module docstring). Multi-layer
        traces are fine — pre-filter with `TraceRecorder.stream` when a
        single layer's view is wanted."""
        events = list(getattr(events, "events", events))
        reg = cls()
        t_min = math.inf
        t_max = -math.inf
        xi_total = 0.0
        for e in events:
            t_min = min(t_min, e.t)
            t_max = max(t_max, e.t)
            if e.kind == "release":
                reg.counter(f"releases/{e.task}").inc()
            elif e.kind == "complete":
                reg.counter(f"completions/{e.task}").inc()
                # response/tardiness derive from the event itself: the
                # emitters carry only {"deadline": ...} (hot-path economy)
                if e.release is not None:
                    reg.histogram(f"response/{e.task}").observe(
                        e.t - e.release
                    )
                dl = e.get("deadline")
                if dl is not None and dl != math.inf:
                    reg.histogram(f"tardiness/{e.task}").observe(
                        max(0.0, e.t - dl)
                    )
                    if e.t > dl:
                        # completed-job misses are derived, not emitted
                        # (see repro_torch.obs.trace event vocabulary)
                        reg.counter(f"deadline_misses/{e.task}").inc()
            elif e.kind == "deadline_miss":
                # explicit events cover only in-flight horizon-end
                # misses, so this never double-counts the derived ones
                reg.counter(f"deadline_misses/{e.task}").inc()
            elif e.kind == "shed":
                reg.counter(f"shed/{e.task}").inc()
            elif e.kind == "rate_limited":
                reg.counter(f"rate_limited/{e.task}").inc()
            elif e.kind == "preempt_store":
                reg.counter(f"preemptions/stage{e.stage}").inc()
                xi_total += e.get("xi", 0.0)
            elif e.kind == "preempt_load":
                xi_total += e.get("xi", 0.0)
        for name, c in sorted(reg.counters.items()):
            if name.startswith("releases/"):
                task = name.split("/", 1)[1]
                done = reg.counters.get(f"completions/{task}")
                reg.gauge(f"backlog/{task}").set(
                    c.value - (done.value if done else 0.0)
                )
        if xi_total > 0.0:
            for e in events:
                if e.kind == "preempt_store":
                    reg.counter(f"xi_charged/stage{e.stage}").inc(
                        e.get("xi", 0.0)
                    )
                elif e.kind == "preempt_load":
                    reg.counter(f"xi_charged/stage{e.stage}").inc(
                        e.get("xi", 0.0)
                    )
        makespan = (t_max - t_min) if t_max > t_min else 0.0
        reg.gauge("xi_overhead_fraction").set(
            xi_total / makespan if makespan > 0.0 else 0.0
        )
        return reg
