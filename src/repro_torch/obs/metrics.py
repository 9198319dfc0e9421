"""Nearest-rank percentiles, the one implementation `ServerReport`
reads its response and tardiness percentiles from."""
from __future__ import annotations

import math


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
