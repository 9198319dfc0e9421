"""Order statistics (a frozen copy of ``repro_torch.obs.metrics.percentile``)."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) of ``values``: always
    an observed value, no interpolation; ``nan`` for an empty sequence."""
    vals = sorted(values)
    if not vals:
        return math.nan
    if not 0.0 <= q <= 100.0:
        raise ValueError("percentile q must be in [0, 100]")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]
