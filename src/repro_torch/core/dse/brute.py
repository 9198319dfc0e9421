"""Brute-force DSE baseline (paper §5.4): beam search with B = +inf.

The paper implements brute force as BFS over the same space; setting
``beam_width=None`` keeps every child each iteration. Exponential — use
only for the Fig. 9 quality/time comparison on small problems.
"""
from __future__ import annotations

from repro_torch.core.dse.beam import BeamResult, beam_search
from repro_torch.core.perfmodel.hardware import Platform
from repro_torch.core.rt.task import TaskSet, Workload


def brute_force_search(
    workloads: list[Workload],
    taskset: TaskSet,
    platform: Platform,
    max_m: int = 4,
    max_frontier: int = 2_000_000,
    **kwargs,
) -> BeamResult:
    """Equivalent to ``explore(..., method="brute")``; extra keyword
    arguments (``objective``, ``constraint``, ``evaluator``) pass
    through to `beam_search`."""
    return beam_search(
        workloads,
        taskset,
        platform,
        max_m=max_m,
        beam_width=None,
        max_frontier=max_frontier,
        **kwargs,
    )
