"""Trace-level differential diagnosis: the first event where two
layers' schedules part ways.

The conformance harness compares end-of-run response aggregates under a
tolerance; when the tolerance trips, the aggregate says *that* the
layers disagree but not *where*. `trace_diff` aligns two event streams
(canonically DES vs runtime) job-by-job — the join key is ``(task,
release stamp, kind)``, the same exact-float release identity
`run_shedding_case` matches jobs with — and reports the **first**
divergent event in the reference stream's order:

- ``missing_in_b`` / ``missing_in_a`` — a job event one layer emitted
  and the other never did (a shed/lost/unfinished job);
- ``time_skew``   — both emitted it, but the timestamps differ by more
  than the allowance (scalar, or per-task dict — the harness passes
  the case's own per-task conformance allowance so "identical" and
  "conformance-clean" mean the same thing).

Only job-scoped, order-pinned kinds participate by default
(``release`` and ``complete``): dispatch/preemption events are
schedule *mechanism*, timing of which legitimately differs at
simultaneous-event tie-breaks without any response-visible effect.
Pass ``kinds=...`` to widen the comparison.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

#: kinds compared by default: job-scoped and order-pinned across layers
DEFAULT_DIFF_KINDS = ("release", "complete")


@dataclass(frozen=True)
class Divergence:
    """The first point of disagreement between two streams."""

    reason: str  # "missing_in_a" | "missing_in_b" | "time_skew"
    task: str
    kind: str
    release: float | None
    t_a: float | None
    t_b: float | None
    allow: float

    def __str__(self) -> str:
        where = f"{self.kind}({self.task}, release={self.release:.6g})" \
            if self.release is not None else f"{self.kind}({self.task})"
        if self.reason == "time_skew":
            return (
                f"first divergence: {where} at {self.t_a:.6g} vs "
                f"{self.t_b:.6g} (|dt|={abs(self.t_a - self.t_b):.3g} "
                f"> allow={self.allow:.3g})"
            )
        missing = "b" if self.reason == "missing_in_b" else "a"
        t = self.t_a if missing == "b" else self.t_b
        return f"first divergence: {where} at {t:.6g} missing in '{missing}'"


@dataclass(frozen=True)
class TraceDiff:
    """`trace_diff` result; ``identical`` means every compared event
    matched within the allowance."""

    identical: bool
    compared: int
    names: tuple[str, str]
    divergence: Divergence | None = None
    #: worst matched-timestamp skew observed (diagnostic, even when
    #: identical)
    max_skew: float = 0.0

    def summary(self) -> str:
        if self.identical:
            return (
                f"identical ({self.compared} events matched, "
                f"max skew {self.max_skew:.3g})"
            )
        return f"{self.divergence} [{self.names[0]} vs {self.names[1]}]"


def _key(e) -> tuple:
    return (e.task, e.release, e.kind)


def trace_diff(
    events_a,
    events_b,
    *,
    kinds=DEFAULT_DIFF_KINDS,
    time_tol=0.0,
    names: tuple[str, str] = ("des", "runtime"),
) -> TraceDiff:
    """Align two schedule-event streams and report the first divergent
    event (see module docstring). ``events_*`` are `TraceRecorder`s or
    event lists; ``time_tol`` is a scalar allowance or a per-task dict
    (missing tasks fall back to 0)."""
    kinds = set(kinds)
    a = [e for e in getattr(events_a, "events", events_a) if e.kind in kinds]
    b = [e for e in getattr(events_b, "events", events_b) if e.kind in kinds]

    def allow_for(task: str) -> float:
        if isinstance(time_tol, dict):
            return float(time_tol.get(task, 0.0))
        return float(time_tol)

    b_by_key: dict[tuple, list] = {}
    for e in b:
        b_by_key.setdefault(_key(e), []).append(e)

    compared = 0
    max_skew = 0.0
    first: Divergence | None = None
    matched_b: set[int] = set()
    for e in a:
        peers = b_by_key.get(_key(e))
        if not peers:
            first = Divergence(
                "missing_in_b", e.task, e.kind, e.release,
                e.t, None, allow_for(e.task),
            )
            break
        peer = peers.pop(0)
        # pure identity membership (which exact event objects were
        # matched); never ordered or persisted
        matched_b.add(id(peer))
        compared += 1
        skew = abs(e.t - peer.t)
        max_skew = max(max_skew, skew)
        allow = allow_for(e.task)
        if skew > allow + 1e-12:
            first = Divergence(
                "time_skew", e.task, e.kind, e.release,
                e.t, peer.t, allow,
            )
            break
    if first is None:
        for e in b:
            # identity membership test against matched_b above; see
            # rationale there
            if id(e) not in matched_b:
                first = Divergence(
                    "missing_in_a", e.task, e.kind, e.release,
                    None, e.t, allow_for(e.task),
                )
                break
    if first is None and math.isnan(max_skew):
        max_skew = 0.0
    return TraceDiff(
        identical=first is None,
        compared=compared,
        names=tuple(names),
        divergence=first,
        max_skew=max_skew,
    )
