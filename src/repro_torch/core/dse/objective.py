"""Unified objective / constraint layer for the DSE.

The seed code had three parallel search paths — beam, brute, TG — each
with its own hard-coded notion of "good" and "feasible". This module
factors those notions out:

- an `Objective` scores a complete design (lower is better) and supplies
  the beam's child-ranking guide;
- a `Constraint` decides which candidates are pruned mid-search and
  which complete designs count as feasible.

`beam_search` / `explore` take both as parameters; the defaults
(`MinMaxUtil` + `Eq3Constraint`) reproduce the paper's SRT-guided
search decision-for-decision, and `TotalLatency` is the CHARM-style
throughput objective the TG configuration reports. The constants here
are the exact literals the scalar seed code used, so the default
configuration is bit-compatible with the pre-refactor search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - typing only
    import numpy as np

    from repro_torch.core.dse.space import DesignPoint
    from repro_torch.core.rt.task import SegmentTable, TaskSet

#: feasibility float tolerance on the objective cap (the seed's
#: ``max_util <= 1.0 + 1e-12`` accept gate in ``note_feasible``)
FEASIBLE_EPS = 1e-12


@runtime_checkable
class Objective(Protocol):
    """Scores designs; lower is better."""

    name: str

    def score(self, table: "SegmentTable", taskset: "TaskSet") -> float:
        """Score a materialized design from its WCET table — the
        authoritative objective value, in the objective's own units."""
        ...

    def rank(self, max_util: float, total_latency: float) -> float:
        """Best-design selection key from the two batched per-design
        metrics the search computes for every feasible completion
        (max stage utilization and summed chain latency)."""
        ...

    def guide(
        self, created_max: float, rem_util: float, stages_left: int
    ) -> float:
        """Beam ranking key for a partial design (lower expands first)."""
        ...


@runtime_checkable
class Constraint(Protocol):
    """Feasibility gates applied during and after the search."""

    name: str

    def prunes(self, util: float) -> bool:
        """Drop a child whose new accelerator reached this utilization."""
        ...

    def prunes_batch(self, utils: "np.ndarray") -> "np.ndarray":
        """Vectorized `prunes` over a candidate batch."""
        ...

    def completes(self, rem_util: float) -> bool:
        """May the remainder close out a feasible design at this util?"""
        ...

    def accepts(self, max_util: float) -> bool:
        """Is a complete design with this max utilization feasible?"""
        ...


@dataclass(frozen=True)
class MinMaxUtil:
    """The paper's SRT objective (§4.1): minimize ``max_k u^k``.

    The guide is the seed beam's admissible balance estimate — the
    utilization the completed design could reach if the remainder split
    perfectly over the stages still available.
    """

    name: str = "min_max_util"

    def score(self, table, taskset) -> float:
        from repro_torch.core.rt.schedulability import max_utilization

        return max_utilization(table, taskset, preemptive=False)

    def rank(self, max_util: float, total_latency: float) -> float:
        return max_util

    def guide(
        self, created_max: float, rem_util: float, stages_left: int
    ) -> float:
        return max(created_max, rem_util / stages_left)


@dataclass(frozen=True)
class TotalLatency:
    """CHARM-style throughput objective: minimize the summed chain
    latency ``sum_i sum_k b_i^k`` (periods never enter — that is the
    point of the TG baseline). As a beam guide it still ranks by the
    balance estimate: latency alone cannot order partial designs whose
    remainders differ in splittability.
    """

    name: str = "total_latency"

    def score(self, table, taskset) -> float:
        return sum(sum(row) for row in table.base)

    def rank(self, max_util: float, total_latency: float) -> float:
        return total_latency

    def guide(
        self, created_max: float, rem_util: float, stages_left: int
    ) -> float:
        return max(created_max, rem_util / stages_left)


@dataclass(frozen=True)
class Eq3Constraint:
    """Per-stage utilization cap (paper Eq. 3 at ``cap == 1.0``).

    ``prunes``/``completes`` use the strict seed literals (``> cap`` /
    ``<= cap``); ``accepts`` allows the seed's ``FEASIBLE_EPS`` float
    slack on complete designs. A deployment wanting analysis margin can
    search at e.g. ``cap=0.9`` — every claimed-feasible design then
    arrives with 10% of Eq. 2 budget still unspent on every stage.
    """

    cap: float = 1.0
    name: str = "eq3"

    def prunes(self, util: float) -> bool:
        return util > self.cap

    def prunes_batch(self, utils):
        return utils > self.cap

    def completes(self, rem_util: float) -> bool:
        return rem_util <= self.cap

    def accepts(self, max_util: float) -> bool:
        return max_util <= self.cap + FEASIBLE_EPS


#: the default (paper) configuration
SRT_OBJECTIVE = MinMaxUtil()
TG_OBJECTIVE = TotalLatency()
EQ3 = Eq3Constraint()
