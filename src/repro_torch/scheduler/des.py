"""Preemption-cost record of the pipeline scheduler.

Only `StageOverhead` is here: `CostModel.des_overheads` returns it. The
event-driven simulator it belongs to is not part of this package yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StageOverhead:
    """Per-stage preemption cost split (Eq. 5)."""

    e_tile: float = 0.0
    e_store: float = 0.0
    e_load: float = 0.0

    @property
    def pre(self) -> float:  # paid before the preemptor starts
        return self.e_tile + self.e_store

    @property
    def post(self) -> float:  # paid by the preempted job on resume
        return self.e_load

    @property
    def xi(self) -> float:
        return self.e_tile + self.e_store + self.e_load
