"""Straggler mitigation, PHAROS-style: deadlines for training steps.

The paper's lens — every job must have bounded response time — applies
to the *training pipeline* too: a synchronous step is a job whose
deadline is the step-time budget; a worker that repeatedly blows the
budget is a straggler that would stall all N workers.

`StragglerMitigator` keeps per-worker EWMA step times, flags workers
slower than ``threshold x`` the fleet median, and recommends an action:

- ``backup``   — schedule a backup copy of the straggler's shard
                 (speculative execution; first finisher wins),
- ``exclude``  — drop the worker and trigger an elastic re-mesh
                 (`runtime.elastic`) when it exceeds the miss budget,

mirroring how the serving side handles deadline misses (SRT: bounded,
not zero, misses).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerReport:
    stragglers: list[str]
    actions: dict[str, str]
    median_step: float


class StragglerMitigator:
    def __init__(
        self,
        workers: list[str],
        *,
        ewma: float = 0.3,
        threshold: float = 1.5,
        miss_budget: int = 5,
    ):
        self.ewma = ewma
        self.threshold = threshold
        self.miss_budget = miss_budget
        self.step_time: dict[str, float] = {w: 0.0 for w in workers}
        self.misses: dict[str, int] = {w: 0 for w in workers}

    def observe(self, worker: str, step_seconds: float) -> None:
        prev = self.step_time[worker]
        self.step_time[worker] = (
            step_seconds
            if prev == 0.0
            else (1 - self.ewma) * prev + self.ewma * step_seconds
        )

    def assess(self) -> StragglerReport:
        times = [t for t in self.step_time.values() if t > 0.0]
        if not times:
            return StragglerReport([], {}, 0.0)
        median = float(np.median(times))
        stragglers, actions = [], {}
        for w, t in self.step_time.items():
            if t > self.threshold * median > 0:
                self.misses[w] += 1
                stragglers.append(w)
                actions[w] = (
                    "exclude" if self.misses[w] >= self.miss_budget else "backup"
                )
            else:
                self.misses[w] = max(0, self.misses[w] - 1)
        return StragglerReport(stragglers, actions, median)
