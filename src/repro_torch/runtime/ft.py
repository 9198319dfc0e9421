"""Fault tolerance: heartbeat monitoring + checkpoint/restart loop.

At thousand-node scale the mean time between node failures drops below
the job length, so the framework — not the operator — must own recovery:

- `HeartbeatMonitor` tracks per-worker liveness (the coordinator-side
  view; on a real deployment heartbeats arrive over RPC, here they are
  injected by the caller/tests).
- `FaultTolerantLoop` wraps a step function with (a) periodic atomic
  checkpoints, (b) failure detection, (c) restart-from-latest with the
  deterministic data pipeline repositioned — so a crash at step N costs
  at most ``ckpt_every`` steps of work, never silent corruption.

The same loop also hosts the PHAROS angle: a *deadline* per step (from
the RT analysis of the training pipeline). A step exceeding its
deadline marks the contributing worker a straggler candidate
(`runtime.straggler`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from repro_torch.checkpoint import CheckpointManager


class WorkerState(str, Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class _Worker:
    last_beat: float
    state: WorkerState = WorkerState.HEALTHY


class HeartbeatMonitor:
    """Coordinator-side liveness view over injected heartbeats."""

    def __init__(self, workers: list[str], *, suspect_after: float = 5.0,
                 dead_after: float = 15.0,
                 # rtlint: disable=clock-domain -- injectable host-liveness
                 # clock default; tests inject a virtual clock
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        now = clock()
        self.workers = {w: _Worker(last_beat=now) for w in workers}

    def beat(self, worker: str) -> None:
        w = self.workers[worker]
        w.last_beat = self.clock()
        w.state = WorkerState.HEALTHY

    def sweep(self) -> dict[str, WorkerState]:
        now = self.clock()
        for w in self.workers.values():
            silent = now - w.last_beat
            if silent >= self.dead_after:
                w.state = WorkerState.DEAD
            elif silent >= self.suspect_after:
                w.state = WorkerState.SUSPECT
        return {k: v.state for k, v in self.workers.items()}

    def dead(self) -> list[str]:
        return [k for k, v in self.sweep().items() if v is WorkerState.DEAD]

    def healthy_count(self) -> int:
        return sum(
            1 for v in self.sweep().values() if v is WorkerState.HEALTHY
        )


@dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    failures_seen: int = 0
    checkpoints: int = 0
    resumed_from: list[int] = field(default_factory=list)


class FaultTolerantLoop:
    """Checkpoint/restart driver around a pure step function.

    ``step_fn(step, state) -> state`` must be deterministic given
    (step, state) — with the deterministic data pipeline this holds, so
    recovery replays to an identical trajectory (tested).

    ``failure_hook(step) -> bool`` lets tests/chaos-drills inject a
    failure before a step; a real deployment wires the heartbeat
    monitor's `dead()` here instead.
    """

    def __init__(
        self,
        mgr: CheckpointManager,
        step_fn,
        *,
        failure_hook=None,
        max_restarts: int = 16,
    ):
        self.mgr = mgr
        self.step_fn = step_fn
        self.failure_hook = failure_hook or (lambda step: False)
        self.max_restarts = max_restarts
        self.report = LoopReport()

    def run(self, init_state, total_steps: int):
        """Run to ``total_steps`` surviving injected failures."""
        restarts = 0
        while True:
            start, state = self.mgr.restore_latest(init_state)
            if start:
                self.report.resumed_from.append(start)
            try:
                for step in range(start, total_steps):
                    if self.failure_hook(step):
                        self.report.failures_seen += 1
                        raise RuntimeError(f"injected failure at step {step}")
                    state = self.step_fn(step, state)
                    self.report.steps_run += 1
                    if self.mgr.maybe_save(step + 1, state):
                        self.report.checkpoints += 1
                return state, self.report
            except RuntimeError:
                restarts += 1
                self.report.restarts = restarts
                if restarts > self.max_restarts:
                    raise
