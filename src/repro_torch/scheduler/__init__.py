"""Discrete-event scheduling simulator for PHAROS (paper §3.2, §5.2–5.3).

Simulates a pipeline of accelerators (stages), each running one of the
paper's scheduling policies:

- ``fifo``            — FIFO *with* polling (segment ready once the same
                        job finished upstream and the previous job of the
                        same task finished its corresponding segment);
- ``fifo_no_polling`` — baseline FIFO where a job's segment on a stage is
                        gated on the previous job of the same task having
                        finished *all* of its segments on that stage;
- ``edf``             — preemptive EDF with tile-granular preemption
                        overhead (xi = e_tile + e_store + e_load).

Used for: schedulability detection via backlog growth over >100x periods
(paper §5.2), response-time statistics (Fig. 8), preemption counting.
"""
from repro_torch.scheduler.des import (
    SimTask,
    SimConfig,
    SimResult,
    StageOverhead,
    simulate,
    simulate_taskset,
)

__all__ = [
    "SimTask",
    "SimConfig",
    "SimResult",
    "StageOverhead",
    "simulate",
    "simulate_taskset",
]
