"""Real-time theory core for PHAROS (paper §3.3–§3.4).

Implements the task/segment model, per-accelerator utilization (Eq. 2),
the SRT-schedulability test (Eq. 3) from the guideline theory
[Dong et al., ECRTS'17], the preemption-overhead WCET model (Eqs. 4–5),
and analytical response-time bounds for FIFO and EDF on a chained
pipeline of accelerators.
"""
from repro_torch.core.rt.task import (
    LayerDesc,
    Workload,
    Task,
    TaskSet,
    SegmentTable,
)
from repro_torch.core.rt.schedulability import (
    stage_utilization,
    max_utilization,
    srt_schedulable,
    effective_wcets,
    stage_slacks,
    max_admissible_rate,
    task_rate_sensitivity,
    utilization_headroom,
)
from repro_torch.core.rt.response_time import (
    busy_period,
    fifo_stage_bound,
    edf_stage_bound,
    end_to_end_bounds,
)
from repro_torch.core.rt.batch import (
    batched_busy_period,
    batched_end_to_end_bounds,
    batched_max_utilization,
    batched_srt_schedulable,
    batched_stage_slacks,
    batched_stage_utilizations,
    batched_wcets,
)

__all__ = [
    "LayerDesc",
    "Workload",
    "Task",
    "TaskSet",
    "SegmentTable",
    "stage_utilization",
    "max_utilization",
    "srt_schedulable",
    "effective_wcets",
    "stage_slacks",
    "max_admissible_rate",
    "task_rate_sensitivity",
    "utilization_headroom",
    "busy_period",
    "fifo_stage_bound",
    "edf_stage_bound",
    "end_to_end_bounds",
    "batched_busy_period",
    "batched_end_to_end_bounds",
    "batched_max_utilization",
    "batched_srt_schedulable",
    "batched_stage_slacks",
    "batched_stage_utilizations",
    "batched_wcets",
]
