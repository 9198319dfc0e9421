"""Task and segment model (paper §3.3)."""
from repro_torch.core.rt.task import (
    LayerDesc,
    SegmentTable,
    Task,
    TaskSet,
    Workload,
)

__all__ = ["LayerDesc", "SegmentTable", "Task", "TaskSet", "Workload"]
