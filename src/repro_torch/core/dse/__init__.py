"""PHAROS design space (paper §4.1): design points and their segment
tables."""
from repro_torch.core.dse.space import (
    DesignPoint,
    evaluate_design,
    task_segments,
)

__all__ = ["DesignPoint", "evaluate_design", "task_segments"]
