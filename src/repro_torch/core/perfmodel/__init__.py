"""Layer latency model of the paper's platform (paper Eq. 1)."""
from repro_torch.core.perfmodel.exec_model import (
    BLOCK_CANDIDATES,
    AccDesign,
    layer_latency,
    preemption_overheads,
    segment_latency,
    vmem_bytes_for_block,
)
from repro_torch.core.perfmodel.hardware import (
    TPU_V5E,
    Platform,
    TPUChip,
    paper_platform,
)

__all__ = [
    "TPUChip",
    "Platform",
    "TPU_V5E",
    "paper_platform",
    "AccDesign",
    "BLOCK_CANDIDATES",
    "layer_latency",
    "segment_latency",
    "preemption_overheads",
    "vmem_bytes_for_block",
]
