"""The serving runtime on PyTorch.

- `serve`: per-stage FIFO/EDF schedulers, job pools, the progress table
  and tile-window preemption through the preemptible-matmul kernel —
  the paper's control flow (§3.2, §3.4).
- `stage_split`: DSE design points -> GEMM-chain serve tasks.
"""
from repro_torch.pipeline.serve import (
    Job,
    PharosServer,
    ServerReport,
    ServeTask,
)
from repro_torch.pipeline.stage_split import design_to_segments

__all__ = [
    "Job",
    "PharosServer",
    "ServeTask",
    "ServerReport",
    "design_to_segments",
]
