"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

Each kernel package ships three files:

- ``kernel.py`` — the wrapper that launches the CUDA kernel built from
  ``repro_torch/csrc`` for CUDA tensors, and runs the plain version for
  CPU tensors;
- ``ops.py``    — the public API;
- ``ref.py``    — the plain PyTorch version and the oracles.

Kernels:

- ``preemptible_matmul`` — the paper's §3.4 tile-granular preemption
  mechanism: a window of output tiles accumulated into a resident fp32
  buffer, resumable from a flat tile index.
"""
from repro_torch.kernels.preemptible_matmul import (
    MatmulProgress,
    matmul,
    matmul_resumable,
    matmul_window,
)

__all__ = ["MatmulProgress", "matmul", "matmul_resumable", "matmul_window"]
