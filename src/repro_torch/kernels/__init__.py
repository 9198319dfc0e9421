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
- ``flash_attention`` — causal GQA attention with an online softmax,
  every attention layer of an LM prefill.
- ``rwkv6_scan`` — the RWKV-6 WKV recurrence, every time-mix layer of
  an RWKV-6 prefill.
- ``mamba_scan`` — the selective scan, every mamba layer of a Jamba
  prefill.
- ``adamw`` — the optimizer's global-norm clip and AdamW update over a
  whole parameter tree in two launches (no Pallas counterpart; its
  plain version is `repro_torch.optim.adamw.adamw_per_leaf`).

``flash_attention``, ``rwkv6_scan`` and ``mamba_scan`` are imported from
their own packages: a function of the same name here would hide the subpackage
from ``import repro_torch.kernels.flash_attention.kernel as ...``.
"""
from repro_torch.kernels.preemptible_matmul import (
    MatmulProgress,
    matmul,
    matmul_resumable,
    matmul_window,
)

__all__ = ["MatmulProgress", "matmul", "matmul_resumable", "matmul_window"]
