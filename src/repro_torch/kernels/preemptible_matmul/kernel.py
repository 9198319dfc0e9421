"""Preemptible output-stationary matmul — the paper's §3.4 mechanism on
an NVIDIA H100.

PHAROS preempts *inside* a layer at tile boundaries: the accelerator
finishes the in-flight tile, keeps the partial output, records the loop
position in the progress table, runs the high-priority job, then
resumes. A kernel launch is not interruptible, so the preemption quantum
is a *window*: one launch computes output tiles ``[start, start +
window)`` of the flattened (m, n) tile grid into a resident fp32 buffer
that is updated in place, so untouched tiles persist. The host
scheduler interleaves windows of different jobs; the progress table
entry is just ``next_tile``.

`matmul_window_call` launches the CUDA kernel of
``repro_torch/csrc/preemptible_matmul.cu`` for CUDA tensors and runs
the plain version (`ref.matmul_window_plain`) for CPU tensors. For a
CUDA tensor it launches or raises; it never falls back. The kernel
multiplies on the tensor cores with ``mma.sync``: fp32 operands as three
TF32 products (3xTF32, fp32-exact to 1e-5 of the max), bf16 operands as
one bf16 product; each output element is summed by one block in a fixed
order, so the same operands give the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import load_library
from repro_torch.kernels.preemptible_matmul.ref import matmul_window_plain

_SYMBOLS = {torch.float32: "pmm_window_f32", torch.bfloat16: "pmm_window_bf16"}
#: output tile edge and K staging depth of the CUDA kernel
_CUDA_TILE = 128
_CUDA_DEPTH = 32
_INT32_MAX = 2**31 - 1
#: the kernel copies operands in 16-byte pieces
_ALIGN = 16


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("preemptible_matmul"), _SYMBOLS[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # a, b, c
        ctypes.c_int, ctypes.c_int,  # K, N
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # start, window, n_tiles_n
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(start, a, b, c_acc, block, window, n_tiles_n, k_steps) -> None:
    if a.dim() != 2 or b.dim() != 2 or c_acc.dim() != 2:
        raise ValueError("a, b and c_acc must be 2-D")
    (M, K), (K2, N) = a.shape, b.shape
    if K2 != K or tuple(c_acc.shape) != (M, N):
        raise ValueError(
            f"shapes disagree: a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"c_acc {tuple(c_acc.shape)}"
        )
    if a.dtype not in _SYMBOLS or b.dtype != a.dtype:
        raise ValueError(
            f"a and b must both be float32 or bfloat16, got {a.dtype} "
            f"and {b.dtype}"
        )
    if c_acc.dtype != torch.float32:
        raise ValueError(f"c_acc must be float32, got {c_acc.dtype}")
    if not (a.device == b.device == c_acc.device):
        raise ValueError(
            f"operands on different devices: {a.device}, {b.device}, "
            f"{c_acc.device}"
        )
    if not (
        a.is_contiguous() and b.is_contiguous() and c_acc.is_contiguous()
    ):
        raise ValueError("a, b and c_acc must be contiguous")
    bm, bk, bn = block
    if M % bm or K % bk or N % bn:
        raise ValueError(f"shape ({M},{K},{N}) not divisible by {block}")
    if n_tiles_n != N // bn or k_steps != K // bk:
        raise ValueError("n_tiles_n / k_steps do not match the shapes")
    total = (M // bm) * n_tiles_n
    if window < 1 or start < 0 or start + window > total:
        raise ValueError(
            f"window [{start}, {start + window}) outside the {total} tiles"
        )


def matmul_window_call(
    start: int,
    a: torch.Tensor,
    b: torch.Tensor,
    c_acc: torch.Tensor,
    *,
    block: tuple[int, int, int],
    window: int,
    n_tiles_n: int,
    k_steps: int,
) -> torch.Tensor:
    """Add ``a @ b`` into output tiles ``[start, start + window)`` of
    ``c_acc``. **Updates ``c_acc`` in place** and returns it (the TPU
    kernel aliases it in and out the same way).

    ``a``: (M, K) and ``b``: (K, N), both float32 or both bfloat16;
    ``c_acc``: (M, N) float32; all contiguous (on CUDA also 16-byte
    aligned), on one device, with dims multiples of ``block``. ``start`` is a plain int. The window must lie
    inside the tile grid. On CUDA the kernel takes 128x128 output tiles
    (``block`` = (128, bk, 128) with bk a multiple of 32) and runs on
    the current stream; each launch adds one to
    ``matmul_window_call.launches``. CPU tensors take the plain version
    and count nothing.
    """
    start, window = int(start), int(window)
    _check(start, a, b, c_acc, block, window, n_tiles_n, k_steps)
    if a.device.type == "cpu":
        return matmul_window_plain(a, b, c_acc, start, window, block)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    bm, bk, bn = block
    if bm != _CUDA_TILE or bn != _CUDA_TILE or bk % _CUDA_DEPTH:
        raise ValueError(
            f"the CUDA kernel takes block (128, 32*n, 128), got {block}"
        )
    if max(a.numel(), b.numel(), c_acc.numel()) > _INT32_MAX:
        raise ValueError("operand too large for 32-bit tile indexing")
    if any(t.data_ptr() % _ALIGN for t in (a, b, c_acc)):
        raise ValueError(f"a, b and c_acc must be {_ALIGN}-byte aligned")
    fn = _kernel(a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            a.data_ptr(), b.data_ptr(), c_acc.data_ptr(),
            a.shape[1], b.shape[1], start, window, n_tiles_n, stream,
        )
    if err != 0:
        raise RuntimeError(f"preemptible_matmul launch failed: CUDA error {err}")
    matmul_window_call.launches += 1
    return c_acc


#: kernel launches since the count was last set to 0 (CUDA path only)
matmul_window_call.launches = 0
