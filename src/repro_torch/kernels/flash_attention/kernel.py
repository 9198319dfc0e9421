"""Causal GQA flash attention on an NVIDIA H100.

`flash_attention_call` launches the CUDA kernel of
``repro_torch/csrc/flash_attention.cu`` for CUDA tensors and runs the
plain version (`ref.attention_plain`) for CPU tensors. For a CUDA
tensor it launches or raises; it never falls back. bf16 tensors go to
the tensor-core kernel (wgmma, K/V through TMA), fp32 tensors to the
SIMT kernel: one kernel per type. The kernel reads the model's
(B, S, heads, hd) tensors through their strides, so nothing is
transposed on either side of the call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import load_library
from repro_torch.kernels.flash_attention.ref import attention_plain

_SYMBOLS = {torch.float32: "fa_forward_f32", torch.bfloat16: "fa_forward_bf16"}
#: head widths the CUDA kernel is compiled for
HEAD_DIMS = (64, 128)
_BLOCK_Q = 64
_GRID_Y_MAX = 65535
_INT32_MAX = 2**31 - 1
#: TMA reads the bf16 operands from 16-byte aligned addresses
_ALIGN = 16


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention"), _SYMBOLS[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H Hkv
        ctypes.c_int, ctypes.c_int,  # hd, causal
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    if tuple(k.shape) != tuple(v.shape) or (k.shape[0], k.shape[1],
                                            k.shape[3]) != (B, S, hd):
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads not a multiple of {Hkv} KV heads")
    if S < 1:
        raise ValueError("empty sequence")
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share float32 or bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"operands on different devices: {q.device}, {k.device}, {v.device}"
        )


def flash_attention_call(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """softmax(q kᵀ · hd^-½) v per head, causal by default.

    q: (B, S, H, hd); k, v: (B, S, Hkv, hd) with H a multiple of Hkv;
    all float32 or all bfloat16, on one device. Returns (B, S, H, hd) in
    q's dtype. On CUDA the tensors must be contiguous (bf16 ones also
    16-byte aligned) and hd 64 or 128; the kernel runs on the current stream and each launch adds one to
    ``flash_attention_call.launches``. CPU tensors take the plain version
    and count nothing.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % _ALIGN for t in (q, k, v)
    ):
        raise ValueError(f"bf16 q, k and v must be {_ALIGN}-byte aligned")
    if B * H > _INT32_MAX or -(-S // _BLOCK_Q) > _GRID_Y_MAX:
        raise ValueError(f"grid too large for B*H={B * H}, S={S}")
    out = torch.empty_like(q)
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], hd, int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_call.launches += 1
    return out


#: kernel launches since the count was last set to 0 (CUDA path only)
flash_attention_call.launches = 0
