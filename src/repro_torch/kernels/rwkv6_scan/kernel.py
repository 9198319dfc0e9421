"""RWKV-6 WKV recurrence on an NVIDIA H100.

`rwkv6_scan_call` launches the CUDA kernel of
``repro_torch/csrc/rwkv6_scan.cu`` for CUDA tensors and runs the plain
version (`ref.rwkv6_scan_plain`) for CPU tensors. For a CUDA tensor it
launches or raises; it never falls back. The kernel reads the model's
(B, S, H, hd) tensors through TMA tensor maps, STAGE_STEPS steps at a
time, and writes y through their strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import load_library
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_plain

#: head width the CUDA kernel is compiled for
HEAD_DIM = 64
#: longest chunk the plain (chunked) version is exact for under the
#: model's decay clamp; the JAX kernel has the same limit
MAX_CHUNK = 64
#: time steps the CUDA kernel stages per TMA box (``kT`` in the source)
STAGE_STEPS = 32
_INT32_MAX = 2**31 - 1


@functools.cache
def _kernel():
    fn = load_library("rwkv6_scan").wkv6_forward_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,  # r k v w u
        ctypes.c_void_p, ctypes.c_void_p,  # y, s_out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, chunk) -> None:
    if r.dim() != 4:
        raise ValueError("r, k, v, w must be (B, S, H, hd)")
    shape = tuple(r.shape)
    if any(tuple(t.shape) != shape for t in (k, v, w)):
        raise ValueError(
            "r, k, v, w shapes disagree: "
            + ", ".join(str(tuple(t.shape)) for t in (r, k, v, w))
        )
    B, S, H, hd = shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be ({H}, {hd}), got {tuple(u.shape)}")
    if S < 1:
        raise ValueError("empty sequence")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if len({t.device for t in (r, k, v, w, u)}) != 1:
        raise ValueError("operands on different devices")


def rwkv6_scan_call(r, k, v, w, u, *, chunk: int = MAX_CHUNK):
    """WKV-6 from a zero state: ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``,
    ``y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)``.

    r, k, v, w: (B, S, H, hd); u: (H, hd). Returns (y (B, S, H, hd),
    S_final (B, H, hd, hd)), float32. On CUDA every operand must be
    float32 and contiguous, r, k, v, w 16-byte aligned, and hd 64; the
    kernel is a step-by-step recurrence whose result does not depend on
    ``chunk``, runs on the current stream, and each launch adds one to
    ``rwkv6_scan_call.launches``. CPU tensors take the plain chunked
    version and count nothing.
    """
    _check(r, k, v, w, u, chunk)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    B, S, H, hd = r.shape
    if hd != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head size {HEAD_DIM}, got {hd}")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise ValueError("the CUDA kernel takes float32 r, k, v, w, u")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("r, k, v, w, u must be contiguous")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("r, k, v, w must be 16-byte aligned (TMA)")
    if B * H > _INT32_MAX:
        raise ValueError(f"grid too large for B*H={B * H}")
    y = torch.empty_like(r)
    s_final = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s_final.data_ptr(), B, S, H, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    rwkv6_scan_call.launches += 1
    return y, s_final


#: kernel launches since the count was last set to 0 (CUDA path only)
rwkv6_scan_call.launches = 0
