"""Selective scan (Mamba) on an NVIDIA H100.

`mamba_scan_call` launches the CUDA kernel of
``repro_torch/csrc/mamba_scan.cu`` for CUDA tensors and runs the plain
version (`ref.mamba_scan_plain`) for CPU tensors. For a CUDA tensor it
launches or raises; it never falls back. The kernel reads dt, x, B and C
and writes y through TMA tensor maps, STAGE_STEPS steps at a time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import load_library
from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain

#: d_state the CUDA kernel is compiled for (Jamba's)
D_STATE = 16
#: time steps the CUDA kernel stages per TMA box (``kT`` in the source)
STAGE_STEPS = 32
_GRID_Y_MAX = 65535


@functools.cache
def _kernel():
    fn = load_library("mamba_scan").mamba_scan_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,  # dt B C x A h0
        ctypes.c_void_p, ctypes.c_void_p,  # y, h_out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Bb S di
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(dt, B, C, x, A, h0, chunk) -> None:
    if x.dim() != 3:
        raise ValueError("x must be (Bb, S, di)")
    Bb, S, di = x.shape
    if tuple(dt.shape) != (Bb, S, di):
        raise ValueError(f"dt must be {(Bb, S, di)}, got {tuple(dt.shape)}")
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"A must be ({di}, ns), got {tuple(A.shape)}")
    ns = A.shape[1]
    for name, t, want in (("B", B, (Bb, S, ns)), ("C", C, (Bb, S, ns)),
                          ("h0", h0, (Bb, di, ns))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if S < 1:
        raise ValueError("empty sequence")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if len({t.device for t in (dt, B, C, x, A, h0)}) != 1:
        raise ValueError("operands on different devices")


def mamba_scan_call(dt, B, C, x, A, h0, *, chunk: int):
    """``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = sum_n h_t C_t``
    from ``h0``.

    dt, x: (Bb, S, di); B, C: (Bb, S, ns); A: (di, ns); h0: (Bb, di, ns).
    Returns (y (Bb, S, di), h_final (Bb, di, ns)), float32. On CUDA every
    operand must be float32, contiguous and 16-byte aligned, di a multiple
    of 4 and ns 16; the kernel runs the recurrence step by step, so its
    result does not depend on ``chunk`` (the plain version's chunk
    length), runs on the current stream, and each launch adds one to
    ``mamba_scan_call.launches``. CPU tensors take the plain version and
    count nothing.
    """
    _check(dt, B, C, x, A, h0, chunk)
    if x.device.type == "cpu":
        return mamba_scan_plain(dt, B, C, x, A, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    Bb, S, di = x.shape
    if A.shape[1] != D_STATE:
        raise ValueError(
            f"the CUDA kernel is compiled for d_state {D_STATE}, got {A.shape[1]}"
        )
    ops = (dt, B, C, x, A, h0)
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("the CUDA kernel takes float32 dt, B, C, x, A, h0")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("dt, B, C, x, A, h0 must be contiguous")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("dt, B, C, x, A, h0 must be 16-byte aligned (TMA, float4 rows)")
    if di % 4:
        raise ValueError(f"d_inner must be a multiple of 4 (16-byte TMA rows), got {di}")
    if Bb > _GRID_Y_MAX:
        raise ValueError(f"batch {Bb} exceeds the grid's y limit")
    y = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            dt.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
            A.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            Bb, S, di, stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    mamba_scan_call.launches += 1
    return y, h_out


#: kernel launches since the count was last set to 0 (CUDA path only)
mamba_scan_call.launches = 0
