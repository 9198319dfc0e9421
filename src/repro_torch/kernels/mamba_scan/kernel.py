"""Selective scan (Mamba) on an NVIDIA H100.

`mamba_scan_call` launches the CUDA kernel of
``repro_torch/csrc/mamba_scan.cu`` for CUDA tensors and runs the plain
version (`ref.mamba_scan_plain`) for CPU tensors. For a CUDA tensor it
launches or raises; it never falls back. The kernel reads dt, x, B and C
and writes y through TMA tensor maps, STAGE_STEPS steps at a time.

`mamba_scan_backward_call` is its gradient: the kernels of
``repro_torch/csrc/mamba_scan_bwd.cu`` for CUDA tensors, the plain
`ref.mamba_scan_backward_plain` for CPU tensors, with the same rule.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._build import load_library
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_backward_plain,
    mamba_scan_plain,
)

#: d_state the CUDA kernel is compiled for (Jamba's)
D_STATE = 16
#: time steps the CUDA kernel stages per TMA box (``kT`` in the source)
STAGE_STEPS = 32
#: steps between the states the backward kernels stash, and channels
#: per block (``kT`` and ``kChan`` in ``mamba_scan_bwd.cu``)
BWD_CHUNK, BWD_CHANNELS = 8, 128
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


@functools.cache
def _backward_kernel():
    fn = load_library("mamba_scan_bwd").mamba_scan_backward_f32
    fn.argtypes = [
        *[ctypes.c_void_p] * 8,  # dt B C x A h0 dy dh_final (may be null)
        *[ctypes.c_void_p] * 6,  # ddt dB dC dx dA dh0
        *[ctypes.c_void_p] * 3,  # stash, bc_part, da_part (scratch)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Bb S di
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(ops, x, A) -> None:
    """What the CUDA kernels take, forward and backward."""
    Bb, S, di = x.shape
    if A.shape[1] != D_STATE:
        raise ValueError(
            f"the CUDA kernel is compiled for d_state {D_STATE}, got {A.shape[1]}"
        )
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("the CUDA kernel takes float32 operands")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("every operand must be 16-byte aligned (TMA, float4 rows)")
    if di % 4:
        raise ValueError(f"d_inner must be a multiple of 4 (16-byte rows), got {di}")
    if Bb > _GRID_Y_MAX:
        raise ValueError(f"batch {Bb} exceeds the grid's y limit")


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
    _check_cuda((dt, B, C, x, A, h0), x, A)
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


def mamba_scan_backward_call(dt, B, C, x, A, h0, dy, dh_final=None, *,
                             chunk: int):
    """Gradient of `mamba_scan_call`: the cotangents ``dy`` of y
    (Bb, S, di) and ``dh_final`` of h_final (Bb, di, ns; zero when None)
    to (ddt, dB, dC, dx, dA, dh0) in the inputs' shapes, float32.

    On CUDA the operands are taken as `mamba_scan_call` takes them. The
    call runs four kernels on the current stream (a pass that stashes h
    every BWD_CHUNK steps, the reverse sweep, the sums of dB, dC over
    d_inner and of dA over the batch), with no atomics, so two calls give
    the same bits; each call adds one to
    ``mamba_scan_backward_call.launches``. Its scratch is
    (Bb, ceil(S / BWD_CHUNK), di, ns) states and
    (Bb, S, ceil(di / BWD_CHANNELS), 2 ns) partial sums, fp32. CPU
    tensors take the plain version (chunked by ``chunk``) and count
    nothing.
    """
    _check(dt, B, C, x, A, h0, chunk)
    Bb, S, di = x.shape
    if tuple(dy.shape) != (Bb, S, di):
        raise ValueError(f"dy must be {(Bb, S, di)}, got {tuple(dy.shape)}")
    if dh_final is not None and tuple(dh_final.shape) != tuple(h0.shape):
        raise ValueError(
            f"dh_final must be {tuple(h0.shape)}, got {tuple(dh_final.shape)}")
    ops = [t for t in (dt, B, C, x, A, h0, dy, dh_final) if t is not None]
    if len({t.device for t in ops}) != 1:
        raise ValueError("operands on different devices")
    if x.device.type == "cpu":
        return mamba_scan_backward_plain(dt, B, C, x, A, h0, dy, dh_final,
                                         chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(ops, x, A)
    ns = A.shape[1]
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA, dh0 = torch.empty_like(A), torch.empty_like(h0)
    stash = torch.empty((Bb, -(-S // BWD_CHUNK), di, ns), dtype=torch.float32,
                        device=x.device)
    bc_part = torch.empty((Bb, S, -(-di // BWD_CHANNELS), 2 * ns),
                          dtype=torch.float32, device=x.device)
    da_part = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_kernel()(
            dt.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(),
            A.data_ptr(), h0.data_ptr(), dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), dx.data_ptr(),
            dA.data_ptr(), dh0.data_ptr(), stash.data_ptr(), bc_part.data_ptr(),
            da_part.data_ptr(), Bb, S, di, stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan backward launch failed: CUDA error {err}")
    mamba_scan_backward_call.launches += 1
    return ddt, dB, dC, dx, dA, dh0


#: calls that launched the backward kernels since the count was last set
#: to 0 (CUDA path only)
mamba_scan_backward_call.launches = 0
