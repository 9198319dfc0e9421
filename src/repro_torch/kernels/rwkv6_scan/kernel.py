"""RWKV-6 WKV recurrence on an NVIDIA H100.

`rwkv6_scan_call` launches the CUDA kernel of
``repro_torch/csrc/rwkv6_scan.cu`` for CUDA tensors and runs the plain
version (`ref.rwkv6_scan_plain`) for CPU tensors. For a CUDA tensor it
launches or raises; it never falls back. The kernel reads the model's
(B, S, H, hd) tensors through TMA tensor maps, STAGE_STEPS steps at a
time, and writes y through their strides.

`rwkv6_scan_backward_call` is its gradient: the kernels of
``repro_torch/csrc/rwkv6_scan_bwd.cu`` for CUDA tensors, the plain
`ref.rwkv6_scan_backward_plain` for CPU tensors, with the same rule.

Both are ``torch.library`` custom ops (``repro_torch::rwkv6_scan`` and
``repro_torch::rwkv6_scan_backward``): the plain version is the CPU
kernel, the CUDA kernel the CUDA one, and the dispatcher routes by
device. Each has a fake implementation and a flop formula (`wkv_flops`,
`wkv_backward_flops`, the counts `chip_smoke.py`'s bounds use).
`forward_cuda` and `backward_cuda` are the direct kernel calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch._build import load_library
from repro_torch.kernels.rwkv6_scan.ref import (
    rwkv6_scan_backward_plain,
    rwkv6_scan_plain,
)

#: head width the CUDA kernel is compiled for
HEAD_DIM = 64
#: longest chunk the plain (chunked) version is exact for under the
#: model's decay clamp; the JAX kernel has the same limit
MAX_CHUNK = 64
#: time steps the CUDA kernel stages per TMA box (``kT`` in the source)
STAGE_STEPS = 32
#: steps between the states the backward kernels stash, and the column
#: groups their state is split into (``kStash`` and ``kGroups`` in
#: ``rwkv6_scan_bwd.cu``)
BWD_CHUNK, BWD_GROUPS = 32, 4
_INT32_MAX = 2**31 - 1
#: fp32 FMA-class operations the backward needs per state element and
#: step: the states again (w S + k v: 3), S dy (2), G's update (3), G v
#: (2), Gᵀ k (2); dw's walk and the bonus term are O(hd) a step
BWD_FLOPS = 12


def wkv_flops(B, S, H, hd) -> float:
    """Operations of WKV-6, per step and head: the state update w * S +
    k vᵀ is 3 per state element and rᵀ S is 2; the bonus rᵀ diag(u) k vᵀ
    is (sum_i r_i u_i k_i) v, 3 per row to reduce and 2 per column."""
    return float(B * S * H) * (5 * hd * hd + 5 * hd)


def wkv_backward_flops(B, S, H, hd) -> float:
    """Operations of its gradient: BWD_FLOPS per state element and step."""
    return float(BWD_FLOPS) * B * S * H * hd * hd


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


@functools.cache
def _backward_kernel():
    fn = load_library("rwkv6_scan_bwd").wkv6_backward_f32
    fn.argtypes = [
        *[ctypes.c_void_p] * 7,  # r k v w u dy ds_final (may be null)
        *[ctypes.c_void_p] * 5,  # dr dk dv dw du
        ctypes.c_void_p, ctypes.c_void_p,  # du_part, stash (scratch)
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


def _check_cuda(shape, ops, *, aligned, why) -> None:
    """What the CUDA kernels take, forward and backward: hd 64, float32,
    contiguous, ``aligned`` on 16 bytes (``why``), B*H within the grid."""
    B, _, H, hd = shape
    if hd != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head size {HEAD_DIM}, got {hd}")
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("the CUDA kernel takes float32 operands")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("every operand must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"operands must be 16-byte aligned ({why})")
    if B * H > _INT32_MAX:
        raise ValueError(f"grid too large for B*H={B * H}")


def forward_cuda(r, k, v, w, u, chunk: int = MAX_CHUNK):
    """The direct kernel call: (y, S_final) from one launch. Checks what
    the kernel takes and adds one to ``rwkv6_scan_call.launches``."""
    _check(r, k, v, w, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    B, S, H, hd = r.shape
    _check_cuda(r.shape, (r, k, v, w, u), aligned=(r, k, v, w), why="TMA")
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


@torch.library.custom_op("repro_torch::rwkv6_scan", mutates_args=(),
                         device_types="cpu")
def rwkv6_scan_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                  chunk: int) -> tuple[Tensor, Tensor]:
    """(y, S_final): the plain version on the CPU, the kernel on CUDA."""
    y, s_final = rwkv6_scan_plain(r, k, v, w, u, chunk=chunk)
    return y.contiguous(), s_final.contiguous()


rwkv6_scan_op.register_kernel("cuda")(forward_cuda)


@rwkv6_scan_op.register_fake
def _(r, k, v, w, u, chunk):
    B, _, H, hd = r.shape
    return torch.empty_like(r), r.new_empty((B, H, hd, hd))


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan)
def _(r_shape, *shapes, out_shape=None, **kw):
    return int(wkv_flops(*r_shape))


def rwkv6_scan_call(r, k, v, w, u, *, chunk: int = MAX_CHUNK):
    """WKV-6 from a zero state: ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ``,
    ``y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)``.

    r, k, v, w: (B, S, H, hd); u: (H, hd). Returns (y (B, S, H, hd),
    S_final (B, H, hd, hd)), float32. On CUDA every operand must be
    float32 and contiguous, r, k, v, w 16-byte aligned, and hd 64; the
    kernel is a step-by-step recurrence whose result does not depend on
    ``chunk``, runs on the current stream, and each launch adds one to
    ``rwkv6_scan_call.launches``. CPU tensors take the plain chunked
    version and count nothing. The call goes through the
    ``repro_torch::rwkv6_scan`` op.
    """
    _check(r, k, v, w, u, chunk)
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {r.device}")
    return rwkv6_scan_op(r, k, v, w, u, chunk)


#: kernel launches since the count was last set to 0 (CUDA path only)
rwkv6_scan_call.launches = 0


def _check_backward(r, k, v, w, u, dy, ds_final) -> list:
    _check(r, k, v, w, u, MAX_CHUNK)
    B, S, H, hd = r.shape
    if tuple(dy.shape) != (B, S, H, hd):
        raise ValueError(f"dy must be {(B, S, H, hd)}, got {tuple(dy.shape)}")
    if ds_final is not None and tuple(ds_final.shape) != (B, H, hd, hd):
        raise ValueError(
            f"ds_final must be {(B, H, hd, hd)}, got {tuple(ds_final.shape)}")
    ops = [t for t in (r, k, v, w, u, dy, ds_final) if t is not None]
    if len({t.device for t in ops}) != 1:
        raise ValueError("operands on different devices")
    return ops


def backward_cuda(r, k, v, w, u, dy, ds_final=None):
    """The direct call of the backward kernels: (dr, dk, dv, dw, du).
    Checks what they take and adds one to
    ``rwkv6_scan_backward_call.launches``."""
    ops = _check_backward(r, k, v, w, u, dy, ds_final)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    B, S, H, hd = r.shape
    _check_cuda(r.shape, ops, aligned=ops, why="cp.async")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, hd), dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    n_chunks = -(-S // BWD_CHUNK)
    stash = torch.empty((B, H, n_chunks, hd, hd), dtype=torch.float32,
                        device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(),
            None if ds_final is None else ds_final.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), du_part.data_ptr(), stash.data_ptr(), B, S, H, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward launch failed: CUDA error {err}")
    rwkv6_scan_backward_call.launches += 1
    return dr, dk, dv, dw, du




@torch.library.custom_op("repro_torch::rwkv6_scan_backward", mutates_args=(),
                         device_types="cpu")
def rwkv6_scan_backward_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor,
                           u: Tensor, dy: Tensor, ds_final: Tensor | None
                           ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(dr, dk, dv, dw, du): the plain version on the CPU, the kernels on
    CUDA."""
    grads = rwkv6_scan_backward_plain(r, k, v, w, u, dy, ds_final)
    return tuple(g.contiguous() for g in grads)


rwkv6_scan_backward_op.register_kernel("cuda")(backward_cuda)


@rwkv6_scan_backward_op.register_fake
def _(r, k, v, w, u, dy, ds_final):
    return (*(torch.empty_like(r) for _ in range(4)), torch.empty_like(u))


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan_backward)
def _(r_shape, *shapes, out_shape=None, **kw):
    return int(wkv_backward_flops(*r_shape))


def rwkv6_scan_backward_call(r, k, v, w, u, dy, ds_final=None):
    """Gradient of `rwkv6_scan_call`: the cotangents ``dy`` of y
    (B, S, H, hd) and ``ds_final`` of S_final (B, H, hd, hd; zero when
    None) to (dr, dk, dv, dw (B, S, H, hd), du (H, hd)), float32.

    On CUDA every operand must be float32, contiguous, 16-byte aligned
    (cp.async), and hd 64. The call runs three kernels on the current
    stream (a forward sweep, a reverse sweep over BWD_GROUPS column
    groups of the state, du's sum over the batch), with no atomics, so
    two calls give the same bits; each call adds one to
    ``rwkv6_scan_backward_call.launches``. Its scratch is the state
    after every BWD_CHUNK steps and after the last,
    (B, H, ceil(S / BWD_CHUNK), hd, hd) fp32. The
    decays must lie in (0, 1): the kernel takes dw as a difference of
    row sums divided by w, so dw's rounding grows as 1/w (about 2e-7 / w
    of its max; w 0.01 is within 1e-4), and w = 0 divides by zero. The
    model's decay clamp keeps w at or above 0.69. CPU tensors take the
    plain version (dw summed directly, no division) and count nothing.
    The call goes through the ``repro_torch::rwkv6_scan_backward`` op.
    """
    _check_backward(r, k, v, w, u, dy, ds_final)
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {r.device}")
    return rwkv6_scan_backward_op(r, k, v, w, u, dy, ds_final)


#: calls that launched the backward kernels since the count was last set
#: to 0 (CUDA path only)
rwkv6_scan_backward_call.launches = 0
