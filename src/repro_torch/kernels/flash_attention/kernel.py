"""Causal GQA flash attention on an NVIDIA H100, forward and backward.

`flash_attention_call` launches the CUDA kernel of
``repro_torch/csrc/flash_attention.cu`` for CUDA tensors and runs the
plain version (`ref.attention_plain`) for CPU tensors. For a CUDA
tensor it launches or raises; it never falls back. bf16 tensors go to
the tensor-core kernel (wgmma, K/V through TMA), fp32 tensors to the
SIMT kernel: one kernel per type. The kernel reads the model's
(B, S, heads, hd) tensors through their strides, so nothing is
transposed on either side of the call.

`flash_attention_backward_call` is its gradient: the kernels of
``repro_torch/csrc/flash_attention_bwd.cu`` for CUDA tensors, the plain
`ref.attention_backward_plain` for CPU tensors, with the same rule. It
takes the log-sum-exp that the forward returns with ``return_lse=True``
and recomputes no softmax statistics.

Both are ``torch.library`` custom ops (``repro_torch::flash_attention``
and ``repro_torch::flash_attention_backward``): the plain version is the
CPU kernel, the CUDA kernel the CUDA one, and the dispatcher routes by
device; an op has no other device's kernel, so a tensor elsewhere
raises. Each op has a fake implementation (its output shapes, for
``FakeTensorMode``) and a flop formula (`attention_flops`,
`attention_backward_flops`, the operation counts `chip_smoke.py`'s
bounds use), so a traced step sees the kernel's shapes and operations,
not the plain version's (S, S) scores. `forward_cuda` and
`backward_cuda` are the direct kernel calls behind the CUDA kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch._build import load_library
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_plain,
    attention_plain,
)

_SYMBOLS = {torch.float32: "fa_forward_f32", torch.bfloat16: "fa_forward_bf16"}
_BWD_SYMBOLS = {torch.float32: "fa_backward_f32",
                torch.bfloat16: "fa_backward_bf16"}
#: head widths the CUDA kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
_BLOCK_Q = 64
_GRID_Y_MAX = 65535
_INT32_MAX = 2**31 - 1
#: TMA reads the bf16 operands from 16-byte aligned addresses
_ALIGN = 16


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention"), _SYMBOLS[dtype])
    fn.argtypes = [
        *[ctypes.c_void_p] * 5,  # q k v o lse (lse may be null)
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B S H Hkv
        ctypes.c_int, ctypes.c_int,  # hd, causal
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_kernel(dtype: torch.dtype):
    fn = getattr(load_library("flash_attention_bwd"), _BWD_SYMBOLS[dtype])
    fn.argtypes = [
        *[ctypes.c_void_p] * 10,  # q k v o do lse dq dk dv delta
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


def _check_cuda(tensors) -> None:
    """What the CUDA kernels take beyond `_check`: contiguous operands,
    head width in `HEAD_DIMS`, a grid within the card's limits."""
    q = tensors[0]
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    if B * H > _INT32_MAX or -(-S // _BLOCK_Q) > _GRID_Y_MAX:
        raise ValueError(f"grid too large for B*H={B * H}, S={S}")


def attention_flops(B, S, H, hd, causal=True) -> float:
    """Operations of the attention function: 4 * hd per (query, key)
    pair it keeps (s = q kᵀ and o = p v, 2 * hd each), the keys at or
    before the query when causal."""
    pairs = S * (S + 1) / 2 if causal else float(S * S)
    return 4.0 * hd * B * H * pairs


def attention_backward_flops(B, S, H, hd, causal=True) -> float:
    """Operations of its gradient: five products of 2 * hd per kept
    (query, key) pair (s, dP, dV, dQ, dK)."""
    return 2.5 * attention_flops(B, S, H, hd, causal)


def _no_lse(q):
    """The empty log-sum-exp a forward returns when not asked for one."""
    return q.new_empty((0,), dtype=torch.float32)


def forward_cuda(q, k, v, causal: bool = True, return_lse: bool = False):
    """The direct kernel call: (out, lse) from one launch of the CUDA
    kernel (lse empty unless ``return_lse``). Checks what the kernel
    takes and adds one to ``flash_attention_call.launches``."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda((q, k, v))
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % _ALIGN for t in (q, k, v)
    ):
        raise ValueError(f"bf16 q, k and v must be {_ALIGN}-byte aligned")
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else _no_lse(q))
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            B, S, H, k.shape[2], hd, int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_call.launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                       return_lse: bool) -> tuple[Tensor, Tensor]:
    """(out, lse): the plain version on the CPU, the kernel on CUDA."""
    if return_lse:
        out, lse = attention_plain(q, k, v, causal=causal, return_lse=True)
        return out.contiguous(), lse.contiguous()
    return attention_plain(q, k, v, causal=causal).contiguous(), _no_lse(q)


flash_attention_op.register_kernel("cuda")(forward_cuda)


@flash_attention_op.register_fake
def _(q, k, v, causal, return_lse):
    B, S, H, _ = q.shape
    lse = (q.new_empty((B, H, S), dtype=torch.float32) if return_lse
           else _no_lse(q))
    return torch.empty_like(q), lse


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, return_lse, *, out_shape=None, **kw):
    B, S, H, hd = q_shape
    return int(attention_flops(B, S, H, hd, causal))


def flash_attention_call(q, k, v, *, causal: bool = True,
                         return_lse: bool = False):
    """softmax(q kᵀ · hd^-½) v per head, causal by default.

    q: (B, S, H, hd); k, v: (B, S, Hkv, hd) with H a multiple of Hkv;
    all float32 or all bfloat16, on one device. Returns (B, S, H, hd) in
    q's dtype; with ``return_lse``, ``(out, lse)``, lse (B, H, S) fp32
    each row's log-sum-exp of the scaled scores in base 2 (what
    `flash_attention_backward_call` takes). ``out`` is the same bits
    either way. On CUDA the tensors must be contiguous (bf16 ones also
    16-byte aligned) and hd 16, 32, 64 or 128; the kernel runs on the current
    stream and each launch adds one to ``flash_attention_call.launches``.
    CPU tensors take the plain version and count nothing. The call goes
    through the ``repro_torch::flash_attention`` op.
    """
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    out, lse = flash_attention_op(q, k, v, causal, return_lse)
    return (out, lse) if return_lse else out


#: kernel launches since the count was last set to 0 (CUDA path only)
flash_attention_call.launches = 0


def _check_backward(q, k, v, o, do, lse) -> None:
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must match q: {tuple(t.shape)} {t.dtype} against "
                f"{tuple(q.shape)} {q.dtype}"
            )
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    B, S, H, hd = q.shape
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be float32 {(B, H, S)}, got {lse.dtype} {tuple(lse.shape)}")
    if lse.device != q.device:
        raise ValueError(f"lse on {lse.device}, q on {q.device}")


def backward_cuda(q, k, v, o, do, lse, causal: bool = True):
    """The direct call of the backward kernels: (dq, dk, dv). Checks what
    the kernels take and adds one to
    ``flash_attention_backward_call.launches``."""
    _check_backward(q, k, v, o, do, lse)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda((q, k, v, o, do, lse))
    B, S, H, hd = q.shape
    if any(t.data_ptr() % _ALIGN for t in (q, k, v, o, do)):
        raise ValueError(f"q, k, v, o and do must be {_ALIGN}-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)  # rowsum(dO * O) per (b, h, row), fp32
    fn = _backward_kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            B, S, H, k.shape[2], hd, int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward launch failed: CUDA error {err}")
    flash_attention_backward_call.launches += 1
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=(), device_types="cpu")
def flash_attention_backward_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                                do: Tensor, lse: Tensor, causal: bool
                                ) -> tuple[Tensor, Tensor, Tensor]:
    """(dq, dk, dv): the plain version on the CPU, the kernels on CUDA."""
    grads = attention_backward_plain(q, k, v, o, do, lse, causal=causal)
    return tuple(g.contiguous() for g in grads)


flash_attention_backward_op.register_kernel("cuda")(backward_cuda)


@flash_attention_backward_op.register_fake
def _(q, k, v, o, do, lse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(q_shape, k_shape, v_shape, o_shape, do_shape, lse_shape, causal, *,
      out_shape=None, **kw):
    B, S, H, hd = q_shape
    return int(attention_backward_flops(B, S, H, hd, causal))


def flash_attention_backward_call(q, k, v, o, do, lse, *, causal: bool = True):
    """Gradients (dq, dk, dv) of ``o, lse = flash_attention_call(q, k, v,
    return_lse=True)`` for the cotangent ``do`` of o.

    q, o, do: (B, S, H, hd); k, v: (B, S, Hkv, hd); all float32 or all
    bfloat16, on one device; lse: the forward's (B, H, S) fp32
    log-sum-exp, from which P is rebuilt. Returns dq like q and dk, dv
    like k, in q's dtype; dk and dv of a KV head sum over its group's
    query heads. On CUDA every tensor must be contiguous, q, k, v, o and
    do 16-byte aligned, and hd 16, 32, 64 or 128; the kernels run on the current
    stream, write each gradient element once (no atomics, so results are
    bit-identical from launch to launch), and a call adds one to
    ``flash_attention_backward_call.launches``. CPU tensors take the
    plain version and count nothing. The call goes through the
    ``repro_torch::flash_attention_backward`` op.
    """
    _check_backward(q, k, v, o, do, lse)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return flash_attention_backward_op(q, k, v, o, do, lse, causal)


#: backward calls that launched the kernels since the count was last set
#: to 0 (CUDA path only)
flash_attention_backward_call.launches = 0
