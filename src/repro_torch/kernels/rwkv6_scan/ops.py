"""Public API for the RWKV-6 WKV scan."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.kernel import (
    MAX_CHUNK,
    rwkv6_scan_backward_call,
    rwkv6_scan_call,
)

DEFAULT_CHUNK = MAX_CHUNK


class _WKV6(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.
    r, k, v, w and u are saved; the backward recomputes the states."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        y, s_final = rwkv6_scan_call(r, k, v, w, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, w, u = ctx.saved_tensors
        # the CUDA kernels take contiguous operands only; a cotangent
        # arrives in whatever layout the next op's gradient left it
        dy = torch.zeros_like(r) if dy is None else dy.float().contiguous()
        if ds_final is not None:
            ds_final = ds_final.float().contiguous()
        grads = rwkv6_scan_backward_call(r, k, v, w, u, dy, ds_final)
        return (*grads, None)


def rwkv6_scan(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK):
    """WKV-6 recurrence over (B, S, H, hd) tensors from a zero state.

    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``;
    ``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``.
    Returns (y (B, S, H, hd) fp32, S_final (B, H, hd, hd) fp32).
    ``chunk`` is the plain (CPU) version's chunk length, at most 64.

    Differentiable: where grad is enabled and an input requires it, the
    call records `rwkv6_scan_backward_call` as its gradient. With grad
    off (serving) it is the forward kernel alone.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u)
    ):
        return _WKV6.apply(r, k, v, w, u, chunk)
    return rwkv6_scan_call(r, k, v, w, u, chunk=chunk)
