"""Public API for the selective scan."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import (
    mamba_scan_backward_call,
    mamba_scan_call,
)

DEFAULT_CHUNK = 64


class _Scan(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.
    dt, B, C, x, A and h0 are saved; the backward recomputes the states."""

    @staticmethod
    def forward(ctx, dt, B, C, x, A, h0, chunk):
        y, h_final = mamba_scan_call(dt, B, C, x, A, h0, chunk=chunk)
        ctx.save_for_backward(dt, B, C, x, A, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        dt, B, C, x, A, h0 = ctx.saved_tensors
        # the CUDA kernels take contiguous operands only
        dy = torch.zeros_like(x) if dy is None else dy.float().contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        grads = mamba_scan_backward_call(dt, B, C, x, A, h0, dy, dh_final,
                                         chunk=ctx.chunk)
        return (*grads, None)


def mamba_scan(dt, B, C, x, A, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """Selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
    ``y_t = <h_t, C_t>``.

    dt, x: (Bb, S, di); B, C: (Bb, S, ns); A: (di, ns); h0: (Bb, di, ns),
    zero when None. Operands are taken as contiguous float32. Returns
    (y (Bb, S, di), h_final (Bb, di, ns)), float32. ``chunk`` is the
    plain (CPU) version's chunk length, shrunk to a divisor of S as the
    JAX wrapper does; the CUDA kernel does not chunk.

    Differentiable: where grad is enabled and an input requires it, the
    call records `mamba_scan_backward_call` as its gradient. With grad
    off (serving) it is the forward kernel alone.
    """
    if h0 is None:
        Bb, _, di = x.shape
        h0 = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                         device=x.device)
    ops = [t.float().contiguous() for t in (dt, B, C, x, A, h0)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        return _Scan.apply(*ops, chunk)
    return mamba_scan_call(*ops, chunk=chunk)
