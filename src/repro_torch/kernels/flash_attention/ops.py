"""Public flash-attention API over (B, S, H, hd) activations."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_call,
    flash_attention_call,
)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient. The
    forward's q, k, v, output and log-sum-exp are saved; under activation
    checkpointing they are dropped and the forward runs again."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_call(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        # the CUDA kernels take contiguous operands only; the cotangent
        # arrives in whatever layout the next op's gradient left it
        q, k, v, o, lse = (t.contiguous() for t in ctx.saved_tensors)
        dq, dk, dv = flash_attention_backward_call(
            q, k, v, o, do.contiguous(), lse, causal=ctx.causal
        )
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal GQA attention. q: (B, S, H, hd); k/v: (B, S, Hkv, hd).

    Returns (B, S, H, hd) in q's dtype; softmax statistics and the
    accumulator are fp32. Any S is taken as it is: the CUDA kernel masks
    its ragged last block, so no block size has to divide S (the JAX
    wrapper shrinks its blocks to a divisor of S instead).

    Differentiable: where grad is enabled and an input requires it, the
    forward also writes each row's log-sum-exp and the call records
    `flash_attention_backward_call` as its gradient. With grad off
    (serving, under ``torch.inference_mode``) it is the forward kernel
    alone, with no log-sum-exp.
    """
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_call(q, k, v, causal=causal)
