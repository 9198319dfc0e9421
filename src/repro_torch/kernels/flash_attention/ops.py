"""Public flash-attention API over (B, S, H, hd) activations."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_call


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal GQA attention. q: (B, S, H, hd); k/v: (B, S, Hkv, hd).

    Returns (B, S, H, hd) in q's dtype; softmax statistics and the
    accumulator are fp32. Any S is taken as it is: the CUDA kernel masks
    its ragged last block, so no block size has to divide S (the JAX
    wrapper shrinks its blocks to a divisor of S instead).
    """
    return flash_attention_call(q, k, v, causal=causal)
