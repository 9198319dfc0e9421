"""Plain PyTorch version of causal GQA attention: the materialised fp32
attention of ``repro.kernels.flash_attention.ref.attention_ref``.

It is what `flash_attention_call` runs for CPU tensors and what the CUDA
kernel is held against on the card. Scores, softmax and the P V product
are fp32 (the kernel keeps the same statistics in fp32); the output is
cast to q's type.
"""
from __future__ import annotations

import torch

#: mask value of masked scores, as in the TPU kernel and its oracle
NEG_INF = -1e30

#: (rtol, floor) of the CUDA kernel against this plain version, element by
#: element: |got - want| <= rtol * |want| + floor * rms(want). Both keep
#: fp32 statistics and round the output once, so bf16 outputs are at most
#: one bf16 ulp apart, which is 2^-7 of |want| at worst; fp32 outputs
#: differ only in summation order and the online rescale. The floor covers
#: outputs that cancel to near 0, where rounding is absolute, not relative.
KERNEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0**-7, 1e-3)}


def attention_plain(q, k, v, *, causal: bool = True):
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd) -> (B, S, H, hd) in q's
    dtype. Query head ``h`` attends with KV head ``h // (H // Hkv)``."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qf = q.float().reshape(B, S, Hkv, group, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (hd**-0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def tol_ratio(got, want) -> float:
    """Largest ``|got - want| / (rtol |want| + floor rms(want))`` over the
    elements, with (rtol, floor) = ``KERNEL_TOL[want.dtype]``: the kernel
    agrees with the plain version where this is <= 1. Each element is
    held to its own size, so a wrong late row of causal attention (whose
    values are far smaller than row 0's) cannot hide behind the largest."""
    rtol, floor = KERNEL_TOL[want.dtype]
    g, w = got.float(), want.float()
    limit = rtol * w.abs() + floor * w.square().mean().sqrt()
    return ((g - w).abs() / limit).max().item()
