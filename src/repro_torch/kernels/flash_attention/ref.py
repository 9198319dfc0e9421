"""Plain PyTorch versions of causal GQA attention and of its gradient:
the materialised fp32 attention of
``repro.kernels.flash_attention.ref.attention_ref``, and the gradient
formulas written out.

They are what `flash_attention_call` and `flash_attention_backward_call`
run for CPU tensors and what the CUDA kernels are held against on the
card. Scores, softmax and every product are fp32 (the kernels keep the
same statistics in fp32); outputs are cast to q's type.
"""
from __future__ import annotations

import torch

#: mask value of masked scores, as in the TPU kernel and its oracle
NEG_INF = -1e30
#: log2(e): the kernels keep the softmax statistics in base 2
LOG2E = 1.4426950408889634

#: (rtol, floor) of the CUDA kernel against this plain version, element by
#: element: |got - want| <= rtol * |want| + floor * rms(want). Both keep
#: fp32 statistics and round the output once, so bf16 outputs are at most
#: one bf16 ulp apart, which is 2^-7 of |want| at worst; fp32 outputs
#: differ only in summation order and the online rescale. The floor covers
#: outputs that cancel to near 0, where rounding is absolute, not relative.
KERNEL_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0**-7, 1e-3)}


#: (rtol, floor) of the backward kernel's dq, dk and dv against
#: `attention_backward_plain`, element by element as `KERNEL_TOL`. Both
#: sides take the same inputs (the forward's o among them), keep every
#: statistic and sum in fp32 and round each gradient once, so bf16
#: gradients are at most one bf16 ulp apart (2^-7 of |want|). They differ
#: in summation order (up to S queries times the group's heads for dk and
#: dv), in how P is rebuilt: the kernel as 2^(s log2(e) - lse) from the
#: forward kernel's log-sum-exp, the plain version as a normalised
#: softmax, ~1e-7 apart per probability, and, in bf16, in P and dS
#: entering the tensor cores as two bf16 terms each (16 bits of each
#: value; one bf16 term reads 7-31x this bound at S 1024-2048, pinned by
#: tests/test_torch_flash.py). dS = P (dP - D) cancels to near 0 in
#: many elements, so those are held to a floor of the gradient's rms
#: rather than to their own size: 1e-4 of it in fp32, where order
#: differences read ~1e-6, and 1e-3 in bf16, where one ulp of a small
#: element is absolute.
BACKWARD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2.0**-7, 1e-3)}


def attention_plain(q, k, v, *, causal: bool = True, return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, S, Hkv, hd) -> (B, S, H, hd) in q's
    dtype. Query head ``h`` attends with KV head ``h // (H // Hkv)``.

    With ``return_lse`` it returns ``(out, lse)``: lse (B, H, S) fp32 is
    each row's log-sum-exp of the scaled, masked scores in base 2,
    ``logsumexp(s) · log2(e)``, the statistic the kernels keep."""
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
    out = out.reshape(B, S, H, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, (torch.logsumexp(s, -1) * LOG2E).reshape(B, H, S)


def attention_backward_plain(q, k, v, o, do, lse=None, *, causal: bool = True):
    """Gradients of `attention_plain` at (q, k, v), given its output
    ``o`` and the output's cotangent ``do``, both (B, S, H, hd).

    With P the causal softmax of s = q kᵀ / √hd:
    dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO ∘ O), dS = P ∘ (dP − D),
    dQ = dS K / √hd, dK = dSᵀ Q / √hd, in fp32. dK and dV of a KV head
    sum over the query heads of its group. P is the normalised softmax,
    or, given the forward's ``lse`` (B, H, S, base 2, as
    ``attention_plain(..., return_lse=True)`` returns it), rebuilt as
    2^(s log2(e) − lse), as the kernels rebuild it. Returns (dq, dk, dv)
    in q's dtype."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = hd**-0.5
    qf = q.float().reshape(B, S, Hkv, group, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, Hkv, group, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    if lse is None:
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
    else:
        p = torch.exp2(s * LOG2E - lse.float().reshape(B, Hkv, group, S)[..., None])
    del s
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dof * o.float().reshape(B, S, Hkv, group, hd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    del p, dp
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def tol_ratio(got, want, tol=KERNEL_TOL) -> float:
    """Largest ``|got - want| / (rtol |want| + floor rms(want))`` over the
    elements, with (rtol, floor) = ``tol[want.dtype]`` (`KERNEL_TOL` for
    the forward, `BACKWARD_TOL` for a gradient): the kernel agrees with
    the plain version where this is <= 1. Each element is held to its own
    size, so a wrong late row of causal attention (whose values are far
    smaller than row 0's) cannot hide behind the largest."""
    rtol, floor = tol[want.dtype]
    g, w = got.float(), want.float()
    limit = rtol * w.abs() + floor * w.square().mean().sqrt()
    return ((g - w).abs() / limit).max().item()
