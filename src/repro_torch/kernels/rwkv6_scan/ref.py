"""Plain PyTorch version of the WKV-6 recurrence: the chunked (GLA)
form of ``repro.models.rwkv._tmix_impl``, so that the CPU path follows
the JAX model's arithmetic.

Within a chunk, cumulative log-decays turn the recurrence into an
intra-chunk strictly-lower-triangular product and an inter-chunk carry;
``k / max(W, 1e-30)`` stays in fp32 range only because the model clamps
its decay logits (``models.rwkv._DECAY_CLAMP``) and chunks are at most
64 long. It is what `rwkv6_scan_call` runs for CPU tensors and what the
CUDA kernel (a step-by-step recurrence) is held against on the card.
"""
from __future__ import annotations

import torch


def chunk_size(chunk: int, S: int) -> int:
    """The chunk the model uses for length S: ``min(chunk, S)`` halved
    until it divides S."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def rwkv6_scan_plain(r, k, v, w, u, *, chunk: int = 64):
    """r/k/v/w: (B, S, H, hd); u: (H, hd). Zero initial state.

    Returns (y (B, S, H, hd), S_final (B, H, hd, hd)), both float32.
    """
    B, S, H, hd = r.shape
    c = chunk_size(chunk, S)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    u = u.float()
    mask = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for start in range(0, S, c):
        sl = slice(start, start + c)
        rc, kc, vc, wc = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        logw = torch.log(wc)
        cumw = torch.cumsum(logw, dim=1)  # log prod_{s<=t} w_s
        w_incl = torch.exp(cumw)
        w_prev = torch.exp(cumw - logw)  # prod_{s<=t-1} w_s
        rw = rc * w_prev
        y_inter = torch.einsum("bchd,bhde->bche", rw, state)
        kw = kc / torch.clamp_min(w_incl, 1e-30)  # k_j / prod_{s<=j} w_s
        att = torch.einsum("bchd,bjhd->bhcj", rw, kw)
        att = torch.where(mask, att, torch.zeros((), device=r.device))
        y_intra = torch.einsum("bhcj,bjhe->bche", att, vc)
        diag = torch.einsum("bchd,hd,bchd->bch", rc, u, kc)
        ys.append(y_inter + y_intra + diag[..., None] * vc)
        w_tot = torch.exp(cumw[:, -1])  # (B, H, hd)
        k_scale = kc * torch.exp(cumw[:, -1][:, None] - cumw)  # prod_{s>j} w_s
        state = w_tot[..., None] * state + torch.einsum(
            "bjhd,bjhe->bhde", k_scale, vc
        )
    return torch.cat(ys, dim=1), state
