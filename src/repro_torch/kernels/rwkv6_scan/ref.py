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


def rwkv6_scan_backward_plain(r, k, v, w, u, dy, ds_final=None, *,
                              chunk: int = 32):
    """Gradient of WKV-6 from a zero state, step by step in fp32.

    r, k, v, w, dy: (B, S, H, hd); u: (H, hd); ds_final: (B, H, hd, hd),
    the cotangent of S_final (zero when None). With G_t the adjoint of
    the state after step t (G_{S-1} = ds_final,
    G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ):

        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = G_t v_t + u r_t (v_t . dy_t)
        dv_t = G_tᵀ k_t + (sum_i r_t u k_t) dy_t
        dw_t = rowsum(G_t * S_{t-1})
        du   = sum over b, t of r_t k_t (v_t . dy_t)

    The states are kept at the start of every ``chunk`` steps and each
    chunk's are recomputed in the reverse sweep, so memory is
    S / chunk + 2 * chunk states. Returns (dr, dk, dv, dw, du), float32,
    in the inputs' layouts.
    """
    B, S, H, hd = r.shape
    rf, kf, vf, wf, dyf = (t.float().transpose(1, 2) for t in (r, k, v, w, dy))
    uf = u.float()[None, :, None, :]  # (1, H, 1, hd)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    starts = []
    for c0 in range(0, S, chunk):
        starts.append(state)
        for t in range(c0, min(c0 + chunk, S)):
            state = wf[:, :, t, :, None] * state + (
                kf[:, :, t, :, None] * vf[:, :, t, None, :])
    G = (torch.zeros_like(state) if ds_final is None
         else ds_final.float().clone())
    vdy = (vf * dyf).sum(-1, keepdim=True)  # (B, H, S, 1)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    for ci in reversed(range(len(starts))):
        c0, c1 = ci * chunk, min(ci * chunk + chunk, S)
        prev, state = [], starts[ci]
        for t in range(c0, c1):
            prev.append(state)  # S_{t-1}
            state = wf[:, :, t, :, None] * state + (
                kf[:, :, t, :, None] * vf[:, :, t, None, :])
        gs = [None] * (c1 - c0)
        for t in range(c1 - 1, c0 - 1, -1):
            gs[t - c0] = G  # G_t
            G = wf[:, :, t, :, None] * G + rf[:, :, t, :, None] * dyf[:, :, t, None, :]
        prev, gs = torch.stack(prev, 2), torch.stack(gs, 2)  # (B, H, c, hd, hd)
        sl = slice(c0, c1)
        r_c, k_c, v_c, dy_c, vdy_c = (t[:, :, sl] for t in (rf, kf, vf, dyf, vdy))
        dr[:, :, sl] = torch.einsum("bhcij,bhcj->bhci", prev, dy_c) + uf * k_c * vdy_c
        dk[:, :, sl] = torch.einsum("bhcij,bhcj->bhci", gs, v_c) + uf * r_c * vdy_c
        dv[:, :, sl] = (torch.einsum("bhcij,bhci->bhcj", gs, k_c)
                        + (r_c * uf * k_c).sum(-1, keepdim=True) * dy_c)
        dw[:, :, sl] = (gs * prev).sum(-1)
        del prev, gs
    du = (rf * kf * vdy).sum((0, 2))
    return (*(t.transpose(1, 2) for t in (dr, dk, dv, dw)), du)
