"""Mamba (selective SSM) block, Jamba's mixer layer (the counterpart of
``repro.models.ssm``).

The full-sequence selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t`` goes through `mamba_scan`: the hand-written step-by-step CUDA
kernel on the card, the chunked scan of the JAX model (chunks of
``cfg.mamba_chunk``, chained by the carried state) on the CPU; under
grad its gradient is the hand-written backward kernels
(``csrc/mamba_scan_bwd.cu``) on the card and their plain version on the
CPU.

Decode keeps ``(conv, ssm)`` states and advances one token in plain
tensor code, as the reference does. The bf16 rounding points are the
reference's: the causal conv sums its ``dc`` products in order in the
activations' dtype, ``dt``, ``B``, ``C``, the scan and the skip term are
fp32, and the scan output is cast back before the gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import dense_init, ones, zeros


def mamba_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d, di, ns, dc = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    a = torch.arange(1, ns + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype, device=device),
        "conv_w": (torch.randn((dc, di), generator=gen, dtype=torch.float32,
                               device=device) * 0.1).to(dtype),
        "conv_b": zeros((di,), dtype, device=device),
        "x_proj": dense_init(gen, di, dt_rank + 2 * ns, dtype, device=device),
        "dt_proj": dense_init(gen, dt_rank, di, dtype, device=device),
        # softplus^-1(0.01)
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32, device=device),
        "A_log": torch.log(a).expand(di, ns).contiguous(),  # (di, ns) fp32
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device=device),
        "norm": ones((d,), dtype, device=device),
    }


def _split_xproj(p, xs, cfg):
    """(dt, B, C): dt = softplus(dt_proj(.) + dt_bias) and B, C, all fp32."""
    dt_rank = p["dt_proj"].shape[0]
    ns = cfg.mamba_d_state
    proj = xs @ p["x_proj"]
    dt, B, C = torch.split(proj, [dt_rank, ns, ns], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).float() + p["dt_bias"])  # (..., di)
    return dt, B.float(), C.float()


def _causal_conv(p, x, cfg):
    """Depthwise causal conv over time. x: (B, S, di). The ``dc``
    products are summed in order, in x's dtype."""
    dc = cfg.mamba_d_conv
    S = x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = sum(pad[:, i : i + S, :] * p["conv_w"][i] for i in range(dc))
    return F.silu(out + p["conv_b"])


def mamba(p, x, cfg):
    """Full-sequence mamba mixer. x: (B, S, d)."""
    return _mamba_impl(p, x, cfg)[0]


def mamba_prefill(p, x, cfg):
    """Full-sequence mixer that also emits the decode cache
    ``{"conv": (B, dc-1, di) bf16, "ssm": (B, di, ns) fp32}``."""
    return _mamba_impl(p, x, cfg)


def _mamba_impl(p, x, cfg):
    Bb, S, _ = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = xn @ p["in_proj"]
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs = _causal_conv(p, xs, cfg)
    dt, Bt, Ct = _split_xproj(p, xs, cfg)
    A = -torch.exp(p["A_log"])  # (di, ns)
    xs_f = xs.float()
    y, h_final = mamba_scan(dt, Bt, Ct, xs_f, A, chunk=cfg.mamba_chunk)
    y = y + xs_f * p["D"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    # the conv cache holds the last dc-1 pre-conv inputs: recompute them
    # from the last dc-1 normed inputs, as the reference does
    dc = cfg.mamba_d_conv
    xz_tail = rms_norm(x[:, S - (dc - 1) :], p["norm"], cfg.norm_eps) @ p["in_proj"]
    conv_cache = torch.chunk(xz_tail, 2, dim=-1)[0].to(torch.bfloat16)
    return x + out, {"conv": conv_cache.contiguous(), "ssm": h_final}


def mamba_cache_init(cfg, batch: int, dtype=torch.float32, *, device="cuda"):
    di, ns, dc = cfg.d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": torch.zeros((batch, dc - 1, di), dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, di, ns), dtype=dtype, device=device),
    }


def mamba_decode(p, x, cfg, cache):
    """One-token decode. x: (B, 1, d). Returns (out, new cache). As in
    the reference, the conv window takes the promoted dtype of the cache
    (bf16) and the new input, so an fp32 model's conv cache becomes fp32
    after its first decode step."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xz = xn @ p["in_proj"]
    xs, z = torch.chunk(xz, 2, dim=-1)  # (B, 1, di)
    wdt = torch.promote_types(cache["conv"].dtype, xs.dtype)
    window = torch.cat([cache["conv"].to(wdt), xs.to(wdt)], dim=1)  # (B, dc, di)
    cdt = torch.promote_types(wdt, p["conv_w"].dtype)
    conv_out = torch.einsum("btd,td->bd", window.to(cdt), p["conv_w"].to(cdt))
    xs1 = F.silu(conv_out + p["conv_b"])[:, None, :]  # (B, 1, di)
    dt, Bt, Ct = _split_xproj(p, xs1, cfg)
    A = -torch.exp(p["A_log"])
    xs1_f = xs1[:, 0].float()
    a = torch.exp(dt[:, 0, :, None] * A)  # (B, di, ns)
    b = (dt[:, 0] * xs1_f)[..., None] * Bt[:, 0, None, :]
    h = a * cache["ssm"] + b
    y = torch.einsum("bdn,bn->bd", h, Ct[:, 0])
    y = y + xs1_f * p["D"]
    out = (y[:, None, :].to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return x + out, {"conv": window[:, 1:], "ssm": h}
