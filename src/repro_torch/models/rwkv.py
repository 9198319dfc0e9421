"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix
(the counterpart of ``repro.models.rwkv``).

Recurrence per head (hd = head size), per key-channel ``i``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with data-dependent decay ``w_t = exp(-exp(logit_t))`` produced by a
low-rank projection of the shifted input. The full-sequence recurrence
goes through `rwkv6_scan`: the hand-written step-by-step CUDA kernel on
the card, the chunked (GLA) form of the JAX model on the CPU; under
grad its gradient is the hand-written backward kernels
(``csrc/rwkv6_scan_bwd.cu``) on the card and their plain version on
the CPU. Decay
logits are clamped so that the chunked form's cumulative ratios stay in
fp32 range for chunks of up to 64. The one-token decode functions are
plain tensor ops, as in the reference. ``entry_pin`` and ``head_pin``
are the reference's activation pins (the normed input; r, k, v, w's
heads over ``model``); under them WKV-6 runs on each rank's heads
(`spmd.on_shards`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import dense_init, ones
from repro_torch.models.spmd import (
    is_sharded,
    merge_heads,
    on_shards,
    residual,
    split_heads,
)

_DECAY_CLAMP = (-8.0, -1.0)  # log-logit clamp: decay in ~[exp(-0.37), 1)
_LORA_RANK = 64


def rwkv_tmix_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d = cfg.d_model
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=device)

    return {
        "mix_r": half(),
        "mix_k": half(),
        "mix_v": half(),
        "mix_g": half(),
        "mix_w": half(),
        "wr": dense_init(gen, d, d, dtype, device=device),
        "wk": dense_init(gen, d, d, dtype, device=device),
        "wv": dense_init(gen, d, d, dtype, device=device),
        "wg": dense_init(gen, d, d, dtype, device=device),
        "wo": dense_init(gen, d, d, dtype, device=device),
        # data-dependent decay, low-rank
        "w_lora_a": dense_init(gen, d, _LORA_RANK, dtype, device=device),
        "w_lora_b": dense_init(gen, _LORA_RANK, d, dtype, device=device),
        "w0": torch.full((d,), -5.0, dtype=torch.float32, device=device),
        "u": torch.randn((H, hd), generator=gen, dtype=torch.float32,
                         device=device) * 0.1,
        "ln_x": ones((d,), dtype, device=device),
        "norm": ones((d,), dtype, device=device),
    }


def rwkv_cmix_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": dense_init(gen, d, f, dtype, device=device),
        "wv": dense_init(gen, f, d, dtype, device=device),
        "wr": dense_init(gen, d, d, dtype, device=device),
        "norm": ones((d,), dtype, device=device),
    }


def _shift(x, last=None):
    """Token shift; `last` (B, d) is the previous block-input token."""
    if last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = last[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _decay(p, xw):
    logit = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    logit = torch.clamp(logit, *_DECAY_CLAMP)
    return torch.exp(-torch.exp(logit))  # in (0, 1)


def _tmix_inputs(p, xn, cfg, last=None):
    sx = _shift(xn, last) - xn
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    B, S, d = xn.shape
    r = split_heads((xn + sx * p["mix_r"]) @ p["wr"], H, hd)
    k = split_heads((xn + sx * p["mix_k"]) @ p["wk"], H, hd)
    v = split_heads((xn + sx * p["mix_v"]) @ p["wv"], H, hd)
    g = F.silu((xn + sx * p["mix_g"]) @ p["wg"])
    w = split_heads(_decay(p, xn + sx * p["mix_w"]), H, hd)
    return r, k, v, g, w


def rwkv_tmix(p, x, cfg, chunk: int = 64, head_pin=None, entry_pin=None):
    """Full-sequence time-mix. x: (B, S, d)."""
    out, _ = _tmix_impl(p, x, cfg, chunk, head_pin, entry_pin)
    return out


def rwkv_tmix_prefill(p, x, cfg, chunk: int = 64, head_pin=None,
                      entry_pin=None):
    """Time-mix that also emits the decode state
    ``{"S": (B,H,hd,hd), "tmix_last": (B,d)}``."""
    return _tmix_impl(p, x, cfg, chunk, head_pin, entry_pin)


def _tmix_impl(p, x, cfg, chunk: int = 64, head_pin=None, entry_pin=None):
    B, S, d = x.shape
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if entry_pin is not None:
        xn = entry_pin(xn)
    r, k, v, g, w = _tmix_inputs(p, xn, cfg)
    if head_pin is not None:
        # heads are independent in the recurrence: shard them over model
        r, k, v, w = head_pin(r), head_pin(k), head_pin(v), head_pin(w)
    ops = (r.float(), k.float(), v.float(), w.float(), p["u"])
    scan = lambda *a: rwkv6_scan(*a, chunk=chunk)  # noqa: E731
    if is_sharded(r):
        hp = 2 if head_pin is not None else None
        y, S_final = on_shards(
            scan, ops, ((0, hp),) * 4 + ((None, 0 if hp else None),),
            ((0, hp), (0, 1 if hp else None)), (r.shape, (B, H, hd, hd)))
    else:
        y, S_final = scan(*ops)
    y = rms_norm(merge_heads(y).to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = residual(x, (y * g) @ p["wo"])
    return out, {"S": S_final, "tmix_last": xn[:, -1].to(torch.bfloat16)}


def rwkv_cmix_prefill(p, x, cfg, entry_pin=None):
    """Channel-mix that also emits ``cmix_last`` (B, d). ``entry_pin`` is
    the port's: the reference leaves this input to GSPMD, but DTensor
    cannot flatten a (B, S) sharded over both for the products."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    out = rwkv_cmix(p, x, cfg, entry_pin=entry_pin)
    return out, xn[:, -1].to(torch.bfloat16)


def rwkv_cmix(p, x, cfg, last=None, entry_pin=None):
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if entry_pin is not None:
        xn = entry_pin(xn)
    sx = _shift(xn, last) - xn
    kin = (xn + sx * p["mix_k"]) @ p["wk"]
    rin = torch.sigmoid((xn + sx * p["mix_r"]) @ p["wr"])
    hmid = torch.square(torch.relu(kin))
    return residual(x, rin * (hmid @ p["wv"]))


# ---------------------------------------------------------------------------
# decode (one token)
# ---------------------------------------------------------------------------
def rwkv_cache_init(cfg, batch: int, *, device="cuda"):
    H, hd, d = cfg.n_rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    return {
        "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "tmix_last": torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        "cmix_last": torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
    }


def _wkv_step(rf, kf, vf, wf, S, u):
    """One WKV-6 step of (B, H, hd) inputs on the (B, H, hd, hd) state:
    (y, new state)."""
    y = torch.einsum("bhd,bhde->bhe", rf, S) + torch.einsum(
        "bhd,hd,bhd,bhe->bhe", rf, u, kf, vf
    )
    return y, wf[..., None] * S + torch.einsum("bhd,bhe->bhde", kf, vf)


def rwkv_tmix_decode(p, x, cfg, cache):
    """x: (B, 1, d)."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    r, k, v, g, w = _tmix_inputs(p, xn, cfg, last=cache["tmix_last"])
    rf, kf, vf, wf = (t[:, 0].float() for t in (r, k, v, w))
    S = cache["S"]  # (B, H, hd, hd)
    if is_sharded(S):  # each rank's (batch rows, heads), as the cache is
        per_head = (0, 1)
        y, S_new = on_shards(
            _wkv_step, (rf, kf, vf, wf, S, p["u"]), (per_head,) * 5 + ((None, 0),),
            (per_head, per_head), (rf.shape, S.shape))
    else:
        y, S_new = _wkv_step(rf, kf, vf, wf, S, p["u"])
    y = merge_heads(y)[:, None]
    y = rms_norm(y.to(x.dtype), p["ln_x"], cfg.norm_eps)
    out = x + (y * g) @ p["wo"]
    new_cache = dict(cache, S=S_new, tmix_last=xn[:, 0])
    return out, new_cache


def rwkv_cmix_decode(p, x, cfg, cache):
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    out = rwkv_cmix(p, x, cfg, last=cache["cmix_last"])
    return out, dict(cache, cmix_last=xn[:, 0])
