"""Transformer building blocks: RMSNorm, RoPE, GQA attention, MLP (the
counterpart of ``repro.models.layers``, restricted to what the dense and
RWKV models use; MoE and the int8 KV cache come with a later slice).

Conventions
-----------
- activations ``(B, S, d)`` in the parameters' dtype; norms, softmax and
  rope angles in fp32.
- attention is causal over positions ``0..S-1``; the decode path takes
  a KV cache and one new token per sequence (``q_len == 1``).
- full-sequence attention goes through `flash_attention` at every S:
  the hand-written CUDA kernel on the card, its plain fp32 version on
  the CPU. KV heads are handed over as they are; the kernel maps query
  head ``h`` to KV head ``h // (H // Hkv)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.module import dense_init, ones, zeros


# ---------------------------------------------------------------------------
# norms & rope
# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) integers. Split-half
    rotation with fp32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------
def attn_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, dtype, device=device),
        "wk": dense_init(gen, d, kv * hd, dtype, device=device),
        "wv": dense_init(gen, d, kv * hd, dtype, device=device),
        "wo": dense_init(gen, h * hd, d, dtype, device=device),
        "norm": ones((d,), dtype, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((h * hd,), dtype, device=device)
        p["bk"] = zeros((kv * hd,), dtype, device=device)
        p["bv"] = zeros((kv * hd,), dtype, device=device)
    return p


def _qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, kv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, kv, hd)
    return q, k, v


def _attend(p, x, cfg, positions):
    """(x + attention output, k, v) over the whole sequence."""
    B, S, _ = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg, positions)
    out = flash_attention(q, k, v, causal=True)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + out @ p["wo"], k, v


def attention(p, x, cfg, positions):
    """Causal self-attention over the full sequence (prefill/eval)."""
    return _attend(p, x, cfg, positions)[0]


def attention_prefill(p, x, cfg, positions, cache_len: int):
    """Full-sequence attention that also emits the KV cache.

    Returns (out, {"k","v"}) with cache layout (B, kv, cache_len, hd),
    zero-padded past S — ready for `attention_decode` to write into.
    """
    S = x.shape[1]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} shorter than the prompt {S}")
    out, k, v = _attend(p, x, cfg, positions)
    pad = (0, 0, 0, cache_len - S)
    cache = {
        "k": F.pad(k.transpose(1, 2), pad).contiguous(),
        "v": F.pad(v.transpose(1, 2), pad).contiguous(),
    }
    return out, cache


def attention_decode(p, x, cfg, cache, pos):
    """One-token decode. cache: {'k','v': (B, kv, S_max, hd)}, pos (B,).

    The new K/V row is written **in place** at ``pos`` of each sequence
    and the same cache tensors are returned. The reference adds a
    one-hot row to a fresh copy instead; the two agree because the slot
    at ``pos`` is still zero after prefill (the cache is zero-padded past
    the prompt and each position is written once).
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k_new, v_new = _qkv(p, xn, cfg, pos[:, None])
    k_cache, v_cache = cache["k"], cache["v"]
    rows = torch.arange(B, device=x.device)
    k_cache[rows, :, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, :, pos] = v_new[:, 0].to(v_cache.dtype)
    S_max = k_cache.shape[2]
    groups = h // kv
    q = q.reshape(B, kv, groups, hd)  # q_len == 1 squeezed
    scores = torch.einsum("bkgh,bksh->bkgs", q, k_cache.to(q.dtype)).float()
    scores = scores * hd**-0.5
    valid = torch.arange(S_max, device=x.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", probs, v_cache.to(x.dtype))
    out = out.reshape(B, 1, h * hd)
    return x + out @ p["wo"], {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------
def mlp_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_in": dense_init(gen, d, f, dtype, device=device),
        "w_out": dense_init(gen, f, d, dtype, device=device),
        "norm": ones((d,), dtype, device=device),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, d, f, dtype, device=device)
    return p


def mlp(p, x, cfg):
    """swiglu (``silu(x Wg) * x Win``) or gelu (tanh form, as
    ``jax.nn.gelu``'s default), then ``W_out``, plus the residual."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if cfg.mlp_type == "swiglu":
        hmid = F.silu(xn @ p["w_gate"]) * (xn @ p["w_in"])
    else:
        hmid = F.gelu(xn @ p["w_in"], approximate="tanh")
    return x + hmid @ p["w_out"]
