"""Transformer building blocks: RMSNorm, RoPE, GQA attention with a bf16
or int8 KV cache, MLP and dropless MoE (the counterpart of
``repro.models.layers``; the GShard capacity MoE, which the reference
takes only under an SPMD sharding policy, comes with distribution).

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
- MoE is sort-based and dropless: per top-k slot, tokens are permuted
  into expert order and each non-empty expert's contiguous rows go
  through its own products, the counterpart of ``jax.lax.ragged_dot``.
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


def quantize_kv(k):
    """Symmetric int8 over the last axis; returns (q8, scale bf16)."""
    kf = k.float()
    scale = torch.clamp_min(kf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _bf16_bmm_f32(a, b):
    """``a @ b`` over a leading batch axis with both operands rounded to
    bf16 and an fp32 result. On the card the codes are widened to bf16
    (2 bytes each, half the fp32 buffer) and cuBLAS returns fp32; PyTorch
    has no bf16-operand, fp32-result product on the CPU, so there the
    bf16-rounded operands are widened to fp32, which gives the same
    products up to summation order."""
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def attention_decode_q8(p, x, cfg, cache, pos):
    """One-token decode over an int8 KV cache.

    cache: {"k", "v": int8 (B, kv, S_max, hd), "k_scale", "v_scale": bf16
    (B, kv, S_max)}, per-(token, head) symmetric scales. The new token's
    codes and scales are written **in place** at ``pos``, as in
    `attention_decode` (the reference adds a one-hot to the zero slot,
    which gives the same values). The scales commute with the hd and S
    contractions, so they multiply the (B, kv, g, S) scores and
    probabilities and the cache is never dequantized. As in the
    reference, q, the codes and the probabilities enter the two products
    as bf16 (exact for the codes: integers up to 127) and the products
    accumulate and return in fp32 (`_bf16_bmm_f32`).
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k_new, v_new = _qkv(p, xn, cfg, pos[:, None])
    kq, ks = quantize_kv(k_new[:, 0])  # (B, kv, hd), (B, kv)
    vq, vs = quantize_kv(v_new[:, 0])
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, :, pos] = kq
    cache["v"][rows, :, pos] = vq
    cache["k_scale"][rows, :, pos] = ks
    cache["v_scale"][rows, :, pos] = vs
    S_max = cache["k"].shape[2]
    groups = h // kv
    qr = q.reshape(B * kv, groups, hd)
    k8 = cache["k"].reshape(B * kv, S_max, hd)
    scores = _bf16_bmm_f32(qr, k8.transpose(1, 2)).reshape(B, kv, groups, S_max)
    scores = scores * cache["k_scale"].float()[:, :, None, :]
    scores = scores * hd**-0.5
    valid = torch.arange(S_max, device=x.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * cache["v_scale"].float()[:, :, None, :]
    out = _bf16_bmm_f32(probs.reshape(B * kv, groups, S_max),
                        cache["v"].reshape(B * kv, S_max, hd)).to(x.dtype)
    out = out.reshape(B, 1, h * hd)
    return x + out @ p["wo"], cache


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


# ---------------------------------------------------------------------------
# MoE (sort + grouped products, dropless)
# ---------------------------------------------------------------------------
def moe_init(gen, cfg, dtype=torch.bfloat16, *, device="cuda"):
    """Router (d, E) in fp32 and expert banks (E_store, d_in, d_out)
    truncated normal / sqrt(d_in). ``E_store = max(E, expert_pad_to)``:
    padded banks are stored and never routed to."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    e_store = max(e, cfg.expert_pad_to or 0)

    def expert_mat(d_in, d_out):
        w = torch.empty((e_store, d_in, d_out), dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / d_in**0.5).to(dtype)

    p = {
        "router": dense_init(gen, d, e, torch.float32, device=device),
        "w_in": expert_mat(d, f),
        "w_out": expert_mat(f, d),
        "norm": ones((d,), dtype, device=device),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = expert_mat(d, f)
    return p


def _expert_ffn(p, j, rows, cfg):
    """Expert ``j``'s FFN on its contiguous rows."""
    if cfg.mlp_type == "swiglu":
        hmid = F.silu(rows @ p["w_gate"][j]) * (rows @ p["w_in"][j])
    else:
        hmid = F.gelu(rows @ p["w_in"][j], approximate="tanh")
    return hmid @ p["w_out"][j]


def moe_dropless(p, x, cfg):
    """Top-k MoE over tokens, exactly dropless.

    fp32 router, top-k, softmax over the k gates. For each slot in
    order: a stable argsort of the tokens by expert, group sizes as
    ``bincount(minlength=E_store)`` gives them, one product chain per
    non-empty expert over its contiguous rows, then unpermute and weight
    by the gate; slots are summed in order into zeros of x's dtype. The
    group sizes of all slots are counted on the device with one
    ``scatter_add_`` (``torch.bincount`` on a CUDA tensor would first
    read the largest expert id back to the host) and read back to the
    host once per call (``moe_dropless.host_reads`` counts the reads).
    """
    B, S, d = x.shape
    k = cfg.top_k
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    flat = xn.reshape(B * S, d)
    logits = flat.float() @ p["router"]  # (T, E)
    gates, experts = torch.topk(logits, k, dim=-1)  # (T, k)
    gates = torch.softmax(gates, dim=-1)
    e_store = p["w_in"].shape[0]
    ids = experts.T  # (k, T)
    sizes = torch.zeros((k, e_store), dtype=ids.dtype, device=ids.device)
    sizes = sizes.scatter_add_(1, ids, torch.ones_like(ids)).tolist()
    moe_dropless.host_reads += 1
    out = torch.zeros_like(flat)
    for slot in range(k):
        order = torch.argsort(experts[:, slot], stable=True)  # tokens by expert
        xs = flat[order]
        ys = torch.empty_like(xs)
        start = 0
        for j, n in enumerate(sizes[slot]):
            if n:
                ys[start : start + n] = _expert_ffn(p, j, xs[start : start + n], cfg)
                start += n
        unperm = torch.empty_like(ys)
        unperm[order] = ys
        out = out + unperm * gates[:, slot, None].to(ys.dtype)
    return x + out.reshape(B, S, d)


#: group-size read-backs to the host since the count was last set to 0
moe_dropless.host_reads = 0


def moe_aux_loss(p, x, cfg):
    """Switch-style load-balancing loss of one MoE layer's router, fp32:
    ``E * sum_e frac_e * imp_e``, with frac the share of tokens whose
    top-1 expert is e and imp the mean router probability of e. Returned
    on its own, as in the reference, which adds it to no loss."""
    B, S, d = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    logits = xn.reshape(B * S, d).float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    imp = probs.mean(0)
    return cfg.n_experts * (frac * imp).sum()
