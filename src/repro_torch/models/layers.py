"""Transformer building blocks: RMSNorm, RoPE, GQA attention with a bf16
or int8 KV cache, MLP, and MoE, dropless and GShard capacity (the
counterpart of ``repro.models.layers``).

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
- ``entry_pin``, ``head_pin`` and ``hidden_pin`` are the reference's
  activation pins (a `lm.ShardingPolicy`'s ``pin_*``), applied at the
  same places; under them the activations are DTensors and the kernels
  run on each rank's shard (`spmd.on_shards`). With a head pin, K and V
  are repeated to the query heads first, as the reference repeats them:
  a rank's shard of the heads then holds the KV heads its query heads
  read, whatever the KV head count (NeMo's and Granite's 8 on a 16-wide
  axis).
- `moe_dropless` is sort-based: per top-k slot, tokens are permuted
  into expert order and each non-empty expert's contiguous rows go
  through its own products, the counterpart of ``jax.lax.ragged_dot``.
  `moe_capacity` is the GShard form the reference runs under an SPMD
  policy: static shapes, no read to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.module import dense_init, ones, zeros
from repro_torch.models.spmd import (
    batch_only,
    is_sharded,
    merge_heads,
    on_shards,
    pin,
    residual,
    split_heads,
    whole_units,
)


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
    q = apply_rope(split_heads(q, h, hd), positions, cfg.rope_theta)
    k = apply_rope(split_heads(k, kv, hd), positions, cfg.rope_theta)
    v = split_heads(v, kv, hd)
    return q, k, v


def _expand_kv(t, groups: int):
    """(B, S, kv, hd) -> (B, S, kv*groups, hd) by head repetition."""
    if groups == 1:
        return t
    B, S, kv, hd = t.shape
    return t[:, :, :, None, :].expand(B, S, kv, groups, hd).reshape(
        B, S, kv * groups, hd)


def _flash_local(q, k, v):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)


def _attend(p, x, cfg, positions, head_pin=None, entry_pin=None):
    """(x + attention output, k, v) over the whole sequence."""
    B, S, _ = x.shape
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if entry_pin is not None:
        xn = entry_pin(xn)
    q, k, v = _qkv(p, xn, cfg, positions)
    ke, ve = k, v
    if head_pin is not None:
        groups = cfg.n_heads // cfg.n_kv_heads
        q = head_pin(q)
        ke, ve = head_pin(_expand_kv(k, groups)), head_pin(_expand_kv(v, groups))
    if is_sharded(q):
        # heads over `model` only where pinned: unexpanded KV heads stay
        # whole on each rank
        lay = (0, 2 if head_pin is not None else None)
        out = on_shards(_flash_local, (q, ke, ve), (lay,) * 3, lay, q.shape)
    else:
        out = flash_attention(q, ke, ve, causal=True)
    return residual(x, merge_heads(out) @ p["wo"]), k, v


def attention(p, x, cfg, positions, head_pin=None, entry_pin=None):
    """Causal self-attention over the full sequence (train/prefill)."""
    return _attend(p, x, cfg, positions, head_pin, entry_pin)[0]


def attention_prefill(p, x, cfg, positions, cache_len: int, head_pin=None,
                      entry_pin=None):
    """Full-sequence attention that also emits the KV cache.

    Returns (out, {"k","v"}) with cache layout (B, kv, cache_len, hd),
    zero-padded past S — ready for `attention_decode` to write into.
    """
    S = x.shape[1]
    if cache_len < S:
        raise ValueError(f"cache_len {cache_len} shorter than the prompt {S}")
    out, k, v = _attend(p, x, cfg, positions, head_pin, entry_pin)
    pad = lambda t: F.pad(t.transpose(1, 2), (0, 0, 0, cache_len - S)).contiguous()  # noqa: E731
    if is_sharded(k):  # on each rank's batch rows, whole over `model`
        B, _, kv, hd = k.shape
        rows = (0, None)
        k, v = (on_shards(pad, (t,), (rows,), rows, (B, kv, cache_len, hd))
                for t in (k, v))
        return out, {"k": k, "v": v}
    return out, {"k": pad(k), "v": pad(v)}


def attention_decode(p, x, cfg, cache, pos):
    """One-token decode. cache: {'k','v': (B, kv, S_max, hd)}, pos (B,).

    The new K/V row is written **in place** at ``pos`` of each sequence
    and the same cache tensors are returned. The reference adds a
    one-hot row to a fresh copy instead; the two agree because the slot
    at ``pos`` is still zero after prefill (the cache is zero-padded past
    the prompt and each position is written once). A DTensor cache (under
    a sharding policy, its S over ``model``) takes the reference's form.
    """
    B = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k_new, v_new = _qkv(p, xn, cfg, pos[:, None])
    k_cache, v_cache = cache["k"], cache["v"]
    S_max = k_cache.shape[2]
    if is_sharded(k_cache):
        onehot = _onehot(pos, S_max, k_cache.dtype)[:, None, :, None]
        k_cache = k_cache + onehot * k_new.transpose(1, 2).to(k_cache.dtype)
        v_cache = v_cache + onehot * v_new.transpose(1, 2).to(v_cache.dtype)
    else:
        rows = torch.arange(B, device=x.device)
        k_cache[rows, :, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, :, pos] = v_new[:, 0].to(v_cache.dtype)
    groups = h // kv
    q = whole_units(q, 2, kv).reshape(B, kv, groups, hd)  # q_len == 1 squeezed
    scores = torch.einsum("bkgh,bksh->bkgs", q, k_cache.to(q.dtype)).float()
    scores = scores * hd**-0.5
    valid = torch.arange(S_max, device=x.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", probs, v_cache.to(x.dtype))
    out = out.reshape(B, 1, h * hd)
    return x + out @ p["wo"], {"k": k_cache, "v": v_cache}


def _onehot(pos, n, dtype):
    """(B, n) rows with a one at each ``pos``."""
    return (torch.arange(n, device=pos.device)[None, :] == pos[:, None]).to(dtype)


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
    which gives the same values; a DTensor cache takes the reference's
    form). The scales commute with the hd and S
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
    S_max = cache["k"].shape[2]
    if is_sharded(cache["k"]):
        one8 = _onehot(pos, S_max, torch.int8)[:, None, :]
        one_s = _onehot(pos, S_max, torch.bfloat16)[:, None, :]
        cache = {"k": cache["k"] + one8[..., None] * kq[:, :, None],
                 "v": cache["v"] + one8[..., None] * vq[:, :, None],
                 "k_scale": cache["k_scale"] + one_s * ks[..., None],
                 "v_scale": cache["v_scale"] + one_s * vs[..., None]}
    else:
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, :, pos] = kq
        cache["v"][rows, :, pos] = vq
        cache["k_scale"][rows, :, pos] = ks
        cache["v_scale"][rows, :, pos] = vs
    groups = h // kv
    qr = whole_units(q, 2, kv).reshape(B * kv, groups, hd)
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


def mlp(p, x, cfg, hidden_pin=None, entry_pin=None):
    """swiglu (``silu(x Wg) * x Win``) or gelu (tanh form, as
    ``jax.nn.gelu``'s default), then ``W_out``, plus the residual.
    ``hidden_pin`` pins the (B, S, f) hidden over ``model`` (Megatron's
    column/row-parallel pair), ``entry_pin`` the normed input."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if entry_pin is not None:
        xn = entry_pin(xn)
    if cfg.mlp_type == "swiglu":
        gate, up = xn @ p["w_gate"], xn @ p["w_in"]
        if hidden_pin is not None:
            gate, up = hidden_pin(gate), hidden_pin(up)
        hmid = F.silu(gate) * up
    else:
        up = xn @ p["w_in"]
        if hidden_pin is not None:
            up = hidden_pin(up)
        hmid = F.gelu(up, approximate="tanh")
    return residual(x, hmid @ p["w_out"])


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
    if is_sharded(x):
        names = sorted(p)
        local = lambda x_, *ws: moe_dropless(dict(zip(names, ws)), x_, cfg)  # noqa: E731
        whole = (None, None)
        return on_shards(local, (x, *(p[n] for n in names)),
                         (whole,) * (1 + len(names)), whole, x.shape)
    B, S, d = x.shape
    k = cfg.top_k
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    flat = xn.reshape(B * S, d)
    logits = flat.float() @ p["router"]  # (T, E)
    gates, experts = torch.topk(logits, k, dim=-1)  # (T, k)
    gates = torch.softmax(gates, dim=-1)
    e_store = p["w_in"].shape[0]
    if is_fake(flat):
        # traced without data: a slot's T rows go through one expert's
        # products, which costs (shapes, operations) what any split does
        sizes = [[B * S] + [0] * (e_store - 1)] * k
    else:
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


def _route(xg, router, k: int, cap: int, e_store: int):
    """Capacity routing of (G, T_g, d) token groups, each group alone:
    fp32 router, top-k gates softmaxed over k, each token's score for
    each expert (its gate where chosen, else 0), then per expert the top
    ``cap`` tokens by score (G, E, C), zero-padded to ``e_store`` experts
    (never chosen), and their rows of ``xg`` gathered (G, E_store, C, d).
    Returns (rows, scores, token indices); a slot of score 0 holds no
    token (its index is arbitrary)."""
    G, tg, d = xg.shape
    e = router.shape[1]
    gates, experts = torch.topk(xg.float() @ router, k, dim=-1)  # (G, T_g, k)
    gates = torch.softmax(gates, dim=-1)
    ids = torch.arange(e, device=xg.device)
    scores = torch.zeros((G, tg, e), dtype=torch.float32, device=xg.device)
    for slot in range(k):
        chosen = (experts[:, :, slot, None] == ids).float()
        scores = torch.maximum(scores, chosen * gates[:, :, slot:slot + 1])
    top_scores, top_idx = torch.topk(scores.transpose(1, 2), cap, dim=-1)
    if e_store > e:
        top_scores = F.pad(top_scores, (0, 0, 0, e_store - e))
        top_idx = F.pad(top_idx, (0, 0, 0, e_store - e))
    flat = top_idx + tg * torch.arange(G, device=xg.device)[:, None, None]
    rows = xg.reshape(G * tg, d).index_select(0, flat.reshape(-1))
    return rows.reshape(G, e_store, cap, d), top_scores, top_idx


def _combine(y_sel, top_scores, top_idx, tg: int):
    """Gate-weight each expert's outputs (G, E, C, d) and scatter-add
    them, in fp32, back to their tokens (G, T_g, d). Invalid slots carry
    zero weight, so their indices are harmless."""
    G, E, C, d = y_sel.shape
    valid = (top_scores > 0.0).float()
    weighted = y_sel.float() * (top_scores * valid)[..., None]
    flat = top_idx + tg * torch.arange(G, device=y_sel.device)[:, None, None]
    out = torch.zeros((G * tg, d), dtype=torch.float32, device=y_sel.device)
    out = out.index_add(0, flat.reshape(-1), weighted.reshape(G * E * C, d))
    return out.reshape(G, tg, d)


def moe_capacity(p, x, cfg, *, groups: int = 1, dispatch_sharding=None):
    """GShard-style grouped capacity MoE: the reference's SPMD path.

    Tokens are viewed as ``(G, T_g, d)`` with ``G`` the number of data
    shards, so routing (top-k, position-in-expert selection, gathers) is
    local to each group; per expert the top ``C = min(T_g, ceil(T_g *
    top_k * capacity_factor / E))`` tokens by gate survive (``C`` in
    integer arithmetic, as the reference) and the rest keep only their
    residual path. Expert banks padded past E (``expert_pad_to``) get
    zero-score slots. The dispatch runs E-leading, (E, G, C, d), pinned
    by ``dispatch_sharding`` (a policy's ``(mesh, spec)``) before and
    after the expert products; the combine scatter-adds in fp32. Every
    shape is static and nothing is read back to the host. With a
    capacity factor of E / top_k nothing drops and the result matches
    `moe_dropless`.

    Under a policy the activations are DTensors: routing runs on each
    rank's groups and the combine on each rank's experts, whose partial
    sums over ``model`` the next pin reduces (`spmd.on_shards`).
    """
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    if T % groups:
        raise ValueError(f"tokens {T} not divisible by moe groups {groups}")
    tg = T // groups
    cap = min(tg, -(-tg * k * int(100 * cfg.capacity_factor) // (e * 100)))
    e_store = p["w_in"].shape[0]

    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xg = batch_only(xn).reshape(groups, tg, d)
    route = lambda xg_, r_: _route(xg_, r_, k, cap, e_store)  # noqa: E731
    if is_sharded(xg):
        per_group = (0, None)
        sel, top_scores, top_idx = on_shards(
            route, (xg, p["router"]), (per_group, (None, None)),
            (per_group,) * 3,
            ((groups, e_store, cap, d), (groups, e_store, cap),
             (groups, e_store, cap)))
    else:
        sel, top_scores, top_idx = route(xg, p["router"])
    sel = sel * (top_scores > 0.0)[..., None].to(sel.dtype)
    sel = sel.transpose(0, 1)  # (E, G, C, d): the expert products' batch first
    if dispatch_sharding is not None:
        sel = pin(sel, dispatch_sharding)

    h_in = torch.einsum("egcd,edf->egcf", sel, p["w_in"])
    if cfg.mlp_type == "swiglu":
        hmid = F.silu(torch.einsum("egcd,edf->egcf", sel, p["w_gate"])) * h_in
    else:
        hmid = F.gelu(h_in, approximate="tanh")
    y_sel = torch.einsum("egcf,efd->egcd", hmid, p["w_out"])  # (E, G, C, d)
    if dispatch_sharding is not None:
        y_sel = pin(y_sel, dispatch_sharding)
    y_sel = y_sel.transpose(0, 1)  # back to (G, E, C, d)

    combine = lambda y_, s_, i_: _combine(y_, s_, i_, tg)  # noqa: E731
    if is_sharded(y_sel):
        # each rank sums its own experts' outputs: partial over `model`
        # where the dispatch shards E there
        ep = dispatch_sharding is not None and dispatch_sharding[1][0] == "model"
        lay = (0, 1) if ep else (0, None)
        out = on_shards(combine, (y_sel, top_scores, top_idx), (lay,) * 3,
                        (0, "partial" if ep else None), (groups, tg, d))
    else:
        out = combine(y_sel, top_scores, top_idx)
    return residual(x, out.to(x.dtype).reshape(B, S, d))


def moe(p, x, cfg, *, groups: int = 1, dispatch_sharding=None):
    """Default MoE entry point: the SPMD-safe capacity formulation."""
    return moe_capacity(p, x, cfg, groups=groups,
                        dispatch_sharding=dispatch_sharding)


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
