"""Plain reference of a dense decoder: pre-norm blocks of RMSNorm, GQA
causal attention with split-half RoPE (on q, k and v plus their biases,
where the weights hold ``bq``, ``bk`` and ``bv``), and a SwiGLU MLP,
then a final RMSNorm and an untied head.

Plain PyTorch in float32, with TF32 off. It imports nothing of the
program: it takes the weights the benchmark made (bf16, stacked over the
layers as `benchkit.weights` lays them out) and the token ids, and works
out everything else again. Attention runs in blocks of query rows and
the layers one at a time (checkpointed under autograd), so it fits on the
card beside nothing else.

``prec="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with one scale a tensor (its gradients too), the step below
the configuration's bf16."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

TOP_KEYS = ("embed", "lm_head", "final_norm")
FP8_MAX = 448.0
QUERY_BLOCK = 1024
CE_CHUNK = 512


def _q8(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _MatMul8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _mm(prec):
    if prec == "fp32":
        return torch.matmul
    if prec == "fp8":
        return _MatMul8.apply
    raise ValueError(f"no precision {prec!r}")


def _fp32_products():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (B, S, H, hd) at positions 0..S-1, split-half rotation."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_block(qb, kb, vb, q0, mm):
    """Query rows q0.. of one block against keys 0..q1-1."""
    q1 = q0 + qb.shape[2]
    s = mm(qb, kb.transpose(-1, -2)) * qb.shape[-1] ** -0.5
    future = (torch.arange(q1, device=qb.device)[None, :]
              > torch.arange(q0, q1, device=qb.device)[:, None])
    return mm(torch.softmax(s.masked_fill(future, float("-inf")), dim=-1), vb)


def attend(q, k, v, mm):
    """Causal attention: q (B, S, H, hd), k, v (B, S, Hkv, hd); query
    head h reads KV head h // (H / Hkv). Returns (B, S, H * hd). Under
    autograd each block of query rows is checkpointed, so the backward
    holds one block's probabilities at a time."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    outs = []
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        args = (qh[:, :, q0:q1], kh[:, :, :q1], vh[:, :, :q1], q0, mm)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, *args, use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)


def _lin(x, w, mm):
    return mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


def _proj(h, lw, n, mm):
    """``h @ w<n>``, plus ``b<n>`` where the layer has it."""
    y = _lin(h, lw[f"w{n}"], mm)
    return y + lw[f"b{n}"] if f"b{n}" in lw else y


def block(x, lw, s, mm, kv_out=None):
    """One layer; ``lw`` its fp32 weights. With ``kv_out`` (a list) the
    layer's K (after RoPE) and V, (B, S, Hkv, hd), are appended."""
    B, S, _ = x.shape
    h = rms(x, lw["attn_norm"], s.norm_eps)
    q = rope(_proj(h, lw, "q", mm).reshape(B, S, s.heads, s.head_dim), s.rope_theta)
    k = rope(_proj(h, lw, "k", mm).reshape(B, S, s.kv_heads, s.head_dim), s.rope_theta)
    v = _proj(h, lw, "v", mm).reshape(B, S, s.kv_heads, s.head_dim)
    if kv_out is not None:
        kv_out.extend((k, v))
    x = x + _lin(attend(q, k, v, mm), lw["wo"], mm)
    h = rms(x, lw["mlp_norm"], s.norm_eps)
    return x + _lin(F.silu(_lin(h, lw["w_gate"], mm)) * _lin(h, lw["w_in"], mm),
                    lw["w_out"], mm)


@torch.no_grad()
def prefill(s, w, tokens, prec="fp32", on_layer=None):
    """Last-token logits (B, V) of ``tokens`` (B, S) under weights ``w``;
    ``on_layer(i, {"k": K, "v": V})`` sees each layer's K and V."""
    _fp32_products()
    mm = _mm(prec)
    x = w["embed"][tokens.long()].float()
    for i in range(s.layers):
        lw = {key: t[i].float() for key, t in w.items() if key not in TOP_KEYS}
        kv = [] if on_layer is not None else None
        x = block(x, lw, s, mm, kv)
        if on_layer is not None:
            on_layer(i, dict(zip(("k", "v"), kv)))
        del lw, kv
    h = rms(x[:, -1], w["final_norm"].float(), s.norm_eps)
    return mm(h, w["lm_head"].float())


def _ce_sum(h, head, labels, mm):
    logits = mm(h, head)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()


def loss(p, s, tokens, labels, mm):
    """Mean next-token cross entropy; the layers and the head's chunks of
    CE_CHUNK positions checkpointed."""
    x = p["embed"][tokens.long()]

    def layer(x, i):
        return block(x, {key: t[i] for key, t in p.items() if key not in TOP_KEYS},
                     s, mm)

    for i in range(s.layers):
        x = checkpoint(layer, x, i, use_reentrant=False)
    h = rms(x, p["final_norm"], s.norm_eps)
    labels = labels.long()
    total = 0.0
    for c0 in range(0, h.shape[1], CE_CHUNK):
        part = slice(c0, c0 + CE_CHUNK)
        total = total + checkpoint(_ce_sum, h[:, part], p["lm_head"],
                                   labels[:, part], mm, use_reentrant=False)
    return total / labels.numel()


def _lr(opt, step: int) -> float:
    """Linear warm-up, then cosine decay to ``lr_min``."""
    if step < opt["warmup_steps"]:
        return opt["lr_peak"] * step / max(opt["warmup_steps"], 1)
    prog = (step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    return opt["lr_min"] + 0.5 * (opt["lr_peak"] - opt["lr_min"]) * (1 + math.cos(math.pi * prog))


def _leaf_views(t, key, layers):
    if key not in TOP_KEYS:
        return {f"{key}.{i}": t[i] for i in range(layers)}
    return {key: t}


def train(s, w, batches, opt, prec="fp32"):
    """AdamW steps from weights ``w`` over ``batches`` (a list of
    {"tokens", "labels"} on the device), parameters stored in bf16 as
    the configuration states and fp32 moments. Returns the losses, each
    leaf's norm of the first step's gradient after clipping (what the
    optimizer takes), and each leaf's norm of the parameters' change
    after the last step."""
    _fp32_products()
    mm = _mm(prec)
    p = {k: t.to(torch.float32, copy=True).requires_grad_() for k, t in w.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    decay = {k: k != "final_norm" for k in p}
    b1, b2 = opt["b1"], opt["b2"]
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        with torch.enable_grad():
            value = loss(p, s, batch["tokens"], batch["labels"], mm)
            grads = torch.autograd.grad(value, list(p.values()))
        losses.append(float(value.detach()))
        gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
        scale = torch.clamp(opt["clip_norm"] / gnorm.clamp_min(1e-12), max=1.0)
        lr = _lr(opt, step)
        with torch.no_grad():
            for (k, t), g in zip(p.items(), grads):
                g = g * scale
                if step == 1:
                    first.update({n: float(x.norm()) for n, x in
                                  _leaf_views(g, k, s.layers).items()})
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[k] / (1 - b1 ** step)) / (torch.sqrt(v[k] / (1 - b2 ** step))
                                                    + opt["eps"])
                if decay[k]:
                    delta = delta + opt["weight_decay"] * t
                t.copy_((t - lr * delta).to(torch.bfloat16).float())
        del grads
    with torch.no_grad():
        change = {}
        for k, t in p.items():
            d = t - w[k].float()
            change.update({n: float(x.norm()) for n, x in
                           _leaf_views(d, k, s.layers).items()})
    return {"losses": losses, "grad": first, "change": change}
