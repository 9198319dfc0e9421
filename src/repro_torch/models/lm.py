"""Decoder-LM assembler over `ArchConfig` (the counterpart of
``repro.models.lm``): LM serving (prefill over a prompt, then one token
at a time) and training (a chunked cross-entropy loss with activation
checkpointing).

A model is a stack of residual blocks, block = (mixer, ffn), with mixers
``attn``, ``mamba`` and ``rwkv`` and ffns ``dense``, ``moe`` and
``rwkv_cmix``: dense GQA transformers (Mistral-NeMo), RWKV-6, and the
Jamba hybrid (mamba and attention mixers, dense and MoE ffns). The MoE
ffn is `layers.moe_dropless` (the reference's host path) or, under a
policy with a dispatch sharding, `layers.moe_capacity` (its GShard SPMD
path), as the reference picks.

Parameters and caches are held per layer, as a list of plain dicts
(``params["blocks"][i] = {"mixer": {...}, "ffn": {...}}``, ``cache[i] =
{...}``), and the stack runs as a Python loop over layers where the JAX
package scans over stacked repeats. Each layer's tensors have the JAX
package's per-layer shapes, so a cache entry of an attention layer is
(B, kv, cache_len, hd) (int8 with bf16 scales under ``kv_quant``), one
of a mamba layer holds ``conv`` and ``ssm``, and one of an RWKV layer
holds ``S``, ``tmix_last`` and ``cmix_last``. The remat switch is
``backbone``'s and ``loss_fn``'s ``remat``: one
``torch.utils.checkpoint`` boundary per repeat of ``cfg.pattern()``, as
the JAX package checkpoints its scan body.

Every entry point takes a `ShardingPolicy` (``policy=``): the
reference's activation pins, each a DTensor redistribution. Under a
policy, parameters, inputs and caches are DTensors on the policy's mesh
(`launch.steps.lowerable` lays them out), every plain op propagates its
sharding, tensors made inside the model (positions, masks) count as
replicated, and the kernels run on local shards (`spmd.on_shards`).
`NO_POLICY` pins nothing: the single-device path, or DTensors left as
they come (the reference's ``long_500k`` decode).

Entry points
------------
- ``init_params(gen, cfg, dtype, device)``  parameters
- ``backbone(params, cfg, batch)``          final hidden states (B, S, d),
  differentiable
- ``loss_fn(params, cfg, batch)``           (loss, metrics), S-chunked CE,
  differentiable
- ``forward(params, cfg, batch)``           logits (B, S, V), fp32
- ``init_cache(cfg, B, cache_len)``         zero decode cache
- ``prefill(params, cfg, batch, L)``        (last-token logits, cache)
- ``decode_step(params, cfg, cache, inputs, pos, kv_quant=False)``
  one-token serve step

``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode()`` (``torch.no_grad()`` on DTensors).

Inputs: ``batch["tokens"]`` (B, S) integer tokens, or, for the stub
modality frontends (the VLM and audio configs, ``cfg.frontend !=
"none"``), ``batch["embeds"]`` (B, S, frontend_dim): precomputed
embeddings that ``params["frontend_proj"]`` lifts to d_model, with an
untied ``lm_head``. Decode takes ``{"embeds": (B, frontend_dim)}``
then.

Every mixer trains: attention through the flash kernels' autograd
function, RWKV-6 and mamba through those of WKV-6 and the selective
scan (`kernels.rwkv6_scan.ops`, `kernels.mamba_scan.ops`), each a
forward kernel with hand-written backward kernels on the card.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M
from repro_torch.models.module import dense_init, embed_init, ones
from repro_torch.models.spmd import is_sharded, on_shards, pin, plain_replicated
from repro_torch.tree import tree_map

_MIXER_INIT = {"attn": L.attn_init, "mamba": M.mamba_init,
               "rwkv": R.rwkv_tmix_init}
_FFN_INIT = {"dense": L.mlp_init, "moe": L.moe_init,
             "rwkv_cmix": R.rwkv_cmix_init}


# ---------------------------------------------------------------------------
# activation sharding policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShardingPolicy:
    """Activation sharding pins inside the model (the reference's).

    Each pin field is ``None`` (leave the tensor as it is) or a ``(mesh,
    spec)`` pair, ``spec`` in `launch.sharding`'s language; its ``pin_*``
    redistributes a DTensor there, the counterpart of
    ``with_sharding_constraint``, and raises on a plain tensor.

    ``act``: (B, S, d) block boundaries; ``logits``: (B, chunk, vocab) CE
    chunks; ``heads``: (B, S, H, hd) after the q/k/v projections (the
    head-parallel attention and WKV schedule); ``channels``: (B, S, C)
    hidden and recurrent channels over ``model``; ``gathered``: the
    normed block input with S gathered, before the big projections.
    ``moe_groups`` / ``moe_dispatch`` drive `layers.moe_capacity`: groups
    = the number of data shards (routing stays shard-local), dispatch =
    the (E, G, C, d) expert-parallel layout. Without a dispatch the MoE
    is `layers.moe_dropless`.
    """

    act: Any = None
    logits: Any = None
    moe_groups: int = 1
    moe_dispatch: Any = None
    heads: Any = None
    channels: Any = None
    gathered: Any = None

    def pin_act(self, x):
        return pin(x, self.act)

    def pin_logits(self, x):
        return pin(x, self.logits)

    def pin_heads(self, x):
        return pin(x, self.heads)

    def pin_channels(self, x):
        return pin(x, self.channels)

    def pin_gathered(self, x):
        return pin(x, self.gathered)



NO_POLICY = ShardingPolicy()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen, cfg: ArchConfig, dtype=torch.bfloat16, device="cuda"):
    """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
    ``device``): truncated-normal fan-in matrices drawn in fp32 and cast
    to ``dtype``, as the JAX package's initialisers. A stub-frontend
    config gets ``frontend_proj`` (frontend_dim, d_model) and an untied
    ``lm_head`` in place of the embedding."""
    blocks = [
        {
            "mixer": _MIXER_INIT[mixer](gen, cfg, dtype, device=device),
            "ffn": _FFN_INIT[ffn](gen, cfg, dtype, device=device),
        }
        for mixer, ffn in cfg.layer_plan()
    ]
    d = cfg.d_model
    params = {"blocks": blocks, "final_norm": ones((d,), dtype, device=device)}
    if cfg.frontend == "none":
        params["embed"] = embed_init(gen, cfg.vocab, d, dtype, device=device)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, d, cfg.vocab, dtype,
                                           device=device)
    else:
        params["frontend_proj"] = dense_init(gen, cfg.frontend_dim, d, dtype,
                                             device=device)
        params["lm_head"] = dense_init(gen, d, cfg.vocab, dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------
def _apply_ffn(ffn, pf, x, cfg, policy):
    if ffn == "dense":
        return L.mlp(pf, x, cfg, hidden_pin=policy.pin_channels,
                     entry_pin=policy.pin_gathered)
    # SPMD path: GShard capacity MoE (partitions); host path (no dispatch
    # sharding): exact dropless sort-based MoE
    if policy.moe_dispatch is None:
        return L.moe_dropless(pf, x, cfg)
    return L.moe_capacity(pf, x, cfg, groups=policy.moe_groups,
                          dispatch_sharding=policy.moe_dispatch)


def _apply_block(kind, pm, pf, x, cfg, positions, policy=NO_POLICY):
    mixer, ffn = kind
    if mixer == "attn":
        x = L.attention(pm, x, cfg, positions, head_pin=policy.pin_heads,
                        entry_pin=policy.pin_gathered)
    elif mixer == "mamba":
        x = M.mamba(pm, x, cfg, inner_pin=policy.pin_channels,
                    entry_pin=policy.pin_gathered)
    else:
        x = R.rwkv_tmix(pm, x, cfg, head_pin=policy.pin_heads,
                        entry_pin=policy.pin_gathered)
    if ffn == "rwkv_cmix":
        return R.rwkv_cmix(pf, x, cfg, entry_pin=policy.pin_gathered)
    return _apply_ffn(ffn, pf, x, cfg, policy)


def _apply_block_prefill(kind, pm, pf, x, cfg, positions, cache_len,
                         policy=NO_POLICY):
    mixer, ffn = kind
    if mixer == "attn":
        x, cache = L.attention_prefill(
            pm, x, cfg, positions, cache_len, head_pin=policy.pin_heads,
            entry_pin=policy.pin_gathered)
    elif mixer == "mamba":
        x, cache = M.mamba_prefill(pm, x, cfg, inner_pin=policy.pin_channels,
                                   entry_pin=policy.pin_gathered)
    else:
        x, cache = R.rwkv_tmix_prefill(pm, x, cfg, head_pin=policy.pin_heads,
                                       entry_pin=policy.pin_gathered)
    if ffn == "rwkv_cmix":
        x, cmix_last = R.rwkv_cmix_prefill(pf, x, cfg,
                                           entry_pin=policy.pin_gathered)
        return x, dict(cache, cmix_last=cmix_last)
    return _apply_ffn(ffn, pf, x, cfg, policy), cache


def _apply_block_decode(kind, pm, pf, x, cfg, cache, pos, policy=NO_POLICY,
                        kv_quant=False):
    mixer, ffn = kind
    if mixer == "attn":
        decode = L.attention_decode_q8 if kv_quant else L.attention_decode
        x, cache = decode(pm, x, cfg, cache, pos)
    elif mixer == "mamba":
        x, cache = M.mamba_decode(pm, x, cfg, cache)
    else:
        x, cache = R.rwkv_tmix_decode(pm, x, cfg, cache)
    if ffn == "rwkv_cmix":
        return R.rwkv_cmix_decode(pf, x, cfg, cache)
    return _apply_ffn(ffn, pf, x, cfg, policy), cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def _lookup(embed, tokens):
    return embed[tokens]


def _embed_inputs(params, cfg: ArchConfig, inputs):
    """Token embeddings, or the stub frontend's embeddings lifted to
    d_model by a plain product (the reference's, outside any kernel)."""
    if cfg.frontend == "none":
        embed, tokens = params["embed"], inputs["tokens"]
        if is_sharded(embed):
            # a lookup of each rank's rows in its slice of d_model
            bdim = 0 if any(p.is_shard(0) for p in tokens.placements) else None
            return on_shards(_lookup, (embed, tokens), ((None, 1), (bdim, None)),
                             (bdim, tokens.ndim), (*tokens.shape, embed.shape[1]))
        return embed[tokens]
    proj = params["frontend_proj"]
    return inputs["embeds"].to(proj.dtype) @ proj


def _head(params, cfg: ArchConfig):
    if cfg.frontend == "none" and cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _positions(x):
    B, Sq = x.shape[:2]
    return torch.arange(Sq, device=x.device).expand(B, Sq)


def decay_mask(params):
    """Which leaves AdamW decays, as a tree of bools like ``params``: the
    JAX package decays a leaf of ``ndim >= 2`` (`repro.optim.adamw`), and
    its block leaves carry a leading repeats axis. So here every
    per-layer leaf is decayed (norm scales and q/k/v biases included),
    and of the others the matrices (``embed``, ``lm_head``), not
    ``final_norm``."""
    return {
        key: (tree_map(lambda p: p.ndim + 1 >= 2, value) if key == "blocks"
              else value.ndim >= 2)
        for key, value in params.items()
    }


def _serving(fn):
    """Run ``fn`` with grad off: under ``torch.inference_mode``, or under
    ``torch.no_grad`` for DTensor parameters (DTensor's views cannot set
    an inference tensor's version counter)."""

    @functools.wraps(fn)
    def wrapped(params, *args, **kwargs):
        sharded = is_sharded(params["final_norm"])
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(params, *args, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------
def _apply_repeat(kinds, blocks, x, cfg, positions, policy):
    """One repeat of ``cfg.pattern()``: the checkpointed unit."""
    for kind, blk in zip(kinds, blocks):
        x = _apply_block(kind, blk["mixer"], blk["ffn"], x, cfg, positions,
                         policy)
        x = policy.pin_act(x)
    return x


def backbone(params, cfg: ArchConfig, batch, *, remat: bool = True,
             policy: ShardingPolicy = NO_POLICY):
    """Embed -> blocks -> final norm. Returns (B, S, d).

    With ``remat`` and grad enabled, each repeat of ``cfg.pattern()`` runs
    under one ``torch.utils.checkpoint`` boundary: its activations are
    dropped after the forward and recomputed in the backward, as the JAX
    package's ``jax.checkpoint`` over its scan body. With grad off the
    boundary changes nothing and is not taken. ``policy`` pins the
    embedded input and every block's output (``pin_act``)."""
    with plain_replicated():
        x = policy.pin_act(_embed_inputs(params, cfg, batch))
        positions = _positions(x)
        plan, n_pat = cfg.layer_plan(), len(cfg.pattern())
        use_remat = remat and torch.is_grad_enabled()
        for r0 in range(0, cfg.n_layers, n_pat):
            args = (plan[r0:r0 + n_pat], params["blocks"][r0:r0 + n_pat], x,
                    cfg, positions, policy)
            if use_remat:
                x = checkpoint(_apply_repeat, *args, use_reentrant=False)
            else:
                x = _apply_repeat(*args)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


@_serving
def forward(params, cfg: ArchConfig, batch, *,
            policy: ShardingPolicy = NO_POLICY):
    """Full logits (B, S, V) in fp32 — for small models and tests;
    training uses `loss_fn` (never materializes all logits at once)."""
    x = backbone(params, cfg, batch, policy=policy)
    with plain_replicated():
        # gather S where it is sequence-parallel: DTensor cannot flatten a
        # (B, S) sharded both ways for the product
        return (policy.pin_gathered(x) @ _head(params, cfg)).float()


#: sequence-chunk length for the cross-entropy loop: bounds live logits
#: memory at (B, CE_CHUNK, V) fp32
CE_CHUNK = 512


def _gold(logits, labels, vocab_ids):
    """Each label's logit, from this rank's slice of the vocabulary (0
    where the label lies in another slice)."""
    return (logits * (vocab_ids == labels[..., None])).sum(-1)


def _row_max(logits):
    return logits.amax(-1, keepdim=True)


def _sum_exp(logits, shift):
    return torch.exp(logits - shift[..., None]).sum(-1)


def _ce(x_c, head, lab_c, m_c, policy=NO_POLICY):
    """Masked cross-entropy total of one chunk, fp32. Under a policy the
    log-sum-exp and the labels' logits are taken on each rank's
    vocabulary slice and combined over ``model`` (the vocabulary-parallel
    cross entropy): DTensor's own logsumexp and gather over a sharded
    vocabulary move the logits."""
    logits = policy.pin_logits((x_c @ head).float())
    if not is_sharded(logits):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab_c[..., None])[..., 0]
        return ((lse - gold) * m_c).sum()
    B, C, V = logits.shape
    vocab, rows = (0, 2), (0, None)
    mesh = logits.device_mesh
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    # each rank's row maxima side by side, then their max: the shift
    shift = on_shards(_row_max, (logits,), (vocab,), vocab,
                      (B, C, n_model)).amax(-1).detach()
    lse = shift + torch.log(on_shards(_sum_exp, (logits, shift), (vocab, rows),
                                      (0, "partial"), (B, C)))
    ids = torch.arange(V, device=logits.device)
    gold = on_shards(_gold, (logits, lab_c, ids), (vocab, rows, (None, 0)),
                     (0, "partial"), (B, C))
    return ((lse - gold) * m_c).sum()


def loss_fn(params, cfg: ArchConfig, batch, *, remat: bool = True,
            policy: ShardingPolicy = NO_POLICY):
    """Mean next-token cross entropy with S-chunked logits.

    ``batch["labels"]`` (B, S) integer; optional ``batch["mask"]`` (B, S)
    weights (defaults to all-ones). Labels are already shifted by the
    data pipeline (labels[t] = target for position t). As in the JAX
    package, the chunk is ``CE_CHUNK`` halved until it divides S, each
    chunk's logits are recomputed in the backward (one checkpoint per
    chunk, whatever ``remat``), pinned by ``policy.pin_logits``, and the
    chunk totals are summed in order. Returns (loss, {"loss", "tokens"})
    as fp32 scalar tensors.
    """
    x = backbone(params, cfg, batch, remat=remat, policy=policy)
    with plain_replicated():
        # the chunks slice S: gather it first where it is sequence-parallel
        x = policy.pin_gathered(x)
        head = _head(params, cfg)
        labels = batch["labels"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
        Sq = x.shape[1]
        chunk = min(CE_CHUNK, Sq)
        while Sq % chunk:
            chunk //= 2
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, Sq, chunk):
            part = slice(c0, c0 + chunk)
            args = (x[:, part], head, labels[:, part], mask[:, part], policy)
            if torch.is_grad_enabled():
                total = total + checkpoint(_ce, *args, use_reentrant=False)
            else:
                total = total + _ce(*args)
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = total / denom
    return loss, {"loss": loss, "tokens": denom}


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------
def _block_cache_shape(kind, cfg: ArchConfig, B: int, cache_len: int,
                       kv_quant: bool = False):
    mixer, _ = kind
    if mixer == "attn":
        shape = (B, cfg.n_kv_heads, cache_len, cfg.head_dim)
        if kv_quant:
            return {
                "k": (shape, torch.int8), "v": (shape, torch.int8),
                "k_scale": (shape[:3], torch.bfloat16),
                "v_scale": (shape[:3], torch.bfloat16),
            }
        return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}
    if mixer == "mamba":
        return {
            "conv": ((B, cfg.mamba_d_conv - 1, cfg.d_inner), torch.bfloat16),
            "ssm": ((B, cfg.d_inner, cfg.mamba_d_state), torch.float32),
        }
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    return {
        "S": ((B, H, hd, hd), torch.float32),
        "tmix_last": ((B, cfg.d_model), torch.bfloat16),
        "cmix_last": ((B, cfg.d_model), torch.bfloat16),
    }


def cache_spec(cfg: ArchConfig, B: int, cache_len: int, kv_quant: bool = False):
    """Per layer, ``{name: (shape, dtype)}`` of the decode cache; with
    ``kv_quant`` attention layers hold int8 K/V and bf16 scales."""
    return [
        _block_cache_shape(kind, cfg, B, cache_len, kv_quant)
        for kind in cfg.layer_plan()
    ]


def init_cache(cfg: ArchConfig, B: int, cache_len: int, *, device="cuda"):
    """A zero decode cache, one dict per layer."""
    return [
        {
            name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()
        }
        for spec in cache_spec(cfg, B, cache_len)
    ]


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
@_serving
def prefill(params, cfg: ArchConfig, batch, cache_len: int, *,
            policy: ShardingPolicy = NO_POLICY):
    """Run the full prompt; return (last-token logits (B, V) fp32, cache)."""
    with plain_replicated():
        x = policy.pin_act(_embed_inputs(params, cfg, batch))
        positions = _positions(x)
        cache = []
        for kind, blk in zip(cfg.layer_plan(), params["blocks"]):
            x, c = _apply_block_prefill(
                kind, blk["mixer"], blk["ffn"], x, cfg, positions, cache_len,
                policy)
            x = policy.pin_act(x)
            cache.append(c)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, -1] @ _head(params, cfg)).float()
    return logits, cache


@_serving
def decode_step(params, cfg: ArchConfig, cache, inputs, pos, *,
                policy: ShardingPolicy = NO_POLICY, kv_quant=False):
    """One new token for every sequence in the batch.

    ``inputs``: {"tokens": (B,)} or {"embeds": (B, frontend_dim)};
    ``pos``: (B,) integer index the new
    token is written at (= current sequence length). Returns (logits
    (B, V) fp32, new_cache). Attention layers write the new K/V into the
    given cache tensors in place (`layers.attention_decode`; with
    ``kv_quant``, int8 codes and scales through
    `layers.attention_decode_q8`); mamba and RWKV layers return new state
    tensors. A DTensor cache is not written in place: its layers return
    new tensors, as the reference's do.
    """
    with plain_replicated():
        x = policy.pin_act(_embed_inputs(params, cfg, inputs)[:, None, :])
        new_cache = []
        for kind, blk, c in zip(cfg.layer_plan(), params["blocks"], cache):
            x, c = _apply_block_decode(kind, blk["mixer"], blk["ffn"], x, cfg,
                                       c, pos, policy, kv_quant)
            x = policy.pin_act(x)
            new_cache.append(c)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, new_cache
