"""Decoder-LM assembler over `ArchConfig` (the counterpart of
``repro.models.lm``), for LM serving: prefill over a prompt, then one
token at a time.

A model is a stack of residual blocks, block = (mixer, ffn), with mixers
``attn``, ``mamba`` and ``rwkv`` and ffns ``dense``, ``moe`` and
``rwkv_cmix``: dense GQA transformers (Mistral-NeMo), RWKV-6, and the
Jamba hybrid (mamba and attention mixers, dense and MoE ffns). The MoE
ffn is `layers.moe_dropless`, the reference's host path; its GShard
capacity path is taken there only under an SPMD sharding policy and
comes with distribution (ROADMAP.md, slice 9).

Parameters and caches are held per layer, as a list of plain dicts
(``params["blocks"][i] = {"mixer": {...}, "ffn": {...}}``, ``cache[i] =
{...}``), and the stack runs as a Python loop over layers where the JAX
package scans over stacked repeats. Each layer's tensors have the JAX
package's per-layer shapes, so a cache entry of an attention layer is
(B, kv, cache_len, hd) (int8 with bf16 scales under ``kv_quant``), one
of a mamba layer holds ``conv`` and ``ssm``, and one of an RWKV layer
holds ``S``, ``tmix_last`` and ``cmix_last``. The JAX package's sharding
policy and remat switch do nothing on one device and have no
counterpart here.

Entry points (all run under ``torch.inference_mode()``)
------------------------------------------------------
- ``init_params(gen, cfg, dtype, device)``  parameters
- ``forward(params, cfg, batch)``           logits (B, S, V), fp32
- ``init_cache(cfg, B, cache_len)``         zero decode cache
- ``prefill(params, cfg, batch, L)``        (last-token logits, cache)
- ``decode_step(params, cfg, cache, inputs, pos, kv_quant=False)``
  one-token serve step

Inputs: ``batch["tokens"]`` (B, S) integer tokens. The JAX package's
stub modality frontends (``batch["embeds"]``, the VLM and audio
configs) are not ported and raise here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M
from repro_torch.models.module import dense_init, embed_init, ones

#: where what the port does not serve yet is queued
NEXT_SLICE = "ROADMAP.md (the stub frontends of the VLM and audio configs)"

_MIXER_INIT = {"attn": L.attn_init, "mamba": M.mamba_init,
               "rwkv": R.rwkv_tmix_init}
_FFN_INIT = {"dense": L.mlp_init, "moe": L.moe_init,
             "rwkv_cmix": R.rwkv_cmix_init}


def check_supported(cfg: ArchConfig) -> None:
    """Raise `NotImplementedError` for a stub modality frontend: every
    layer kind is served, the frontends are not ported."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported; see "
            f"{NEXT_SLICE}"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(gen, cfg: ArchConfig, dtype=torch.bfloat16, device="cuda"):
    """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
    ``device``): truncated-normal fan-in matrices drawn in fp32 and cast
    to ``dtype``, as the JAX package's initialisers."""
    check_supported(cfg)
    blocks = [
        {
            "mixer": _MIXER_INIT[mixer](gen, cfg, dtype, device=device),
            "ffn": _FFN_INIT[ffn](gen, cfg, dtype, device=device),
        }
        for mixer, ffn in cfg.layer_plan()
    ]
    d = cfg.d_model
    params = {
        "blocks": blocks,
        "final_norm": ones((d,), dtype, device=device),
        "embed": embed_init(gen, cfg.vocab, d, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab, dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# block dispatch
# ---------------------------------------------------------------------------
def _apply_block(kind, pm, pf, x, cfg, positions):
    mixer, ffn = kind
    if mixer == "attn":
        x = L.attention(pm, x, cfg, positions)
    elif mixer == "mamba":
        x = M.mamba(pm, x, cfg)
    else:
        x = R.rwkv_tmix(pm, x, cfg)
    if ffn == "dense":
        x = L.mlp(pf, x, cfg)
    elif ffn == "moe":
        x = L.moe_dropless(pf, x, cfg)
    else:
        x = R.rwkv_cmix(pf, x, cfg)
    return x


def _apply_block_prefill(kind, pm, pf, x, cfg, positions, cache_len):
    mixer, ffn = kind
    if mixer == "attn":
        x, cache = L.attention_prefill(pm, x, cfg, positions, cache_len)
    elif mixer == "mamba":
        x, cache = M.mamba_prefill(pm, x, cfg)
    else:
        x, cache = R.rwkv_tmix_prefill(pm, x, cfg)
    if ffn == "dense":
        x = L.mlp(pf, x, cfg)
    elif ffn == "moe":
        x = L.moe_dropless(pf, x, cfg)
    else:
        x, cmix_last = R.rwkv_cmix_prefill(pf, x, cfg)
        cache = dict(cache, cmix_last=cmix_last)
    return x, cache


def _apply_block_decode(kind, pm, pf, x, cfg, cache, pos, kv_quant):
    mixer, ffn = kind
    if mixer == "attn":
        decode = L.attention_decode_q8 if kv_quant else L.attention_decode
        x, cache = decode(pm, x, cfg, cache, pos)
    elif mixer == "mamba":
        x, cache = M.mamba_decode(pm, x, cfg, cache)
    else:
        x, cache = R.rwkv_tmix_decode(pm, x, cfg, cache)
    if ffn == "dense":
        x = L.mlp(pf, x, cfg)
    elif ffn == "moe":
        x = L.moe_dropless(pf, x, cfg)
    else:
        x, cache = R.rwkv_cmix_decode(pf, x, cfg, cache)
    return x, cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def _head(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _positions(x):
    B, Sq = x.shape[:2]
    return torch.arange(Sq, device=x.device).expand(B, Sq)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@torch.inference_mode()
def backbone(params, cfg: ArchConfig, batch):
    """Embed -> blocks -> final norm. Returns (B, S, d)."""
    check_supported(cfg)
    x = params["embed"][batch["tokens"]]
    positions = _positions(x)
    for kind, blk in zip(cfg.layer_plan(), params["blocks"]):
        x = _apply_block(kind, blk["mixer"], blk["ffn"], x, cfg, positions)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


@torch.inference_mode()
def forward(params, cfg: ArchConfig, batch):
    """Full logits (B, S, V) in fp32 — for small models and tests."""
    x = backbone(params, cfg, batch)
    return (x @ _head(params, cfg)).float()


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
    check_supported(cfg)
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
@torch.inference_mode()
def prefill(params, cfg: ArchConfig, batch, cache_len: int):
    """Run the full prompt; return (last-token logits (B, V) fp32, cache)."""
    check_supported(cfg)
    x = params["embed"][batch["tokens"]]
    positions = _positions(x)
    cache = []
    for kind, blk in zip(cfg.layer_plan(), params["blocks"]):
        x, c = _apply_block_prefill(
            kind, blk["mixer"], blk["ffn"], x, cfg, positions, cache_len
        )
        cache.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _head(params, cfg)).float()
    return logits, cache


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, cache, inputs, pos, *, kv_quant=False):
    """One new token for every sequence in the batch.

    ``inputs``: {"tokens": (B,)}; ``pos``: (B,) integer index the new
    token is written at (= current sequence length). Returns (logits
    (B, V) fp32, new_cache). Attention layers write the new K/V into the
    given cache tensors in place (`layers.attention_decode`; with
    ``kv_quant``, int8 codes and scales through
    `layers.attention_decode_q8`); mamba and RWKV layers return new state
    tensors.
    """
    check_supported(cfg)
    x = params["embed"][inputs["tokens"]][:, None, :]
    new_cache = []
    for kind, blk, c in zip(cfg.layer_plan(), params["blocks"], cache):
        x, c = _apply_block_decode(kind, blk["mixer"], blk["ffn"], x, cfg, c,
                                   pos, kv_quant)
        new_cache.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params, cfg)).float()
    return logits, new_cache
