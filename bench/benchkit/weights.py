"""Weights made from the seed, on the device, in the type they are
served in, one call per kind of matrix for all layers at once.

Each per-layer kind is stacked over the layers, ``(L, d_in, d_out)``,
laid out for ``x @ W`` as the port's parameter tree holds it. Matrices
are standard normal times ``1 / sqrt(d_in)``, the embedding table times
0.02, the q, k and v biases (where the configuration has them) times
BIAS_STD, the norm scales ones. The same seed on the same device gives the
same bits, so the reference takes the weights by making them again."""
from __future__ import annotations

import math

import torch

from benchkit.model import Sizes
from benchkit.tokens import seed_u63

#: stacked key -> (the port's block part, its key there)
LAYER_LEAVES = {
    "wq": ("mixer", "wq"), "wk": ("mixer", "wk"), "wv": ("mixer", "wv"),
    "wo": ("mixer", "wo"), "attn_norm": ("mixer", "norm"),
    "w_gate": ("ffn", "w_gate"), "w_in": ("ffn", "w_in"),
    "w_out": ("ffn", "w_out"), "mlp_norm": ("ffn", "norm"),
}
BIAS_LEAVES = {"bq": ("mixer", "bq"), "bk": ("mixer", "bk"), "bv": ("mixer", "bv")}
TOP_LEAVES = ("embed", "lm_head", "final_norm")
#: the biases' scale: half that of the projections' outputs (about 1),
#: so that a bias the program left out moves every layer's q, k and v
BIAS_STD = 0.5


def layer_leaves(s: Sizes) -> dict:
    return {**LAYER_LEAVES, **(BIAS_LEAVES if s.qkv_bias else {})}


def shapes(s: Sizes) -> dict[str, tuple]:
    L, d, f = s.layers, s.d, s.d_ff
    out = {
        "wq": (L, d, s.q_width), "wk": (L, d, s.kv_width),
        "wv": (L, d, s.kv_width), "wo": (L, s.q_width, d),
        "w_gate": (L, d, f), "w_in": (L, d, f), "w_out": (L, f, d),
        "embed": (s.vocab, d), "lm_head": (d, s.vocab),
        "attn_norm": (L, d), "mlp_norm": (L, d), "final_norm": (d,),
    }
    if s.qkv_bias:
        out.update(bq=(L, s.q_width), bk=(L, s.kv_width), bv=(L, s.kv_width))
    return out


def make(s: Sizes, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The stacked weights of ``s`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_u63(seed))
    out = {}
    for key, shape in shapes(s).items():
        if key.endswith("norm"):
            out[key] = torch.ones(shape, dtype=dtype, device=device)
            continue
        std = {"embed": 0.02, "bq": BIAS_STD, "bk": BIAS_STD,
               "bv": BIAS_STD}.get(key) or 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        out[key] = w.mul_(std)
    return out


def port_tree(w: dict, s: Sizes) -> dict:
    """The port's parameter tree over views of the stacked weights."""
    blocks = []
    for i in range(s.layers):
        blk = {"mixer": {}, "ffn": {}}
        for key, (part, name) in layer_leaves(s).items():
            blk[part][name] = w[key][i]
        blocks.append(blk)
    return {"blocks": blocks, **{k: w[k] for k in TOP_LEAVES}}


def port_leaves(tree: dict, s: Sizes) -> dict:
    """``{leaf name: tensor}`` of a tree shaped like the port's."""
    out = {}
    for key, (part, name) in layer_leaves(s).items():
        for i in range(s.layers):
            out[f"{key}.{i}"] = tree["blocks"][i][part][name]
    for k in TOP_LEAVES:
        out[k] = tree[k]
    return out


def stacked_leaves(w: dict, s: Sizes) -> dict:
    """``{leaf name: tensor}`` of stacked weights, one view a layer."""
    out = {f"{key}.{i}": w[key][i] for key in layer_leaves(s) for i in range(s.layers)}
    out.update({k: w[k] for k in TOP_LEAVES})
    return out
