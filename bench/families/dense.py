"""The dense family: pre-norm decoders of RMSNorm, GQA causal attention
with rotary on the whole head (q, k and v biases where the file says
``qkv_bias``) and a SwiGLU MLP, then a final RMSNorm and an untied head
(`reference/dense.py`). Its sizes, weights and counts are the frozen
`benchkit.model`, `benchkit.weights` and `benchkit.flops`; this module
names them for the harness as `benchkit.spec` sets out. Every layer
holds attention, so every layer's cache holds ``k`` and ``v``."""
from __future__ import annotations

from benchkit import flops, weights
from benchkit.model import Sizes, arch_config, sizes

__all__ = ["sizes", "arch_config", "make_weights", "port_tree", "port_leaves",
           "stacked_leaves", "cache_views", "prefill_flops", "train_step_flops",
           "attention_layers", "attention_shape"]

make_weights = weights.make
port_tree = weights.port_tree
port_leaves = weights.port_leaves
stacked_leaves = weights.stacked_leaves
prefill_flops = flops.prefill_flops
train_step_flops = flops.train_step_flops


def attention_layers(s: Sizes) -> int:
    return s.layers


def attention_shape(s: Sizes) -> tuple[int, int, int]:
    return s.heads, s.kv_heads, s.head_dim


def cache_views(cache: list, S: int) -> list[dict]:
    """Each layer's K and V over the prompt's ``S`` positions, (B, S, kv,
    hd), from the port's (B, kv, cache_len, hd) cache."""
    return [{"k": c["k"][:, :, :S].transpose(1, 2), "v": c["v"][:, :, :S].transpose(1, 2)}
            for c in cache]
