"""LM serving step functions: prefill_step and serve_step (the
counterparts of ``repro.launch.steps.make_prefill_step`` and
``make_serve_step``).

PyTorch runs eagerly, so a step is a plain closure over the config. The
serve step takes the JAX package's int8 KV cache variant (``kv_quant``);
its sharding policy and remat switch do nothing on one card and return
with distribution.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """(params, batch) -> (last-token logits, cache)."""
    lm.check_supported(cfg)

    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, kv_quant: bool = False):
    """(params, cache, inputs, pos) -> (logits, cache); with ``kv_quant``
    the cache's attention layers are int8 with bf16 scales."""
    lm.check_supported(cfg)

    def serve_step(params, cache, inputs, pos):
        return lm.decode_step(params, cfg, cache, inputs, pos, kv_quant=kv_quant)

    return serve_step
