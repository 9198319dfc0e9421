"""LM serving step functions: prefill_step and serve_step (the
counterparts of ``repro.launch.steps.make_prefill_step`` and
``make_serve_step``).

PyTorch runs eagerly, so a step is a plain closure over the config; the
JAX package's sharding policy, remat switch and int8 KV cache have no
counterpart on one card.
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


def make_serve_step(cfg: ArchConfig):
    """(params, cache, inputs, pos) -> (logits, cache)."""
    lm.check_supported(cfg)

    def serve_step(params, cache, inputs, pos):
        return lm.decode_step(params, cfg, cache, inputs, pos)

    return serve_step
