"""Step functions: train_step, prefill_step and serve_step (the
counterparts of ``repro.launch.steps.make_train_step``,
``make_prefill_step`` and ``make_serve_step``).

PyTorch runs eagerly, so a step is a plain closure over the config. The
serve step takes the JAX package's int8 KV cache variant (``kv_quant``).
The train step takes its ``remat`` and ``micro_batches``; its sharding
arguments (``policy``, ``grad_shardings``) and the micro-batch and
activation planners do nothing on one card and come with distribution.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import flatten, tree_map, unflatten


def value_and_grad(params, cfg: ArchConfig, batch, *, remat: bool = True):
    """((loss, metrics), grads) of `lm.loss_fn` at ``params``, grads a
    tree like ``params`` in each leaf's own dtype (as
    ``jax.value_and_grad`` gives them). ``params`` are not modified."""
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(unflatten(treedef, live), cfg, batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(treedef, grads)


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    micro_batches: int = 1,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``micro_batches > 1`` runs gradient accumulation: the global batch
    is split on the batch axis and the micro-batches run in order,
    accumulating fp32 grads that are divided by the count afterwards;
    the metrics are the micro-batches' means. Weight decay goes to the
    leaves the JAX package decays (`lm.decay_mask`).
    """

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = value_and_grad(params, cfg, batch,
                                                    remat=remat)
        else:
            def split(leaf, i):
                b = leaf.shape[0]
                return leaf.reshape(micro_batches, b // micro_batches,
                                    *leaf.shape[1:])[i]

            grads, ms = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params), []
            for i in range(micro_batches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (_, m), g = value_and_grad(params, cfg, mb, remat=remat)
                grads = tree_map(lambda a, gi: a + gi.float(), grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / micro_batches, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg, decay=lm.decay_mask(params)
        )
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    """(params, batch) -> (last-token logits, cache)."""

    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, kv_quant: bool = False):
    """(params, cache, inputs, pos) -> (logits, cache); with ``kv_quant``
    the cache's attention layers are int8 with bf16 scales."""

    def serve_step(params, cache, inputs, pos):
        return lm.decode_step(params, cfg, cache, inputs, pos, kv_quant=kv_quant)

    return serve_step
