"""Step functions: train_step, prefill_step and serve_step (the
counterparts of ``repro.launch.steps.make_train_step``,
``make_prefill_step`` and ``make_serve_step``).

PyTorch runs eagerly, so a step is a plain closure over the config. The
serve step takes the JAX package's int8 KV cache variant (``kv_quant``).
The train step takes its ``remat`` and ``micro_batches``, which
`auto_micro_batches` plans for a production mesh; its sharding
arguments (``policy``, ``grad_shardings``) and the activation planner
do nothing on one card and come with distribution.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.launch.shapes import ShapeCase
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


#: target upper bound on the dominant per-device live activation set
_STASH_BUDGET_BYTES = (1 << 30) * 3 // 4


def auto_micro_batches(cfg: ArchConfig, case: ShapeCase, mesh) -> int:
    """Smallest power-of-two divisor of the per-device batch keeping the
    dominant live buffers under budget on ``mesh`` (a device mesh with
    the production axes). Model (all scale ~1/u):

    - per-repeat carry stash the backward keeps:
      ``n_layers x B_loc x S/model x d x 2B``;
    - MoE combine output (fp32, full-S per data shard):
      ``T_loc x d x 4B``;
    - MoE dispatch (G, E, C, d) bf16, /model when expert-parallel.
    """
    sizes = axis_sizes(mesh)
    n_data = 1
    for a in batch_axes(mesh):
        n_data *= sizes[a]
    model = sizes.get("model", 1)
    b_loc = max(1, case.global_batch // n_data)
    s_loc = max(1, case.seq_len // model)
    live = cfg.n_layers * b_loc * s_loc * cfg.d_model * 2
    if cfg.n_experts:
        t_loc = b_loc * case.seq_len
        live += t_loc * cfg.d_model * 4  # fp32 combine
        disp = t_loc * cfg.top_k * cfg.capacity_factor * cfg.d_model * 2
        if cfg.n_experts % model == 0:
            disp /= model  # expert-parallel dispatch is model-sharded
        live += disp
    micro = 1
    while micro < b_loc and live / micro > _STASH_BUDGET_BYTES:
        micro *= 2
    while b_loc % micro:
        micro //= 2
    return max(1, micro)


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
