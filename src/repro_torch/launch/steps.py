"""Step functions: train_step, prefill_step and serve_step, and
`lowerable`, which lays one (arch x shape) cell out on a mesh (the
counterparts of ``repro.launch.steps``).

PyTorch runs eagerly, so a step is a plain closure over the config. The
serve step takes the JAX package's int8 KV cache variant (``kv_quant``).
The train step takes its ``remat`` and ``micro_batches``, which
`auto_micro_batches` plans for a production mesh. Every builder takes a
`lm.ShardingPolicy` (`activation_policy` builds the reference's), and
the train step ``grad_shardings``: the parameters' placements, to which
each gradient is redistributed (the reference pins them there, so the
data-axis reduction becomes a reduce-scatter into the FSDP shard).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.launch.shapes import (
    ShapeCase,
    input_specs,
    opt_spec,
    params_spec,
)
from repro_torch.launch.sharding import (
    batch_shardings,
    cache_shardings,
    is_placements,
    opt_state_shardings,
    placement_leaves,
    placements,
    replicated,
    shardings_for_tree,
)
from repro_torch.models import lm
from repro_torch.models.spmd import contiguous_strides, is_sharded, plain_replicated
from repro_torch.obs import spans
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import flatten, tree_map, unflatten


def activation_policy(mesh, *, batch_sharded: bool = True,
                      seq_parallel: bool = False,
                      n_experts: int = 0) -> lm.ShardingPolicy:
    """Pin activations batch-over-data and CE logits vocab-over-model
    (the reference's policy, each field a ``(mesh, spec)``).

    ``seq_parallel=True`` (train/prefill, S >> 1) also shards the
    *sequence* dim over ``model`` at block boundaries (Megatron-SP): the
    carry each checkpointed repeat keeps shrinks by the model-axis size.
    ``batch_sharded=False`` (long_500k, batch 1) returns `lm.NO_POLICY`:
    the parallel axis there is the cache's sequence dim. The expert
    dispatch is expert-parallel (E over ``model``) only when the expert
    count divides the axis; else E stays whole and the expert products
    run tensor-parallel over d_ff, as `sharding.param_spec` falls back.
    """
    if mesh is None or not batch_sharded:
        return lm.NO_POLICY
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    seq_axis = "model" if seq_parallel else None
    groups = math.prod(sizes[a] for a in ba)
    ep_ok = n_experts == 0 or n_experts % sizes["model"] == 0
    # E-leading dispatch layout (see layers.moe_capacity)
    dispatch = ("model", ba, None, None) if ep_ok else (None, ba, None, None)
    return lm.ShardingPolicy(
        act=(mesh, (ba, seq_axis, None)),
        logits=(mesh, (ba, None, "model")),
        moe_groups=groups,
        moe_dispatch=(mesh, dispatch),
        heads=(mesh, (ba, None, "model", None)),
        channels=(mesh, (ba, None, "model")),
        gathered=(mesh, (ba, None, None)),
    )


def value_and_grad(params, cfg: ArchConfig, batch, *, remat: bool = True,
                   policy: lm.ShardingPolicy = lm.NO_POLICY,
                   grad_shardings=None):
    """((loss, metrics), grads) of `lm.loss_fn` at ``params``, grads a
    tree like ``params`` in each leaf's own dtype (as
    ``jax.value_and_grad`` gives them). ``params`` are not modified.
    Under a profiler the forward and the gradient are the spans
    ``train.forward`` and ``train.backward`` (`repro_torch.obs.spans`).
    With ``grad_shardings`` (a tree of placements like ``params``) each
    DTensor gradient is redistributed there."""
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    rec = spans.active()
    # the backward recomputes checkpointed blocks: plain tensors made
    # there meet DTensors too
    with torch.enable_grad(), plain_replicated():
        with spans.span(rec, "train.forward", leaves[0]):
            loss, metrics = lm.loss_fn(unflatten(treedef, live), cfg, batch,
                                       remat=remat, policy=policy)
        with spans.span(rec, "train.backward", leaves[0]):
            grads = torch.autograd.grad(loss, live)
    if grad_shardings is not None:
        grads = [g.redistribute(g.device_mesh, pl) if is_sharded(g) else g
                 for g, pl in zip(grads, placement_leaves(grad_shardings))]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(treedef, grads)


def _micro_batch(leaf, i: int, n: int):
    """Micro-batch ``i`` of ``n`` of a batch leaf. A DTensor leaf sharded
    over the batch is split on each rank's own rows, so every micro-batch
    stays sharded over the data axes; micro-batch i then holds each
    shard's i-th slice (the reference reshapes the global batch, i.e. its
    i-th contiguous slice). With equal token counts per row, as the data
    pipeline's all-ones masks give, the accumulated gradient and the
    mean metrics are the same sums either way."""
    if is_sharded(leaf):
        local = leaf.to_local()
        b = local.shape[0] // n
        shape = (leaf.shape[0] // n, *leaf.shape[1:])
        return DTensor.from_local(local[i * b:(i + 1) * b], leaf.device_mesh,
                                  leaf.placements, run_check=False,
                                  shape=shape, stride=contiguous_strides(shape))
    b = leaf.shape[0]
    return leaf.reshape(n, b // n, *leaf.shape[1:])[i]


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    policy: lm.ShardingPolicy = lm.NO_POLICY,
    micro_batches: int = 1,
    grad_shardings=None,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``micro_batches > 1`` runs gradient accumulation: the global batch
    is split on the batch axis and the micro-batches run in order,
    accumulating fp32 grads that are divided by the count afterwards;
    the metrics are the micro-batches' means. Weight decay goes to the
    leaves the JAX package decays (`lm.decay_mask`). ``policy`` and
    ``grad_shardings`` go to `value_and_grad`. Under a profiler the
    update is the span ``train.optimizer`` (`repro_torch.obs.spans`).
    """
    vg = dict(remat=remat, policy=policy, grad_shardings=grad_shardings)

    def train_step(params, opt_state, batch):
        if micro_batches == 1:
            (loss, metrics), grads = value_and_grad(params, cfg, batch, **vg)
        else:
            grads, ms = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params), []
            for i in range(micro_batches):
                mb = {k: _micro_batch(v, i, micro_batches)
                      for k, v in batch.items()}
                (_, m), g = value_and_grad(params, cfg, mb, **vg)
                grads = tree_map(lambda a, gi: a + gi.float(), grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / micro_batches, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        with spans.span(spans.active(), "train.optimizer", opt_state["step"]):
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


def make_prefill_step(cfg: ArchConfig, cache_len: int, *,
                      policy: lm.ShardingPolicy = lm.NO_POLICY):
    """(params, batch) -> (last-token logits, cache)."""

    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch, cache_len, policy=policy)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *,
                    policy: lm.ShardingPolicy = lm.NO_POLICY,
                    kv_quant: bool = False):
    """(params, cache, inputs, pos) -> (logits, cache); with ``kv_quant``
    the cache's attention layers are int8 with bf16 scales."""

    def serve_step(params, cache, inputs, pos):
        return lm.decode_step(params, cfg, cache, inputs, pos, policy=policy,
                              kv_quant=kv_quant)

    return serve_step


def _lay_out(tree, shardings):
    """Every DTensor of ``tree`` redistributed to its placements in
    ``shardings`` (a tree like it, or one placements tuple for all); a
    plain tensor raises. The counterpart of jit's in/out shardings."""
    leaves, treedef = flatten(tree)
    pls = ([shardings] * len(leaves) if is_placements(shardings)
           else placement_leaves(shardings))
    if len(pls) != len(leaves):
        raise ValueError("a tree and its shardings differ in structure")
    out = []
    for leaf, pl in zip(leaves, pls):
        if not is_sharded(leaf):
            raise TypeError(f"a laid-out step takes DTensors, got a plain "
                            f"{type(leaf).__name__} {tuple(leaf.shape)}")
        out.append(leaf.redistribute(leaf.device_mesh, pl))
    return unflatten(treedef, out)


def _laid_out(step, in_shardings, out_shardings):
    def fn(*args):
        args = [_lay_out(a, s) for a, s in zip(args, in_shardings)]
        outs = step(*args)
        return tuple(_lay_out(o, s) for o, s in zip(outs, out_shardings))

    fn.in_shardings, fn.out_shardings = in_shardings, out_shardings
    return fn


def lowerable(cfg: ArchConfig, case: ShapeCase, mesh,
              opt_cfg: AdamWConfig | None = None, *, kv_quant: bool = False):
    """(fn, args) for one (arch x shape) cell on ``mesh``.

    ``args`` are meta-tensor specs (`launch.shapes`): the global shapes
    and dtypes of the step's arguments. ``fn`` takes DTensors on
    ``mesh``, redistributes each to the reference's in-sharding (a plain
    tensor raises), runs the step under the reference's activation
    policy, and returns its outputs at the reference's out-shardings;
    ``fn.in_shardings`` / ``fn.out_shardings`` hold the placements. The
    train step takes `auto_micro_batches`' plan and pins gradients to the
    parameters' placements; prefill and decode shard their caches as
    `sharding.cache_shardings` says (``long_500k``, batch 1: the cache's
    sequence dim over every axis, and `lm.NO_POLICY`). ``kv_quant``
    switches the decode cache to int8 with scales. jit's buffer donation
    has no eager counterpart: the train step returns new parameters and
    moments beside the old, and the caller drops the old.
    """
    opt_cfg = opt_cfg or AdamWConfig()
    p_spec = params_spec(cfg)
    p_shard = shardings_for_tree(mesh, p_spec)
    specs = input_specs(cfg, case, kv_quant=kv_quant and case.kind == "decode")
    ba = batch_axes(mesh)

    if case.kind == "train":
        o_spec = opt_spec(p_spec)
        o_shard = opt_state_shardings(mesh, p_shard)
        b_shard = batch_shardings(mesh, specs["batch"])
        policy = activation_policy(mesh, seq_parallel=True,
                                   n_experts=cfg.n_experts)
        step = make_train_step(
            cfg, opt_cfg, policy=policy,
            micro_batches=auto_micro_batches(cfg, case, mesh),
            grad_shardings=p_shard)
        fn = _laid_out(step, (p_shard, o_shard, b_shard),
                       (p_shard, o_shard, replicated(mesh)))
        return fn, (p_spec, o_spec, specs["batch"])

    if case.kind == "prefill":
        b_shard = batch_shardings(mesh, specs["batch"])
        policy = activation_policy(mesh, seq_parallel=True,
                                   n_experts=cfg.n_experts)
        cache = input_specs(cfg, ShapeCase(case.name, case.seq_len,
                                           case.global_batch, "decode"))["cache"]
        c_shard = cache_shardings(mesh, cache, seq_sharded=False)
        fn = _laid_out(make_prefill_step(cfg, case.seq_len, policy=policy),
                       (p_shard, b_shard),
                       (placements(mesh, (ba, None)), c_shard))
        return fn, (p_spec, specs["batch"])

    seq_sharded = case.global_batch == 1
    c_shard = cache_shardings(mesh, specs["cache"], seq_sharded=seq_sharded)
    policy = activation_policy(mesh, batch_sharded=not seq_sharded,
                               n_experts=cfg.n_experts)
    if seq_sharded:
        i_shard = pos_shard = logits_shard = replicated(mesh)
    else:
        i_shard = batch_shardings(mesh, specs["inputs"])
        pos_shard = placements(mesh, (ba,))
        logits_shard = placements(mesh, (ba, None))
    fn = _laid_out(make_serve_step(cfg, policy=policy, kv_quant=kv_quant),
                   (p_shard, c_shard, i_shard, pos_shard),
                   (logits_shard, c_shard))
    return fn, (p_spec, specs["cache"], specs["inputs"], specs["pos"])
