"""Sharding rules: parameter / optimizer / batch / cache placements (the
counterpart of ``repro.launch.sharding``).

Scheme (single pod: mesh ``(data=16, model=16)``; multi-pod adds a
leading ``pod`` axis used for cross-pod DP):

- **FSDP on ``data``**: every weight matrix shards its *input* feature
  dim over ``data``.
- **TP on ``model``** (Megatron column/row): projections in
  (``wq/wk/wv/w_in/w_gate``) shard the output dim on ``model``;
  projections out (``wo/w_out/out_proj``) shard the input dim on
  ``model`` so the pair needs one reduce per block.
- **EP on ``model``** for MoE expert banks (expert dim sharded, when the
  expert count divides the axis; else tensor-parallel over d_ff).
- vectors / norms / small tensors are replicated.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
an axis name, or a tuple of axis names (that dim sharded over their
product, the first major), as the JAX package's ``PartitionSpec``.
Parameters and caches are held per layer here, so a block leaf's spec
is the JAX package's stacked spec without its leading repeats ``None``.
`placements` turns a spec into DTensor placements on a ``DeviceMesh``,
one per mesh dim, as ``distribute_tensor(t, mesh, placements)`` takes
them (the counterpart of ``NamedSharding(mesh, spec)``).

Rules are name-based over the tree paths (``repro_torch.tree``'s key
strings) so the same function covers all 10 architectures (attn,
mamba, rwkv, moe leaves).
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.tree import flatten_with_paths, tree_map, unflatten

# param names that are row-parallel (input dim on `model`)
_ROW_PARALLEL = {"wo", "w_out", "out_proj"}
# param names that are column-parallel (output dim on `model`)
_COL_PARALLEL = {
    "wq", "wk", "wv", "wg", "wr", "w_in", "w_gate", "in_proj",
    "frontend_proj", "lm_head",
}


def _keys(path: str) -> list[str]:
    """The dict keys along a `repro_torch.tree` path (``['blocks']/[3]/
    ['mixer']/['wq']`` -> ``["blocks", "mixer", "wq"]``)."""
    return [part[2:-2] for part in path.split("/") if part.startswith("['")]


def param_spec(path: str, leaf, model_size: int | None = None) -> tuple:
    """The spec of one parameter leaf (see module docstring).

    ``model_size`` enables divisibility-aware choices: expert banks use
    EP when the expert count divides the model axis, else
    tensor-parallel over d_ff (granite's 40 experts on a 16-way axis).
    """
    keys = _keys(path)
    name = keys[-1] if keys else ""
    in_block = "blocks" in keys
    nd = leaf.ndim

    if name == "embed":  # (vocab, d): d on model, vocab replicated
        return (None, "model")

    if name == "router":  # (d, E): replicate E (tiny, fp32)
        return ("data", None)

    if in_block and nd == 3:  # MoE expert bank (E, d_in, d_out)
        n_experts = leaf.shape[0]
        ep_ok = model_size is None or n_experts % model_size == 0
        if name in _ROW_PARALLEL:
            return ("model", None, "data") if ep_ok else (None, "model", "data")
        return ("model", "data", None) if ep_ok else (None, "data", "model")

    if in_block and nd == 2:  # per-layer matrix (in, out)
        if name in _ROW_PARALLEL:
            return ("model", "data")
        if name in _COL_PARALLEL:
            return ("data", "model")
        return (None, None)  # conv_w, lora, A_log, u, ...

    if not in_block and nd == 2:  # top-level matrix (in, out)
        if name in _COL_PARALLEL:
            return ("data", "model")
        return (None, None)

    return (None,) * nd  # vectors, scalars, biases, norms


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec names that axis at tensor dim ``d``,
    else ``Replicate()``."""
    out = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for axis in (axes if isinstance(axes, tuple) else (axes,)):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def shardings_for_tree(mesh, tree):
    """Placements for every leaf of a parameter tree, by `param_spec`."""
    model_size = axis_sizes(mesh).get("model")
    paths, leaves, treedef = flatten_with_paths(tree)
    return unflatten(treedef, [
        placements(mesh, param_spec(path, leaf, model_size))
        for path, leaf in zip(paths, leaves)
    ])


def opt_state_shardings(mesh, param_shardings):
    """AdamW state: moments mirror the params; step is replicated."""
    return {
        "m": param_shardings,
        "v": param_shardings,
        "step": replicated(mesh),
    }


def batch_shardings(mesh, batch_tree):
    """Batch dict: leading dim over the batch axes, rest replicated."""
    ba = batch_axes(mesh)
    return tree_map(
        lambda leaf: placements(mesh, (ba,) + (None,) * (leaf.ndim - 1)),
        batch_tree,
    )


def _cache_leaf_spec(mesh, name: str, leaf, *, seq_sharded: bool) -> tuple:
    """Decode-cache leaf specs, per layer.

    KV caches shard the *sequence* dim (flash-decode style): kv-head
    counts (8/24/40) do not divide model=16 while every cache length
    does. The decode softmax/readout over the sharded S axis becomes a
    small partial-stat all-reduce.

    ``seq_sharded=True`` (long_500k, batch=1): the batch axes are
    unusable, so S shards over the whole (data x model) product and
    channel-state dims over all divisible axes.
    """
    ba = batch_axes(mesh)
    nd = leaf.ndim
    all_ax = tuple(mesh.mesh_dim_names)  # e.g. ("pod","data","model")
    if name in ("k", "v"):  # (B, kv, S, hd)
        if seq_sharded:
            return (None, None, all_ax, None)
        return (ba, None, "model", None)
    if name in ("k_scale", "v_scale"):  # (B, kv, S)
        if seq_sharded:
            return (None, None, all_ax)
        return (ba, None, "model")
    if name == "ssm":  # (B, di, ns)
        if seq_sharded:
            return (None, all_ax, None)
        return (ba, "model", None)
    if name == "conv":  # (B, dc-1, di)
        if seq_sharded:
            return (None, None, all_ax)
        return (ba, None, "model")
    if name == "S":  # rwkv state (B, H, hd, hd)
        if seq_sharded:
            return (None, "model", None, None)
        return (ba, "model", None, None)
    if name in ("tmix_last", "cmix_last"):  # (B, d)
        if seq_sharded:
            return (None, "model")
        return (ba, None)
    return (None,) * nd


def cache_shardings(mesh, cache_tree, *, seq_sharded: bool = False):
    """Placements for every leaf of a per-layer decode cache."""
    paths, leaves, treedef = flatten_with_paths(cache_tree)
    return unflatten(treedef, [
        placements(mesh, _cache_leaf_spec(mesh, _keys(path)[-1], leaf,
                                          seq_sharded=seq_sharded))
        for path, leaf in zip(paths, leaves)
    ])


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim
