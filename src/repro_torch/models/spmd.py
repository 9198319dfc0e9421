"""Hand-written kernels on the local shards of DTensors.

Under a sharding policy (`lm.ShardingPolicy`) the model's activations
are DTensors and every plain op propagates its sharding as GSPMD does.
A kernel op has no sharding rule: `on_shards` runs it on each rank's
shard instead, the counterpart of the reference's GSPMD partitioning of
its Pallas calls (batch over the data axes, heads or channels over
``model``).

`pin` is the redistribution behind every policy pin.

A tensor's layout is ``(batch_dim, model_dim)``: the tensor dim the
batch axes (``pod``, ``data``) shard, and the one ``model`` shards
(``None``: replicated over those axes). An output's ``model_dim`` may be
``"partial"``: each rank holds a partial sum over ``model``, which a
later pin reduces.

This is ``torch.distributed.tensor.experimental.local_map`` with the
global shapes given: ``local_map`` infers an output's global shape from
the local one times the axis size, which cannot express an uneven shard
(Granite's 24 heads on a 16-wide ``model`` axis: ranks 0-11 hold 2
heads, 12-15 none).
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.sharding import placements


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


_depth = [0]


@contextlib.contextmanager
def plain_replicated():
    """Inside, a plain tensor that meets a DTensor takes part as a
    replicated one (positions, masks and zeros made inside the model).
    ``implicit_replication`` itself switches off on leaving, even when
    nested, so only the outermost entry enters it."""
    _depth[0] += 1
    try:
        if _depth[0] == 1:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _depth[0] -= 1


def pin(x, field):
    """``x`` redistributed to ``field``, a ``(mesh, spec)`` pair in
    `launch.sharding`'s spec language: the counterpart of
    ``jax.lax.with_sharding_constraint``. ``None`` returns ``x``
    unchanged; a plain tensor raises, since a tensor that lost its
    DTensor wrapper would otherwise pass unpinned."""
    if field is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"a sharding pin needs a DTensor, got a plain {type(x).__name__} "
            f"of shape {tuple(x.shape)}")
    mesh, spec = field
    return x.redistribute(mesh, placements(mesh, spec))


def whole_units(t, dim: int, units: int):
    """``t`` with dim ``dim`` gathered over every axis whose size does not
    divide ``units`` (the heads or groups the dim is about to be split
    into or merged from): a shard boundary would fall inside a unit,
    which DTensor cannot view (GSPMD pads there). Plain tensors pass."""
    if not is_sharded(t):
        return t
    mesh, pls = t.device_mesh, list(t.placements)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim % t.ndim == dim % t.ndim and units % mesh.size(i):
            pls[i] = Replicate()
    return t if pls == list(t.placements) else t.redistribute(mesh, pls)


def residual(x, y):
    """``x + y``. A DTensor ``y`` is first redistributed to ``x``'s
    placements (under sequence parallelism the reduce-scatter after an
    output projection), so that its gradient comes back at ``y``'s own
    placements: a block's products then never see a gradient sharded
    over both B and S, which DTensor cannot flatten for a matmul."""
    if (is_sharded(y) and list(y.placements) != list(x.placements)
            and not any(p.is_partial() for p in x.placements)):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def reduced(t):
    """A DTensor's pending partial sums reduced (replicated over those
    axes); plain tensors pass. A gather from a vocabulary-sharded tensor
    returns a masked partial sum, which must be reduced before the
    gathered dim is indexed away."""
    if not is_sharded(t) or not any(p.is_partial() for p in t.placements):
        return t
    pls = [Replicate() if p.is_partial() else p for p in t.placements]
    return t.redistribute(t.device_mesh, pls)


class _GradAs(torch.autograd.Function):
    """Identity whose gradient is redistributed to the forward output's
    placements (the gradient may arrive sharded where a view's backward
    cannot split it)."""

    @staticmethod
    def forward(ctx, t):
        # a partial sum's gradient is the same on every rank: replicated
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in t.placements]
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if list(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(grad.device_mesh, ctx.placements)


def _reshaped(t, shape):
    out = t.reshape(shape)
    if is_sharded(out) and torch.is_grad_enabled() and out.requires_grad:
        out = _GradAs.apply(out)
    return out


def batch_only(t):
    """``t`` gathered over every axis that shards a dim other than the
    batch (dim 0); plain tensors pass. Before a reshape that merges the
    batch with the sequence: DTensor cannot merge two sharded dims."""
    if not is_sharded(t):
        return t
    pls = [Replicate() if isinstance(p, Shard) and p.dim % t.ndim else p
           for p in t.placements]
    return t if pls == list(t.placements) else t.redistribute(t.device_mesh, pls)


def split_heads(t, heads: int, hd: int):
    """(..., heads * hd) -> (..., heads, hd), through `whole_units`; the
    gradient comes back at the same placements."""
    return _reshaped(whole_units(t, -1, heads), (*t.shape[:-1], heads, hd))


def merge_heads(t):
    """(..., heads, hd) -> (..., heads * hd), through `whole_units`; the
    gradient comes back at the same placements."""
    return _reshaped(whole_units(t, -2, t.shape[-2]), (*t.shape[:-2], -1))


def _placements(mesh, layout) -> list:
    batch_dim, model_dim = layout
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dim = model_dim if name == "model" else batch_dim
        if dim is None or (dim != "partial" and mesh.size(i) == 1):
            out.append(Replicate())
        elif dim == "partial":
            out.append(Partial())
        else:
            out.append(Shard(dim))
    return out


def contiguous_strides(shape) -> tuple:
    """Contiguous strides of ``shape`` (a DTensor's global stride)."""
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def on_shards(fn, args, layouts, out_layouts, out_shapes):
    """``fn`` on the local shards of ``args``, its outputs as DTensors.

    ``args``: DTensors on one mesh, or plain tensors (the same on every
    rank, taken as replicated), ``None`` passing through; each is
    redistributed to its layout first. ``out_layouts`` and
    ``out_shapes`` (global) describe ``fn``'s outputs: one each for a
    single tensor, a tuple each for a tuple. Differentiable: the
    redistribution and the local views carry gradients; an input
    replicated over an axis that another input is sharded over gets its
    gradient as a partial sum there (each rank's share).
    """
    mesh = next(a.device_mesh for a in args if is_sharded(a))
    args = [a if a is None or is_sharded(a)
            else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
            for a in args]
    pls = [_placements(mesh, lay) for lay in layouts]
    # the mesh axes some input is sharded over: there each rank computes
    # on its own data, so an input replicated there gets a partial sum of
    # its gradient on each rank
    varying = {i for pl in pls for i, p in enumerate(pl) if p.is_shard()}
    local = [
        None if a is None
        else a.redistribute(mesh, pl).to_local(grad_placements=[
            Partial() if i in varying and p.is_replicate() else p
            for i, p in enumerate(pl)])
        for a, pl in zip(args, pls)
    ]
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    if single:
        outs, out_layouts, out_shapes = (outs,), (out_layouts,), (out_shapes,)
    wrapped = tuple(
        DTensor.from_local(o, mesh, _placements(mesh, lay), run_check=False,
                           shape=tuple(shape), stride=contiguous_strides(tuple(shape)))
        for o, lay, shape in zip(outs, out_layouts, out_shapes)
    )
    return wrapped[0] if single else wrapped
