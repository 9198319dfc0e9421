"""Dry run: trace every (arch x shape) cell of one rank on the production
mesh, with no device (the counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step over 512
placeholder CPU devices. Here the production mesh is built over torch's
fake process group (``FakeStore``, world 256 or 512: collectives return
at once), and rank 0's step runs eagerly under ``FakeTensorMode`` on
DTensors whose local shards are fake tensors: shapes and dtypes, no
storage. The kernels run as their custom ops' fake implementations, so
the trace sees the kernels' shapes and operations. Any sharding
mismatch, unsupported op or spec bug fails here, as a compile fails
there.

Per cell the record holds (per device, rank 0):

- ``flops``: the operations of every local op, by the formulas of
  ``torch.utils.flop_counter`` (FlopCounterMode's registry, which holds
  the kernel ops' formulas too), counted below DTensor, so a rank's own
  share;
- ``collective_bytes``: `roofline.CollectiveCounter`'s bytes by kind,
  every loop trip included (the reference's loop-corrected
  ``collective_bytes``; its flat count has no counterpart), and the
  largest contributors;
- ``memory``: the local bytes of the arguments and outputs, and the
  step's peak of live local bytes beyond its arguments (the reference's
  ``temp_size_bytes``);
- ``analytic`` and ``roofline``: `roofline.analytic_cost` and the three
  terms at one H100's peaks.

The reference's ``compile_s``, ``bytes_accessed`` and
``generated_code_size_bytes`` describe a compiled XLA program and have
no counterpart; ``trace_s`` is the eager trace's time.

Usage::

    python -m repro_torch.launch.dryrun --arch stablelm_1_6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod]

Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref
from unittest import mock

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import placement_types as _placement_types
from torch.distributed.tensor.placement_types import _StridedShard
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import load_config as _load_config
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.shapes import SHAPES, applicable_shapes
from repro_torch.launch.sharding import placement_leaves
from repro_torch.launch.steps import lowerable
from repro_torch.models.spmd import contiguous_strides
from repro_torch.tree import flatten, unflatten

ARCH_MODULES = [
    "jamba_v0_1_52b",
    "granite_moe_3b_a800m",
    "dbrx_132b",
    "rwkv6_7b",
    "internvl2_76b",
    "qwen1_5_32b",
    "minitron_4b",
    "mistral_nemo_12b",
    "stablelm_1_6b",
    "musicgen_medium",
]
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load_config(arch: str):
    return _load_config(arch)


def cells() -> list[tuple[str, str]]:
    """``--all``'s cells: every arch x every shape, in the reference's
    order (inapplicable ones give a SKIP record)."""
    return [(a, s) for a in ARCH_MODULES for s in SHAPE_NAMES]


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(world: int):
    """The default process group as torch's fake one of ``world`` ranks
    (this process is rank 0), for the block; an existing group of that
    size is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"the dry run needs {world}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_dtensors(mesh, specs, shardings):
    """DTensors of ``specs``' global shapes and dtypes at ``shardings``,
    their local shards made in the active ``FakeTensorMode``."""
    leaves, treedef = flatten(specs)
    out = []
    for spec, pl in zip(leaves, placement_leaves(shardings)):
        shape = tuple(spec.shape)
        with unset_fake_temporarily():  # it computes with small tensors
            local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
        t = torch.empty(local, dtype=spec.dtype)
        out.append(DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=shape, stride=contiguous_strides(shape)))
    return unflatten(treedef, out)


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's DTensors (or tensors)."""
    total = 0
    for leaf in flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            total += t.numel() * t.element_size()
    return total


class LocalCost(TorchDispatchMode):
    """Operations and peak live bytes of this rank's local ops.

    A call on DTensors is handed to DTensor (``NotImplemented``) with
    this mode still on the stack, so what comes back is the rank's own
    calls on local tensors. DTensor's sharding propagation also runs
    each op once on global shapes to learn the output's; those calls are
    not counted (`uncounted_propagation`). Live bytes: every new storage
    an op returns is added, and dropped when the storage is freed."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.paused = False
        self._seen = weakref.WeakValueDictionary()

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[key] = st
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, nbytes)

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if R.is_dtensor_call(args, kwargs):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self._track(out)
        return out


@contextlib.contextmanager
def uncounted_propagation(cost: LocalCost):
    """Pause ``cost`` while DTensor propagates an op's shapes on global
    tensors (``ShardingPropagator._propagate_tensor_meta_non_cached``,
    a private method this torch has; the dry run fails without it)."""
    inner = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        before, cost.paused = cost.paused, True
        try:
            return inner(self, op_schema)
        finally:
            cost.paused = before

    with mock.patch.object(ShardingPropagator,
                           "_propagate_tensor_meta_non_cached", wrapped):
        yield


@contextlib.contextmanager
def cpu_all_to_all():
    """Issue DTensor's shard-to-shard moves as the all-to-all a card mesh
    issues. On a CPU mesh DTensor falls back to an all-gather and a chunk
    (gloo has no all-to-all), which would count the gathered bytes; under
    the fake process group the op's fake implementation gives its
    shape. Without the op in this torch the fallback stays."""
    op = getattr(getattr(torch.ops, "_dtensor", None), "shard_dim_alltoall", None)
    if op is None or not hasattr(_placement_types, "shard_dim_alltoall"):
        yield
        return
    if hasattr(funcol, "_resolve_group"):
        def group_name(group):
            return funcol._group_or_group_name(funcol._resolve_group(group))
    else:  # an older torch names the group directly
        group_name = funcol._resolve_group_name

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim, group_name((mesh, mesh_dim)))

    with mock.patch.object(_placement_types, "shard_dim_alltoall", alltoall):
        yield


@contextlib.contextmanager
def real_shard_offsets():
    """DTensor computes a strided shard's offsets (a flattened (B, S) with
    both dims sharded) with small index tensors and ``.tolist()``, which
    a fake tensor cannot answer; compute them on real tensors (shapes
    only, no model data)."""
    inner = getattr(_StridedShard, "local_shard_size_and_offset", None)
    if inner is None:  # a torch that computes them otherwise
        yield
        return

    def wrapped(*args, **kwargs):
        with unset_fake_temporarily():
            return inner(*args, **kwargs)

    with mock.patch.object(_StridedShard, "local_shard_size_and_offset",
                           wrapped):
        yield


def skip_record(cfg, shape_name: str, multi_pod: bool) -> dict:
    return {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "status": "SKIP",
        "reason": "full-attention arch: 500k dense decode excluded "
        "(sub-quadratic shapes run on jamba/rwkv6 only)",
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             kv_int8: bool = False, *, cfg=None, case=None) -> dict:
    """Trace one cell (rank 0's step); returns its record. ``cfg`` and
    ``case`` override the arch's config and the shape (tests trace
    smoke configs at small shapes)."""
    cfg = cfg or load_config(arch)
    case = case or SHAPES[shape_name]
    if shape_name not in applicable_shapes(cfg):
        return skip_record(cfg, shape_name, multi_pod)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        fn, specs = lowerable(cfg, case, mesh, kv_quant=kv_int8)
        with FakeTensorMode():
            args = [fake_dtensors(mesh, sp, sh)
                    for sp, sh in zip(specs, fn.in_shardings)]
            arg_bytes = local_bytes(args)
            cost, coll = LocalCost(), R.CollectiveCounter()
            # rtlint: disable=clock-domain -- the trace's own duration on the host
            t0 = time.perf_counter()
            with (uncounted_propagation(cost), real_shard_offsets(),
                  cpu_all_to_all(), cost, coll):
                outs = fn(*args)
            # rtlint: disable=clock-domain -- the trace's own duration on the host
            trace_s = time.perf_counter() - t0
            out_bytes = local_bytes(outs)
            del outs
    chips = n_chips(mesh)
    totals = coll.totals()
    acost = R.analytic_cost(cfg, case)
    return {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "status": "OK",
        "chips": chips,
        "trace_s": round(trace_s, 1),
        "flops": float(cost.flops),
        "collective_bytes": totals,
        "collective_breakdown": coll.breakdown(),
        "analytic": {
            "flops": acost.flops,
            "hbm_bytes": acost.hbm_bytes,
            "model_flops": acost.model_flops,
        },
        "roofline": R.roofline(cfg, case, chips, totals["total"]).as_dict(),
        "memory": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": max(0, cost.peak),
        },
    }


def result_path(arch: str, shape: str, multi_pod: bool) -> str:
    root = os.path.join("experiments", "dryrun_torch")
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"{arch}__{shape}__{mesh_name(multi_pod)}.json")


def summary(rec: dict) -> str:
    """One line of an OK record: per-device GB, FLOPs, collective bytes
    by kind, the roofline terms and the dominant one."""
    gb = (rec["memory"]["argument_size_bytes"]
          + rec["memory"]["temp_size_bytes"]) / 1e9
    coll = rec["collective_bytes"]
    kinds = ", ".join(f"{k} {coll[k]:.3e}" for k in R.COLLECTIVES if coll[k])
    rf = rec["roofline"]
    return (f"trace {rec['trace_s']} s, args+temp {gb:.3f} GB/device, flops "
            f"{rec['flops']:.4e}, collectives {coll['total']:.4e} B in "
            f"{coll['count']} ({kinds or 'none'}); roofline compute "
            f"{rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g} s, "
            f"collective {rf['collective_s']:.4g} s, dominant {rf['dominant']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_MODULES)
    ap.add_argument("--shape", choices=list(SHAPE_NAMES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--kv-int8", action="store_true",
                    help="decode variant: int8 KV cache (results get a "
                         "'__kvint8' suffix)")
    args = ap.parse_args()

    if args.all:
        todo = cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        todo = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in todo:
        path = result_path(arch, shape, args.multi_pod)
        if args.kv_int8:
            path = path.replace(".json", "__kvint8.json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                rec = json.load(f)
            print(f"[cached] {arch} {shape}: {rec['status']}")
            continue
        print(f"[run] {arch} x {shape} ({mesh_name(args.multi_pod)})", flush=True)
        try:
            rec = run_cell(arch, shape, args.multi_pod, kv_int8=args.kv_int8)
        except Exception as e:  # a failed cell is a bug in the system
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "mesh": mesh_name(args.multi_pod),
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "OK":
            print(f"  OK: {summary(rec)}", flush=True)
        else:
            print(f"  {rec['status']}: {rec.get('reason', rec.get('error', ''))}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
