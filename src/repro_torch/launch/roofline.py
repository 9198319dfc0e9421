"""Roofline analysis: analytic compute and memory terms, and the
collective bytes of a traced step (the counterpart of
``repro.launch.roofline``).

1. **Compute / memory terms**: `analytic_cost`, per (arch x shape), built
   from the same layer chains the DSE prices (`models.extract`), with
   the reference's arithmetic unchanged. `roofline` divides them by the
   card's peaks.

2. **Collective term**: the reference parses the compiled HLO, scaling
   each ``while`` body's collectives by its trip count. PyTorch has no
   HLO: a step runs eagerly, so `CollectiveCounter` (a dispatch mode)
   sees every collective of the traced step as it is issued, each loop
   trip included, and sums the result-shape bytes by the reference's
   five kinds. The reference's HLO parsers (``collective_bytes_hlo``,
   ``collective_breakdown``) have no input here and are not ported;
   `CollectiveCounter.breakdown` is the itemised form.

Peaks default to one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989
TFLOP/s bf16 on the tensor cores and 3.35 TB/s of HBM, the rates
``chip_smoke.py`` bounds its kernels with. The collective bandwidth is
one 400 Gb/s NDR InfiniBand port per GPU, 50 GB/s: a 16-wide ``model``
axis spans two 8-GPU NVLink nodes, so its collectives cross the
network, and the single-bandwidth form charges every collective byte at
the slowest link it may take. An axis that stays inside a node would
run at NVLink's 450 GB/s each way (`NVLINK_BW`).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.shapes import ShapeCase
from repro_torch.models.extract import arch_workload

#: bf16 dense tensor-core peak of one H100 SXM, FLOP/s
PEAK_FLOPS = 989e12
#: float32 peak outside the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12
#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BW = 3.35e12
#: one 400 Gb/s NDR port per GPU, bytes/s (the collective term's rate)
ICI_BW = 50e9
#: NVLink 4, one direction, bytes/s (an axis inside one 8-GPU node)
NVLINK_BW = 450e9

#: the reference's collective kinds, in its order
COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclass(frozen=True)
class CostModel:
    """Per-STEP global costs (divide by chips for per-device)."""

    flops: float  # executed FLOPs incl. backward + remat recompute
    hbm_bytes: float  # HBM traffic
    model_flops: float  # 6 N D (dense) / 6 N_active D (MoE)

    def useful_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0


def analytic_cost(cfg: ArchConfig, case: ShapeCase) -> CostModel:
    """The reference's formulas, unchanged:

    - fwd FLOPs F = sum of layer-chain GEMM/attention/scan FLOPs
      (`models.extract`, mode-matched) + LM head.
    - train: ``4F`` (fwd + 2x bwd + full-remat recompute).
    - prefill: ``F``; decode: ``F`` with decode-mode chains (one token
      against the case's cache).
    - HBM bytes: weight streams (3 passes train, 1 inference) +
      layer-chain activation/cache traffic + optimizer read/write (16
      B/param: fp32 m, v read+write) + param read/write (2+2 B) on train.
    - model FLOPs: 6 N D (train) or 2 N D (inference) with N the
      active parameters (`ArchConfig.param_counts`) and D the tokens
      processed (train/prefill: B*S; decode: B).
    """
    mode = {"train": "train", "prefill": "prefill", "decode": "decode"}[
        case.kind
    ]
    wl = arch_workload(cfg, case.global_batch, case.seq_len, mode=mode)
    chain_flops = wl.total_flops()
    chain_bytes = wl.total_bytes()
    counts = cfg.param_counts()
    n_params, n_active = counts["total"], counts["active"]

    if case.kind == "train":
        # extract's train mode already multiplies by 3 (fwd+bwd);
        # remat recompute adds one more forward -> 4/3 of that.
        flops = chain_flops * (4.0 / 3.0)
        weight_stream = 2.0 * n_params * 3.0  # bf16, fwd+bwd+remat passes
        opt_traffic = n_params * (16.0 + 4.0)  # m,v fp32 rw + param rw bf16
        hbm = chain_bytes * (4.0 / 3.0) + weight_stream + opt_traffic
        tokens = case.global_batch * case.seq_len
    elif case.kind == "prefill":
        flops = chain_flops
        hbm = chain_bytes + 2.0 * n_active
        tokens = case.global_batch * case.seq_len
    else:  # decode
        flops = chain_flops
        hbm = chain_bytes + 2.0 * n_active
        tokens = case.global_batch
    # 6 N D counts fwd+bwd (2+4); inference runs the forward only -> 2 N D
    factor = 6.0 if case.kind == "train" else 2.0
    model_flops = factor * n_active * tokens
    return CostModel(flops=flops, hbm_bytes=hbm, model_flops=model_flops)


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    useful_ratio: float
    roofline_fraction: float  # compute_s / max(all terms)

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(
    cfg: ArchConfig,
    case: ShapeCase,
    chips: int,
    collective_bytes_per_device: float,
    *,
    peaks: tuple[float, float, float] = (PEAK_FLOPS, HBM_BW, ICI_BW),
) -> RooflineTerms:
    """The three terms at ``peaks`` = (FLOP/s, HBM bytes/s, collective
    bytes/s), by default one H100 SXM's (module docstring)."""
    peak_flops, hbm_bw, ici_bw = peaks
    cost = analytic_cost(cfg, case)
    compute_s = cost.flops / (chips * peak_flops)
    memory_s = cost.hbm_bytes / (chips * hbm_bw)
    collective_s = collective_bytes_per_device / ici_bw
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    frac = compute_s / bound if bound > 0 else 0.0
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        useful_ratio=cost.useful_ratio(),
        roofline_fraction=frac,
    )


def _kind(op_name: str) -> str | None:
    """The reference's kind of a ``_c10d_functional`` op (a broadcast
    sends one rank's buffer to the rest, as a permute does), or None for
    the waits."""
    for prefix, kind in (("all_gather", "all-gather"),
                         ("all_reduce", "all-reduce"),
                         ("reduce_scatter", "reduce-scatter"),
                         ("all_to_all", "all-to-all"),
                         ("shard_dim_alltoall", "all-to-all"),
                         ("broadcast", "collective-permute"),
                         ("permute", "collective-permute")):
        if op_name.startswith(prefix):
            return kind
    return None


def _nbytes(out) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_flatten(out)[0]
                     if isinstance(t, torch.Tensor)))


class CollectiveCounter(TorchDispatchMode):
    """Per-device collective bytes of whatever runs inside, by kind.

    Every ``torch.ops._c10d_functional`` collective and DTensor's own
    ``_dtensor.shard_dim_alltoall`` (what DTensor's redistributions
    issue) is counted once as it runs, at its result
    shape's bytes (an all-gather's full gathered size, an all-reduce's
    tensor once), as the reference counts an HLO op's result shape; a
    loop's collectives are counted on every trip. A call on DTensors is
    handed to DTensor (``NotImplemented``) with this mode still on the
    stack, so the collectives its redistributions issue are seen too.
    ``totals()`` gives the
    five kinds, ``count`` and ``total``; `breakdown` the largest
    contributors by (kind, result shape)."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0.0 for k in COLLECTIVES}
        self.count = 0
        self._items = defaultdict(lambda: [0, 0.0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if is_dtensor_call(args, kwargs):
            return NotImplemented  # DTensor splits it; its collectives come back
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _kind(func._opname)
            if kind is not None:
                nb = _nbytes(out)
                self.bytes[kind] += nb
                self.count += 1
                shapes = [tuple(t.shape) for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor)]
                dtype = next((str(t.dtype).removeprefix("torch.")
                              for t in tree_flatten(out)[0]
                              if isinstance(t, torch.Tensor)), "?")
                item = self._items[(kind, f"{dtype}{shapes}")]
                item[0] += 1
                item[1] += nb
        return out

    def totals(self) -> dict:
        out = dict(self.bytes)
        out["count"] = self.count
        out["total"] = sum(self.bytes.values())
        return out

    def breakdown(self, top: int = 12) -> list[dict]:
        """Top contributors: kind, result shape, times issued, bytes."""
        items = [{"kind": k, "shape": shape[:60], "trips": n, "bytes": b}
                 for (k, shape), (n, b) in self._items.items()]
        items.sort(key=lambda d: -d["bytes"])
        return items[:top]


def is_dtensor_call(args, kwargs) -> bool:
    """Whether any argument is a DTensor: a call a dispatch mode sees
    before DTensor splits it into this rank's calls on local tensors."""
    return any(isinstance(t, DTensor) for t in tree_flatten((args, kwargs))[0])
