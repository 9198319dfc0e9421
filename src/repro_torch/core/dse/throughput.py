"""Throughput-guided (TG) DSE baseline — CHARM-style (paper §5.2).

CHARM composes heterogeneous accelerators by *GEMM-shape affinity*: it
clusters the workload's layers into M groups of similar shape, dedicates
one accelerator per group (sized by the group's FLOP share), and
optimizes each accelerator's microarchitecture for its group's
throughput. Task periods never enter the objective.

Because clustering ignores layer order, a task's layers generally visit
accelerators in non-monotone order — the *backtracking* the paper calls
out as incompatible with the guideline theory. TG designs therefore
cannot use Eq. 3 and are judged by simulation (paper: >100x period DES),
under three schedulings: FIFO w/o polling, FIFO w/ polling, EDF.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.dse.create_acc import LatencyCache
from repro_torch.core.perfmodel.exec_model import (
    AccDesign,
    BLOCK_CANDIDATES,
    layer_latency,
    preemption_overheads,
    vmem_bytes_for_block,
)
from repro_torch.core.perfmodel.hardware import TPU_V5E, Platform
from repro_torch.core.rt.task import LayerDesc, SegmentTable, TaskSet, Workload


@dataclass(frozen=True)
class TGDesign:
    """A CHARM-style multi-accelerator design with per-layer mapping."""

    accs: tuple[AccDesign, ...]
    #: per task: ordered (stage, wcet) segment list, consecutive layers
    #: on the same stage collapsed; may revisit stages (backtracking)
    sequences: tuple[tuple[tuple[int, float], ...], ...]
    #: aggregated per-(task, stage) WCET table (for utilization reports)
    table: SegmentTable
    max_util: float


def _feat(layer: LayerDesc) -> tuple[float, float, float]:
    return (
        math.log2(max(layer.M, 1)),
        math.log2(max(layer.K, 1)),
        math.log2(max(layer.N, 1)),
    )


def _kmeans(feats: list[tuple[float, float, float]], k: int, iters: int = 25):
    """Deterministic k-means (quantile init over FLOP-sorted points)."""
    n = len(feats)
    k = min(k, n)
    order = sorted(range(n), key=lambda i: feats[i])
    centroids = [feats[order[(2 * j + 1) * n // (2 * k)]] for j in range(k)]
    assign = [0] * n
    for _ in range(iters):
        changed = False
        for i, f in enumerate(feats):
            best = min(
                range(k),
                key=lambda c: sum((f[d] - centroids[c][d]) ** 2 for d in range(3)),
            )
            if best != assign[i]:
                assign[i] = best
                changed = True
        for c in range(k):
            members = [feats[i] for i in range(n) if assign[i] == c]
            if members:
                centroids[c] = tuple(
                    sum(m[d] for m in members) / len(members) for d in range(3)
                )
        if not changed:
            break
    return assign


def throughput_guided_design(
    workloads: list[Workload],
    taskset: TaskSet,
    platform: Platform,
    n_accs: int = 4,
) -> TGDesign:
    """Build the TG design: shape clusters -> accelerators -> mapping."""
    layers: list[LayerDesc] = []
    owner: list[tuple[int, int]] = []  # (task, layer index)
    for ti, w in enumerate(workloads):
        for li, layer in enumerate(w.layers):
            layers.append(layer)
            owner.append((ti, li))

    assign = _kmeans([_feat(l) for l in layers], n_accs)
    used = sorted(set(assign))
    remap = {c: i for i, c in enumerate(used)}
    assign = [remap[a] for a in assign]
    k = len(used)

    # chips proportional to FLOP share (largest remainder, >= 1 each)
    flops = [0.0] * k
    for a, l in zip(assign, layers):
        flops[a] += l.gemm_flops()
    total = sum(flops) or 1.0
    raw = [f / total * platform.total_chips for f in flops]
    chips = [max(1, int(r)) for r in raw]
    while sum(chips) > platform.total_chips:
        j = max(range(k), key=lambda i: chips[i])
        chips[j] -= 1
    rema = sorted(range(k), key=lambda i: raw[i] - int(raw[i]), reverse=True)
    ri = 0
    while sum(chips) < platform.total_chips:
        chips[rema[ri % k]] += 1
        ri += 1

    # per-cluster block: throughput objective (min total latency)
    accs = []
    for c in range(k):
        mine = [l for a, l in zip(assign, layers) if a == c]
        best, best_t = None, float("inf")
        for block in BLOCK_CANDIDATES:
            if vmem_bytes_for_block(block) > TPU_V5E.vmem_bytes:
                continue
            acc = AccDesign(chips=chips[c], block=block)
            t = sum(layer_latency(l, acc) for l in mine)
            if t < best_t:
                best, best_t = acc, t
        accs.append(best)
    accs = tuple(accs)

    # per-task (stage, wcet) sequences with consecutive collapse
    sequences = []
    n_tasks = len(workloads)
    base = [[0.0] * k for _ in range(n_tasks)]
    split = [[0] * k for _ in range(n_tasks)]
    pos = 0
    for ti, w in enumerate(workloads):
        seq: list[list] = []
        for li, layer in enumerate(w.layers):
            c = assign[pos]
            lat = layer_latency(layer, accs[c])
            base[ti][c] += lat
            split[ti][c] += 1
            if seq and seq[-1][0] == c:
                seq[-1][1] += lat
            else:
                seq.append([c, lat])
            pos += 1
        sequences.append(tuple((s, t) for s, t in seq))

    overhead = [sum(preemption_overheads(a)) for a in accs]
    table = SegmentTable(base=base, overhead=overhead, layer_split=split)
    from repro_torch.core.rt.schedulability import max_utilization

    return TGDesign(
        accs=accs,
        sequences=tuple(sequences),
        table=table,
        max_util=max_utilization(table, taskset, preemptive=False),
    )


def tg_simtasks(design: TGDesign, taskset: TaskSet):
    """SimTask list for the DES (preserves backtracking order)."""
    from repro_torch.scheduler.des import SimTask

    return [
        SimTask(segments=design.sequences[i], period=t.period, name=t.name)
        for i, t in enumerate(taskset.tasks)
    ]
