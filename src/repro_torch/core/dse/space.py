"""PHAROS design space (paper §4.1).

A design point partitions the platform's chips into ``M`` pipelined
accelerators and maps each task's layers onto them *consecutively* (the
pipelined-topology constraint): ``splits[k][i]`` = number of consecutive
layers of task i on accelerator k, with ``sum_k splits[k][i] == L_i``.

Evaluation produces the `SegmentTable` consumed by the RT core and the
DES, so schedulability tests / response bounds / simulation all see the
same WCETs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.perfmodel.exec_model import (
    AccDesign,
    preemption_overheads,
    segment_latency,
)
from repro_torch.core.rt.task import SegmentTable, TaskSet, Workload


@dataclass(frozen=True)
class DesignPoint:
    """A complete PHAROS system design."""

    accs: tuple[AccDesign, ...]
    splits: tuple[tuple[int, ...], ...]  # [n_stages][n_tasks]
    max_util: float  # objective value (preemptive=False, Eq. 2)

    @property
    def n_stages(self) -> int:
        return len(self.accs)

    def chips_used(self) -> int:
        return sum(a.chips for a in self.accs)


def task_segments(
    workload: Workload, counts_per_stage: list[int]
) -> list[tuple]:
    """Slice a workload's layer chain by per-stage counts."""
    out, pos = [], 0
    for c in counts_per_stage:
        out.append(tuple(workload.layers[pos : pos + c]))
        pos += c
    if pos != workload.num_layers:
        raise ValueError("split does not cover all layers")
    return out


def evaluate_design(
    accs: tuple[AccDesign, ...],
    splits: tuple[tuple[int, ...], ...],
    workloads: list[Workload],
    taskset: TaskSet,
) -> SegmentTable:
    """Build the SegmentTable (b_i^k matrix + xi^k vector) of a design."""
    n_stages, n_tasks = len(accs), len(workloads)
    base = [[0.0] * n_stages for _ in range(n_tasks)]
    layer_split = [[0] * n_stages for _ in range(n_tasks)]
    for i, w in enumerate(workloads):
        counts = [splits[k][i] for k in range(n_stages)]
        segs = task_segments(w, counts)
        for k, seg in enumerate(segs):
            layer_split[i][k] = len(seg)
            if seg:
                base[i][k] = segment_latency(seg, accs[k])
    overhead = [sum(preemption_overheads(a)) for a in accs]
    return SegmentTable(base=base, overhead=overhead, layer_split=layer_split)


def design_from_splits(
    accs: tuple[AccDesign, ...],
    splits: tuple[tuple[int, ...], ...],
    workloads: list[Workload],
    taskset: TaskSet,
) -> DesignPoint:
    from repro_torch.core.rt.schedulability import max_utilization

    table = evaluate_design(accs, splits, workloads, taskset)
    return DesignPoint(
        accs=accs,
        splits=splits,
        max_util=max_utilization(table, taskset, preemptive=False),
    )


def fixed_design(
    workloads: list[Workload], taskset: TaskSet, platform
) -> DesignPoint:
    """Paper Fig. 1 baseline: one accelerator with all resources."""
    from repro_torch.core.dse.create_acc import LatencyCache, create_acc

    cache = LatencyCache(workloads)
    spans = tuple((0, w.num_layers) for w in workloads)
    acc, _util, _lat = create_acc(spans, platform.total_chips, taskset, cache)
    splits = (tuple(w.num_layers for w in workloads),)
    return design_from_splits((acc,), splits, workloads, taskset)
