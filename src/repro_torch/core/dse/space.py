"""PHAROS design space (paper §4.1).

A design point partitions the platform's chips into ``M`` pipelined
accelerators and maps each task's layers onto them *consecutively* (the
pipelined-topology constraint): ``splits[k][i]`` = number of consecutive
layers of task i on accelerator k, with ``sum_k splits[k][i] == L_i``.

Evaluation produces the `SegmentTable` the serving runtime's cost model
is checked against. The search that picks a design is not part of this
package yet; a design comes from the caller.
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
