"""Task and workload model (paper §3.3).

A *workload* is an ordered sequence of DNN layers (the paper assumes each
task is, or can be topologically sorted into, a layer chain). A *task*
``tau_i = (workload, p_i, d_i)`` releases a job every ``p_i`` seconds
(or with minimum inter-arrival ``p_i`` when sporadic); we use the
implicit-deadline model ``d_i = p_i`` throughout, matching the paper.

Layers are described by their dominant matmul shape ``(M, K, N)`` plus
byte traffic so the TPU exec model (core/perfmodel) can price them on an
arbitrary stage. A `SegmentTable` holds the per-(task, stage) WCETs
``e_i^k`` produced by a concrete design point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence


@dataclass(frozen=True)
class LayerDesc:
    """One layer of a workload, reduced to its dominant GEMM.

    ``M`` rows are "token-like" (batch x spatial), ``K`` the contraction
    dim, ``N`` the output features. ``flops``/``bytes`` default to the
    dense GEMM cost but may be overridden for non-GEMM layers (e.g. an
    SSM scan) whose cost was derived elsewhere.

    ``kind`` is advisory metadata ("mlp", "attn_qk", "moe", "scan", ...)
    used by reports; the exec model prices all kinds via flops/bytes.
    """

    name: str
    M: int
    K: int
    N: int
    kind: str = "mlp"
    flops: float = 0.0  # 0 -> derive as 2*M*K*N
    bytes_rw: float = 0.0  # 0 -> derive as dtype_bytes*(MK + KN + MN)
    dtype_bytes: int = 2

    def gemm_flops(self) -> float:
        return self.flops if self.flops > 0 else 2.0 * self.M * self.K * self.N

    def gemm_bytes(self) -> float:
        if self.bytes_rw > 0:
            return self.bytes_rw
        return float(self.dtype_bytes) * (
            self.M * self.K + self.K * self.N + self.M * self.N
        )


@dataclass(frozen=True)
class Workload:
    """A named ordered layer chain (one DNN truncation in the paper)."""

    name: str
    layers: tuple[LayerDesc, ...]

    def __post_init__(self) -> None:
        if not self.layers:
            raise ValueError(f"workload {self.name!r} has no layers")

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def total_flops(self) -> float:
        return sum(l.gemm_flops() for l in self.layers)

    def total_bytes(self) -> float:
        return sum(l.gemm_bytes() for l in self.layers)


@dataclass(frozen=True)
class Task:
    """Periodic/sporadic task ``tau_i = (e_i, p_i, d_i)`` over a workload.

    WCETs ``e_i^k`` are design-dependent; they live in `SegmentTable`,
    not here. Implicit deadline: ``d_i = p_i`` unless overridden.
    """

    workload: Workload
    period: float
    deadline: float = 0.0  # 0 -> implicit (= period)
    sporadic: bool = False
    name: str = ""

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError("period must be positive")
        if self.deadline == 0.0:
            object.__setattr__(self, "deadline", self.period)
        if not self.name:
            object.__setattr__(self, "name", self.workload.name)

    @property
    def num_layers(self) -> int:
        return self.workload.num_layers


@dataclass(frozen=True)
class TaskSet:
    """The task set ``tau`` executed on the PHAROS pipeline."""

    tasks: tuple[Task, ...]

    def __post_init__(self) -> None:
        if not self.tasks:
            raise ValueError("empty task set")

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)

    def hyperperiod(self) -> float:
        """LCM of periods (rationalised to microsecond grid)."""
        grid = 1e-6
        ints = [max(1, round(t.period / grid)) for t in self.tasks]
        lcm = ints[0]
        for v in ints[1:]:
            lcm = lcm * v // math.gcd(lcm, v)
        return lcm * grid


@dataclass
class SegmentTable:
    """Per-(task, stage) execution model of one concrete design.

    ``base[i][k]`` is ``b_i^k`` — the pure execution length of task i's
    segment on accelerator (stage) k, *excluding* preemption overhead
    (Eq. 4). ``overhead[k]`` is the per-stage preemption overhead
    ``xi^k = e_tile^k + e_store^k + e_load^k`` (Eq. 5) — a property of
    the stage's microarchitecture, not of the task. Stages a task skips
    have ``b_i^k == 0`` and contribute zero WCET (paper §3.4).
    """

    base: list[list[float]]  # [n_tasks][n_stages]
    overhead: list[float]  # [n_stages]
    layer_split: list[list[int]] = field(default_factory=list)
    # layer_split[i][k] = number of consecutive layers of task i on stage k

    @property
    def n_tasks(self) -> int:
        return len(self.base)

    @property
    def n_stages(self) -> int:
        return len(self.overhead)

    def wcet(self, i: int, k: int, preemptive: bool) -> float:
        """``e_i^k`` per Eq. 4: ``b + xi`` under EDF, ``b`` under FIFO.

        When the stage is skipped (``b == 0``) WCET is 0 regardless
        (paper: "when this accelerator is skipped, e_i^k is also 0").
        """
        b = self.base[i][k]
        if b <= 0.0:
            return 0.0
        return b + (self.overhead[k] if preemptive else 0.0)

    def wcets(self, preemptive: bool) -> list[list[float]]:
        return [
            [self.wcet(i, k, preemptive) for k in range(self.n_stages)]
            for i in range(self.n_tasks)
        ]

    def active_stages(self, i: int) -> list[int]:
        return [k for k in range(self.n_stages) if self.base[i][k] > 0.0]


def chain_wcets(table: SegmentTable, i: int, preemptive: bool) -> float:
    """Total WCET of task i across its pipeline chain."""
    return sum(table.wcet(i, k, preemptive) for k in range(table.n_stages))


def make_uniform_taskset(
    workloads: Sequence[Workload], periods: Sequence[float]
) -> TaskSet:
    if len(workloads) != len(periods):
        raise ValueError("workloads/periods length mismatch")
    return TaskSet(
        tasks=tuple(Task(workload=w, period=p) for w, p in zip(workloads, periods))
    )
