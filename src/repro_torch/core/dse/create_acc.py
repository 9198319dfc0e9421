"""``create_acc`` — inner microarchitecture search (paper Alg. 1, line 9).

Given per-task *spans* of consecutive layers assigned to one accelerator
and its chip budget, brute-force the block-shape candidates (the TPU
analogue of the paper's fixed A..Z sweep; constant complexity per call)
and return the configuration minimizing this accelerator's utilization
``sum_i lat_i / p_i``.

Performance: the beam search calls this O(B * R * prod L_i) times, so
segment latency is served from per-(workload, chips, block) *prefix-sum
caches* — latency of ``layers[a:b]`` is ``prefix[b] - prefix[a]`` — and
each cache line is built once lazily.
"""
from __future__ import annotations

from repro_torch.core.perfmodel.exec_model import (
    AccDesign,
    BLOCK_CANDIDATES,
    layer_latency,
    vmem_bytes_for_block,
)
from repro_torch.core.perfmodel.hardware import TPU_V5E
from repro_torch.core.rt.task import TaskSet, Workload

Span = tuple[int, int]  # half-open [start, end) layer range


class LatencyCache:
    """Prefix-sum latency tables keyed by (workload, chips, block)."""

    def __init__(self, workloads: list[Workload]):
        self.workloads = workloads
        self._prefix: dict[tuple[int, int, tuple[int, int, int]], list[float]] = {}

    def prefix(
        self, task_i: int, chips: int, block: tuple[int, int, int]
    ) -> list[float]:
        """The full prefix-sum row for (workload, chips, block) — the
        accumulation the batched evaluator copies verbatim so its
        latencies are bit-identical to the scalar path."""
        key = (task_i, chips, block)
        pre = self._prefix.get(key)
        if pre is None:
            acc = AccDesign(chips=chips, block=block)
            pre = [0.0]
            for layer in self.workloads[task_i].layers:
                pre.append(pre[-1] + layer_latency(layer, acc))
            self._prefix[key] = pre
        return pre

    def segment(
        self, task_i: int, span: Span, chips: int, block: tuple[int, int, int]
    ) -> float:
        a, b = span
        if a == b:
            return 0.0
        pre = self.prefix(task_i, chips, block)
        return pre[b] - pre[a]


_VALID_BLOCKS = tuple(
    b for b in BLOCK_CANDIDATES if vmem_bytes_for_block(b) <= TPU_V5E.vmem_bytes
)


def create_acc(
    spans: tuple[Span, ...],
    chips: int,
    taskset: TaskSet,
    cache: LatencyCache,
) -> tuple[AccDesign, float, tuple[float, ...]]:
    """Best (acc, utilization, per-task latencies) for this assignment.

    Empty assignment -> trivial design, utilization 0. ``chips <= 0``
    with non-empty work -> utilization ``inf`` (the paper's synthetic
    remain_acc with no resources can never pass the u <= 1 gate).
    """
    total_layers = sum(b - a for a, b in spans)
    if total_layers == 0:
        return AccDesign(chips=max(chips, 1)), 0.0, tuple(0.0 for _ in spans)
    if chips <= 0:
        return (
            AccDesign(chips=1),
            float("inf"),
            tuple(float("inf") if b > a else 0.0 for a, b in spans),
        )

    inv_periods = [1.0 / t.period for t in taskset.tasks]
    best_util = float("inf")
    best_block = _VALID_BLOCKS[0]
    best_lats: tuple[float, ...] = ()
    for block in _VALID_BLOCKS:
        util = 0.0
        lats = []
        for i, span in enumerate(spans):
            lat = cache.segment(i, span, chips, block)
            lats.append(lat)
            util += lat * inv_periods[i]
        if util < best_util:
            best_util, best_block, best_lats = util, block, tuple(lats)
    return AccDesign(chips=chips, block=best_block), best_util, best_lats
