"""Vectorized ``create_acc`` — the DSE's batched inner evaluator.

`repro_torch.core.dse.create_acc.create_acc` prices ONE candidate accelerator
(a per-task span assignment plus a chip budget) by sweeping the valid
block shapes and picking the utilization-minimizing one. The beam
search calls it once per child, twice per retained child — hundreds of
thousands of times on the brute-force problems — and every call pays
Python interpreter overhead for ~10 blocks x n tasks of float work.

`BatchedDesignEvaluator.evaluate` does the same computation for an
**array of candidates** in a handful of numpy operations: per distinct
chip budget it materializes a ``[n_blocks, n_tasks, L+1]`` prefix-sum
tensor (copied row-for-row from the scalar `LatencyCache`, so every
latency is the *same float* the scalar path sees), gathers segment
latencies for the whole batch with fancy indexing, and reduces to the
best block per candidate with the scalar code's exact first-wins
strict-``<`` tie-breaking.

Bit-compatibility contract (asserted by the property suite): for every
candidate, ``evaluate`` returns the same utilization, the same chosen
block, and the same per-task latencies as `create_acc` — including the
degenerate cases (empty assignment -> trivial design, ``chips <= 0``
with work -> ``inf``). The task-order utilization accumulation runs as
an explicit loop (float addition is not associative); only the
candidate axis is vectorized.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dse.create_acc import _VALID_BLOCKS, LatencyCache
from repro_torch.core.perfmodel.exec_model import AccDesign, layer_latency
from repro_torch.core.rt.task import TaskSet, Workload

#: sentinel block indices for the degenerate `create_acc` branches
TRIVIAL_BLOCK = -2  # empty assignment: AccDesign(chips=max(chips, 1))
NO_CHIP_BLOCK = -1  # chips <= 0 with work: AccDesign(chips=1), util inf


def resolve_acc(chips: int, block_idx: int) -> AccDesign:
    """The `AccDesign` the scalar `create_acc` would have returned."""
    if block_idx == TRIVIAL_BLOCK:
        return AccDesign(chips=max(chips, 1))
    if block_idx == NO_CHIP_BLOCK:
        return AccDesign(chips=1)
    return AccDesign(chips=chips, block=_VALID_BLOCKS[block_idx])


class BatchedDesignEvaluator:
    """Evaluate arrays of (spans, chips) accelerator candidates at once.

    Shares (or owns) a scalar `LatencyCache`; prefix tensors are built
    lazily per chip count and cached for the life of the evaluator, so
    a beam search touches each (chips, block, workload) latency row
    exactly once no matter how many candidates reference it.
    """

    def __init__(
        self,
        workloads: list[Workload],
        taskset: TaskSet,
        *,
        cache: LatencyCache | None = None,
    ):
        if len(workloads) != len(taskset):
            raise ValueError("workloads/taskset mismatch")
        self.workloads = workloads
        self.taskset = taskset
        self.cache = cache or LatencyCache(workloads)
        # same per-call constant the scalar create_acc derives
        self.inv_periods = [1.0 / t.period for t in taskset.tasks]
        self._max_layers = max(w.num_layers for w in workloads)
        self._tensors: dict[int, np.ndarray] = {}
        self._segsums: dict[tuple[int, tuple[int, int, int]], np.ndarray] = {}

    @property
    def n_tasks(self) -> int:
        return len(self.workloads)

    def prefix_tensor(self, chips: int) -> np.ndarray:
        """``[n_blocks, n_tasks, L_max + 1]`` prefix-sum latencies for
        one chip budget (rows shorter than ``L_max`` pad with their
        final value; spans never index past a workload's own length)."""
        P = self._tensors.get(chips)
        if P is None:
            P = np.empty(
                (len(_VALID_BLOCKS), self.n_tasks, self._max_layers + 1)
            )
            for bi, block in enumerate(_VALID_BLOCKS):
                for i in range(self.n_tasks):
                    pre = self.cache.prefix(i, chips, block)
                    P[bi, i, : len(pre)] = pre
                    P[bi, i, len(pre) :] = pre[-1]
            self._tensors[chips] = P
        return P

    def segment_sums(
        self, chips: int, block: tuple[int, int, int]
    ) -> np.ndarray:
        """``[n_tasks, L+1, L+1]`` table of exact `segment_latency`
        values: entry ``[i, a, b]`` is the latency of task i's layers
        ``[a, b)`` on an ``AccDesign(chips, block)`` stage, accumulated
        from zero in layer order — the *same float* the scalar
        `evaluate_design` computes (which is NOT the prefix-sum
        difference `evaluate` uses; `create_acc` and `evaluate_design`
        have always disagreed in the last ulp, and the batched paths
        reproduce each one exactly)."""
        key = (chips, block)
        T = self._segsums.get(key)
        if T is None:
            T = np.zeros(
                (self.n_tasks, self._max_layers + 1, self._max_layers + 1)
            )
            acc = AccDesign(chips=chips, block=block)
            for i, w in enumerate(self.workloads):
                lats = [layer_latency(l, acc) for l in w.layers]
                for a in range(len(lats) + 1):
                    s = 0.0
                    for b in range(a + 1, len(lats) + 1):
                        s = s + lats[b - 1]
                        T[i, a, b] = s
            self._segsums[key] = T
        return T

    def design_max_utils(self, designs) -> np.ndarray:
        """Batched `design_from_splits` objective: ``max_k u^k``
        (``preemptive=False``) for a list of complete designs, each a
        ``(accs, splits)`` pair. Bit-identical to `evaluate_design` +
        `max_utilization` on every design."""
        return self.design_metrics(designs)[0]

    def design_metrics(self, designs) -> tuple[np.ndarray, np.ndarray]:
        """Both per-design objective metrics in one pass:
        ``(max_utils, total_latencies)``. ``total_latencies[c]`` is the
        summed chain latency ``sum_i sum_k b_i^k`` — the `TotalLatency`
        objective — accumulated in the scalar score's order (stages
        within a task, then tasks)."""
        C = len(designs)
        n = self.n_tasks
        if C == 0:
            return np.empty(0), np.empty(0)
        K_max = max(len(accs) for accs, _splits in designs)
        base = np.zeros((C, n, K_max))
        # group (candidate, stage) entries by stage microarchitecture so
        # each (chips, block) segment table is gathered once; span
        # bounds go into flat buffers (list-of-list asarray is slow)
        groups: dict[
            tuple[int, tuple[int, int, int]],
            tuple[list[int], list[int], list[int], list[int]],
        ] = {}
        for c, (accs, splits) in enumerate(designs):
            pos = [0] * n
            for k, acc in enumerate(accs):
                g = groups.setdefault(
                    (acc.chips, acc.block), ([], [], [], [])
                )
                g[0].append(c)
                g[1].append(k)
                g[2].extend(pos)
                row = splits[k]
                for i in range(n):
                    pos[i] += row[i]
                g[3].extend(pos)
        ar = np.arange(n)
        # insertion order is pinned by the candidate list; results
        # scatter back by index, order-free
        for (chips, block), (cs, ks, flat_lo, flat_hi) in groups.items():
            T = self.segment_sums(chips, block)
            a = np.array(flat_lo, dtype=np.int64).reshape(len(cs), n)
            b = np.array(flat_hi, dtype=np.int64).reshape(len(cs), n)
            base[np.array(cs), :, np.array(ks)] = T[ar[None, :], a, b]
        util = np.zeros((C, K_max))
        total = np.zeros(C)
        for i, t in enumerate(self.taskset.tasks):  # task-order, like Eq. 2
            row = base[:, i, :]
            util += row / t.period
            # stage-order accumulation matches the scalar per-task
            # left-to-right sum (padded stages add exact 0.0)
            row_sum = np.zeros(C)
            for k in range(K_max):
                row_sum += row[:, k]
            total += row_sum
        # stages past a design's own count contribute util 0.0, which
        # cannot win the max (every real design has a positive stage)
        return util.max(axis=1), total

    def evaluate(
        self, spans: np.ndarray, chips: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched `create_acc`.

        ``spans`` is ``[C, n_tasks, 2]`` (half-open layer ranges),
        ``chips`` ``[C]``. Returns ``(util [C], block_idx [C],
        lats [C, n_tasks])`` where ``block_idx`` indexes
        ``_VALID_BLOCKS`` (or a sentinel for the degenerate branches);
        `resolve_acc` turns it back into the scalar `AccDesign`.
        """
        spans = np.asarray(spans, dtype=np.int64)
        chips = np.asarray(chips, dtype=np.int64)
        if spans.ndim != 3 or spans.shape[1] != self.n_tasks:
            raise ValueError(
                f"spans must be [C, {self.n_tasks}, 2], got {spans.shape}"
            )
        C, n = spans.shape[0], self.n_tasks
        util = np.empty(C)
        block_idx = np.empty(C, dtype=np.int64)
        lats = np.zeros((C, n))

        seg_layers = spans[:, :, 1] - spans[:, :, 0]
        empty = seg_layers.sum(axis=1) == 0
        nochip = ~empty & (chips <= 0)
        util[empty] = 0.0
        block_idx[empty] = TRIVIAL_BLOCK
        util[nochip] = np.inf
        block_idx[nochip] = NO_CHIP_BLOCK
        lats[nochip] = np.where(seg_layers[nochip] > 0, np.inf, 0.0)

        normal = ~empty & (chips > 0)
        ar = np.arange(n)
        for c in np.unique(chips[normal]):
            m = normal & (chips == c)
            P = self.prefix_tensor(int(c))
            a = spans[m, :, 0]
            b = spans[m, :, 1]
            # lat[bi, mi, i] = P[bi, i, b[mi, i]] - P[bi, i, a[mi, i]]
            lat = P[:, ar[None, :], b] - P[:, ar[None, :], a]
            u = np.zeros(lat.shape[:2])
            for i in range(n):  # task-order accumulation (see module doc)
                u += lat[:, :, i] * self.inv_periods[i]
            best_u = np.full(lat.shape[1], np.inf)
            best_b = np.zeros(lat.shape[1], dtype=np.int64)
            for bi in range(len(_VALID_BLOCKS)):  # first-wins strict <
                better = u[bi] < best_u
                best_u[better] = u[bi][better]
                best_b[better] = bi
            util[m] = best_u
            block_idx[m] = best_b
            lats[m] = lat[best_b, np.arange(lat.shape[1]), :]
        return util, block_idx, lats
