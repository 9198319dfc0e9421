"""PHAROS beam search (paper Algorithm 1, §4.2).

Iteratively creates accelerators: each parent carries the layers/chips
already committed; extending it assigns a new accelerator some chips and
a consecutive slice of every task's remaining layers. The unassigned
remainder forms a synthetic ``remain_acc`` whose utilization (a) guides
child ranking and (b), when it drops to <= 1, turns the remainder into a
real accelerator and yields a *feasible* complete design (lines 13-14).
Children whose new accelerator already exceeds utilization 1 are pruned
(line 11); children whose remainder exceeds 1 are retained for further
partitioning (line 12). Top-``B`` children by max-utilization survive
each iteration.

``beam_width=None`` gives the brute-force BFS baseline (B = +inf,
paper §5.4) used by the JAX package's `repro.core.dse.brute`.

Evaluation is **batched**: each iteration enumerates every child of
every parent, then prices all the new accelerators in one
`BatchedDesignEvaluator.evaluate` call and all surviving remainders in
a second (``evaluator="scalar"`` keeps the per-child `create_acc` loop
for differential tests and the `benchmarks/dse_bench.py` baseline).
Both paths are bit-identical — the batched evaluator reproduces the
scalar floats exactly — so the search visits the same nodes, keeps the
same frontier and returns the same winner either way. Pruning,
feasibility and ranking are delegated to the `repro_torch.core.dse.objective`
layer; the defaults reproduce the paper's SRT-guided search.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dse.batch_eval import BatchedDesignEvaluator
from repro_torch.core.dse.create_acc import (
    _VALID_BLOCKS,
    LatencyCache,
    create_acc,
)
from repro_torch.core.dse.objective import Constraint, Eq3Constraint, MinMaxUtil, Objective
from repro_torch.core.dse.space import DesignPoint, evaluate_design
from repro_torch.core.perfmodel.exec_model import AccDesign
from repro_torch.core.perfmodel.hardware import Platform
from repro_torch.core.rt.task import TaskSet, Workload

_EVALUATORS = ("batched", "scalar")


@dataclass
class BeamStats:
    create_acc_calls: int = 0
    children_generated: int = 0
    parents_expanded: int = 0
    wall_time_s: float = 0.0
    first_feasible_time_s: float | None = None
    feasible_found: int = 0
    #: wall seconds spent inside the candidate evaluator (batched or
    #: scalar) — the denominator of `candidates_per_sec`
    eval_seconds: float = 0.0
    evaluator: str = "batched"

    @property
    def candidates_evaluated(self) -> int:
        """Accelerator candidates priced (alias of `create_acc_calls`:
        the batched evaluator performs the same per-candidate work in
        bulk)."""
        return self.create_acc_calls

    @property
    def candidates_per_sec(self) -> float:
        """Evaluated-candidates/sec throughput of the evaluator core."""
        if self.eval_seconds <= 0.0:
            return 0.0
        return self.create_acc_calls / self.eval_seconds


@dataclass
class BeamResult:
    succ_pts: list[DesignPoint]
    best: DesignPoint | None
    stats: BeamStats = field(default_factory=BeamStats)


@dataclass(frozen=True)
class _Node:
    assigned: tuple[int, ...]  # layers committed per task (paper's l)
    chips_used: int  # paper's r
    accs: tuple[AccDesign, ...]
    splits: tuple[tuple[int, ...], ...]  # per stage: layer counts per task
    created_max_util: float  # max util among committed accelerators
    guide: float  # ranking key: objective.guide(created, remain)


class _ScalarEvaluator:
    """Per-candidate `create_acc` loop with the batched call signature —
    the pre-refactor inner loop, kept as the differential baseline."""

    def __init__(self, workloads, taskset, cache: LatencyCache):
        self.taskset = taskset
        self.cache = cache
        self._block_index = {b: i for i, b in enumerate(_VALID_BLOCKS)}

    def evaluate(self, spans, chips):
        C = len(chips)
        util = np.empty(C)
        block_idx = np.empty(C, dtype=np.int64)
        for j in range(C):
            acc, u, _lats = create_acc(
                tuple((int(a), int(b)) for a, b in spans[j]),
                int(chips[j]),
                self.taskset,
                self.cache,
            )
            util[j] = u
            block_idx[j] = self._block_index.get(acc.block, 0)
        return util, block_idx, None


def beam_search(
    workloads: list[Workload],
    taskset: TaskSet,
    platform: Platform,
    max_m: int = 4,
    beam_width: int | None = 8,
    max_frontier: int = 200_000,
    *,
    objective: Objective | None = None,
    constraint: Constraint | None = None,
    evaluator: str = "batched",
    split_stride: int = 1,
) -> BeamResult:
    """Algorithm 1. Returns every feasible design found plus the best.

    ``split_stride`` coarsens the split grid for long layer chains:
    slice boundaries are only allowed every ``split_stride`` layers
    from each parent's frontier (a task's full remainder is always
    takeable). ``1`` (default) is the paper's exact layer-granular
    space; an LM chain of hundreds of flattened layers needs a coarser
    grid to keep the child frontier tractable (`examples/dse_pipeline.py`).
    """
    if len(workloads) != len(taskset):
        raise ValueError("workloads/taskset mismatch")
    if split_stride < 1:
        raise ValueError("split_stride must be >= 1")
    if evaluator not in _EVALUATORS:
        raise ValueError(
            f"unknown evaluator {evaluator!r}; have {_EVALUATORS}"
        )
    objective = objective or MinMaxUtil()
    constraint = constraint or Eq3Constraint()
    # rtlint: disable=clock-domain -- the DSE's own search time
    t0 = time.perf_counter()
    n = len(workloads)
    L = tuple(w.num_layers for w in workloads)
    R = platform.total_chips
    cache = LatencyCache(workloads)
    ev = (
        BatchedDesignEvaluator(workloads, taskset, cache=cache)
        if evaluator == "batched"
        else _ScalarEvaluator(workloads, taskset, cache)
    )
    stats = BeamStats(evaluator=evaluator)
    succ: list[DesignPoint] = []
    best: DesignPoint | None = None

    def eval_batch(spans: np.ndarray, chips: np.ndarray):
        # rtlint: disable=clock-domain -- the DSE's own search time
        te = time.perf_counter()
        util, block_idx, _lats = ev.evaluate(spans, chips)
        # rtlint: disable=clock-domain -- the DSE's own search time
        stats.eval_seconds += time.perf_counter() - te
        stats.create_acc_calls += len(chips)
        return util, block_idx

    best_rank = float("inf")

    def accept(dp: DesignPoint, rank_val: float) -> None:
        """Feasibility gate + objective-ranked best tracking.
        ``rank_val`` is `Objective.rank` over the design's two batched
        metrics — max_util for the SRT objective, summed chain latency
        for the throughput objective."""
        nonlocal best, best_rank
        if not constraint.accepts(dp.max_util):
            return
        succ.append(dp)
        stats.feasible_found += 1
        if stats.first_feasible_time_s is None:
            # rtlint: disable=clock-domain -- the DSE's own search time
            stats.first_feasible_time_s = time.perf_counter() - t0
        if best is None or rank_val < best_rank:
            best = dp
            best_rank = rank_val

    # feasible completions are collected during the walk and scored in
    # one batched `design_metrics` call per iteration (bit-identical
    # to the scalar `evaluate_design` path, which the scalar evaluator
    # still runs inline as the differential baseline)
    pending_feasible: list[tuple[tuple[AccDesign, ...], tuple]] = []

    def note_feasible(
        accs: tuple[AccDesign, ...], splits: tuple[tuple[int, ...], ...]
    ) -> None:
        if evaluator == "batched":
            pending_feasible.append((accs, splits))
            return
        from repro_torch.core.rt.schedulability import max_utilization

        table = evaluate_design(accs, splits, workloads, taskset)
        mu = max_utilization(table, taskset, preemptive=False)
        total = sum(sum(row) for row in table.base)
        accept(
            DesignPoint(accs=accs, splits=splits, max_util=mu),
            objective.rank(mu, total),
        )

    def flush_feasible() -> None:
        if not pending_feasible:
            return
        # rtlint: disable=clock-domain -- the DSE's own search time
        te = time.perf_counter()
        mus, totals = ev.design_metrics(pending_feasible)
        # rtlint: disable=clock-domain -- the DSE's own search time
        stats.eval_seconds += time.perf_counter() - te
        for (accs, splits), mu, total in zip(pending_feasible, mus, totals):
            accept(
                DesignPoint(accs=accs, splits=splits, max_util=float(mu)),
                objective.rank(float(mu), float(total)),
            )
        pending_feasible.clear()

    # AccDesign is frozen; share one instance per (chips, block) so the
    # walk does not rebuild ~10^5 identical dataclasses on brute runs
    acc_cache: dict[tuple[int, int], AccDesign] = {}

    def make_acc(chips: int, block_idx: int) -> AccDesign:
        key = (chips, block_idx)
        acc = acc_cache.get(key)
        if acc is None:
            acc = AccDesign(chips=chips, block=_VALID_BLOCKS[block_idx])
            acc_cache[key] = acc
        return acc

    root = _Node(
        assigned=(0,) * n,
        chips_used=0,
        accs=(),
        splits=(),
        created_max_util=0.0,
        guide=float("inf"),
    )
    parents: list[_Node] = [root]

    L_arr = np.asarray(L, dtype=np.int64)

    for _m in range(2, max_m + 1):
        # -- enumerate every child of every parent as arrays (same
        # nested order as the scalar seed loop: parent, then chip
        # budget, then the per-task slice product — `np.meshgrid`
        # with ``indexing="ij"`` reshapes to exactly
        # `itertools.product`'s last-range-fastest order, and the
        # budget cross is budget-major, slices within). Building the
        # candidate set as array blocks instead of one Python tuple
        # per child is what keeps enumeration off the profile now
        # that evaluation itself is batched. ---------------------------
        blk_nvec: list[np.ndarray] = []  # [C_p, n] slice frontiers
        blk_chips: list[np.ndarray] = []  # [C_p] new-acc budgets
        blk_left_sum: list[np.ndarray] = []  # [C_p] remainder sizes
        blk_parent: list[np.ndarray] = []  # [C_p] parent index
        blk_spans: list[np.ndarray] = []  # [C_p, n, 2] eval spans
        for pi, parent in enumerate(parents):
            stats.parents_expanded += 1
            l, r = parent.assigned, parent.chips_used
            remaining = tuple(L[i] - l[i] for i in range(n))
            if sum(remaining) == 0:
                continue
            budget = R - r
            if budget < 1:
                continue  # no chips left: the seed's empty budget range
            # the consecutive-slice takes per task do not depend on the
            # chip budget — enumerate them once per parent, then cross
            # with every budget in the seed's (chips, nvec) order
            if split_stride == 1:
                ranges = [range(l[i], L[i] + 1) for i in range(n)]
            else:
                ranges = [
                    list(range(l[i], L[i] + 1, split_stride))
                    + ([L[i]] if (L[i] - l[i]) % split_stride else [])
                    for i in range(n)
                ]
            grids = np.meshgrid(
                *[np.asarray(rg, dtype=np.int64) for rg in ranges],
                indexing="ij",
            )
            nvec_grid = np.stack(
                [g.reshape(-1) for g in grids], axis=1
            )  # [S, n], product order
            l_row = np.asarray(l, dtype=np.int64)
            nvec_grid = nvec_grid[(nvec_grid - l_row).sum(axis=1) > 0]
            if not len(nvec_grid):
                continue
            left_sum_grid = (L_arr - nvec_grid).sum(axis=1)
            # budgets 1..budget-1 keep >= 1 chip for the remainder, so
            # every slice passes the seed's resource filter; at the
            # full budget (chips_left == 0) only complete slices
            # (left_sum == 0) survive it
            S = len(nvec_grid)
            parts_nvec, parts_chips, parts_ls = [], [], []
            if budget > 1:
                parts_nvec.append(np.tile(nvec_grid, (budget - 1, 1)))
                parts_chips.append(
                    np.repeat(np.arange(1, budget, dtype=np.int64), S)
                )
                parts_ls.append(np.tile(left_sum_grid, budget - 1))
            complete = np.flatnonzero(left_sum_grid == 0)
            if len(complete):
                parts_nvec.append(nvec_grid[complete])
                parts_chips.append(
                    np.full(len(complete), budget, dtype=np.int64)
                )
                parts_ls.append(np.zeros(len(complete), dtype=np.int64))
            if not parts_nvec:
                continue
            nvec_p = np.concatenate(parts_nvec, axis=0)
            spans_p = np.empty((len(nvec_p), n, 2), dtype=np.int64)
            spans_p[:, :, 0] = l_row
            spans_p[:, :, 1] = nvec_p
            blk_nvec.append(nvec_p)
            blk_chips.append(np.concatenate(parts_chips))
            blk_left_sum.append(np.concatenate(parts_ls))
            blk_parent.append(
                np.full(len(nvec_p), pi, dtype=np.int64)
            )
            blk_spans.append(spans_p)

        children: dict[tuple, _Node] = {}
        if blk_nvec:
            nvec_all = np.concatenate(blk_nvec, axis=0)
            chips_all = np.concatenate(blk_chips)
            left_sum_all = np.concatenate(blk_left_sum)
            parent_all = np.concatenate(blk_parent)
            spans_new = np.concatenate(blk_spans, axis=0)
            # chips_used is constant per parent block, so the leftover
            # budget is recoverable without a per-candidate walk
            used_by_parent = np.asarray(
                [p.chips_used for p in parents], dtype=np.int64
            )
            chips_left_all = R - used_by_parent[parent_all] - chips_all

            # -- batch 1: price every child's new accelerator ----------
            utils_new, blocks_new = eval_batch(spans_new, chips_all)
            surv = ~constraint.prunes_batch(utils_new)  # line 11: prune

            # -- batch 2: price the remainders of surviving children ---
            rem_of = np.full(len(chips_all), -1, dtype=np.int64)
            rem_sel = np.flatnonzero(surv & (left_sum_all > 0))
            if len(rem_sel):
                spans_rem = np.empty(
                    (len(rem_sel), n, 2), dtype=np.int64
                )
                spans_rem[:, :, 0] = nvec_all[rem_sel]
                spans_rem[:, :, 1] = L_arr
                chips_rem = chips_left_all[rem_sel]
                rem_of[rem_sel] = np.arange(len(rem_sel))
                utils_rem, blocks_rem = eval_batch(spans_rem, chips_rem)

            # -- walk the *surviving* candidates in enumeration order
            # (identical feasibility / dedup / frontier bookkeeping to
            # the seed — the pruned majority is never touched) ---------
            for j in np.flatnonzero(surv):
                parent = parents[int(parent_all[j])]
                chips_new = int(chips_all[j])
                chips_left = int(chips_left_all[j])
                nvec = tuple(int(x) for x in nvec_all[j])
                take = tuple(
                    v - a for v, a in zip(nvec, parent.assigned)
                )
                left = tuple(int(x) for x in L_arr - nvec_all[j])
                left_sum = int(left_sum_all[j])
                new_acc = make_acc(chips_new, int(blocks_new[j]))
                accs = parent.accs + (new_acc,)
                splits = parent.splits + (take,)
                cmax = max(parent.created_max_util, float(utils_new[j]))
                if left_sum == 0:
                    # new accelerator consumed everything: complete
                    note_feasible(accs, splits)
                    continue
                t = int(rem_of[j])
                rem_util = float(utils_rem[t])
                if constraint.completes(rem_util):
                    # lines 13-14: feasible completion
                    rem_acc = make_acc(chips_left, int(blocks_rem[t]))
                    note_feasible(accs + (rem_acc,), splits + (left,))
                # line 12: retain for further partitioning. Guide =
                # objective's admissible balance estimate over the
                # stages still available (scoring the remainder as ONE
                # accelerator systematically prunes children whose
                # remainder is heavy but splittable).
                stages_left = max(1, max_m - len(accs))
                node = _Node(
                    assigned=nvec,
                    chips_used=parent.chips_used + chips_new,
                    accs=accs,
                    splits=splits,
                    created_max_util=cmax,
                    guide=objective.guide(cmax, rem_util, stages_left),
                )
                key = (nvec, parent.chips_used + chips_new, splits)
                prev = children.get(key)
                if prev is None or node.guide < prev.guide:
                    children[key] = node
                stats.children_generated += 1
                if len(children) > max_frontier:
                    raise RuntimeError(
                        "frontier exceeded max_frontier; "
                        "use a beam width for this problem size"
                    )
        flush_feasible()
        ranked = sorted(children.values(), key=lambda c: c.guide)
        if beam_width is None:
            parents = ranked
        else:
            # diverse top-B: prefer distinct layer frontiers (siblings
            # that differ only in chip split crowd out genuinely
            # different partitions otherwise), then fill remaining slots
            # with the best leftovers.
            picked, seen_assigned, leftovers = [], set(), []
            for node in ranked:
                if len(picked) >= beam_width:
                    break
                if node.assigned in seen_assigned:
                    leftovers.append(node)
                else:
                    seen_assigned.add(node.assigned)
                    picked.append(node)
            for node in leftovers:
                if len(picked) >= beam_width:
                    break
                picked.append(node)
            parents = picked
        if not parents:
            break

    # rtlint: disable=clock-domain -- the DSE's own search time
    stats.wall_time_s = time.perf_counter() - t0
    # deduplicate succ_pts (same splits + chips allocation)
    seen, unique = set(), []
    for dp in sorted(succ, key=lambda d: d.max_util):
        key = (dp.splits, tuple(a.chips for a in dp.accs))
        if key not in seen:
            seen.add(key)
            unique.append(dp)
    return BeamResult(succ_pts=unique, best=best, stats=stats)
