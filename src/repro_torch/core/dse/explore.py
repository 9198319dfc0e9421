"""`explore` — the unified DSE driver.

The seed repo had three disconnected entry points: `beam_search`,
`brute_force_search` (a copy of beam with ``B = +inf``) and
`throughput_guided_design` (the CHARM-style TG baseline), each with its
own result shape and hard-coded objective. `explore` makes them
**configurations of one driver**:

- ``method="beam"`` / ``method="brute"`` run the (batched) beam core —
  brute is literally ``beam_width=None`` — under a pluggable
  `Objective`/`Constraint` pair (default: the paper's SRT
  configuration, `MinMaxUtil` + `Eq3Constraint`);
- ``method="tg"`` runs the throughput-guided clustering under the
  `TotalLatency` objective. TG designs backtrack, so Eq. 3 does not
  apply to them; `ExploreResult.tg_eq2_feasible` reports the Eq. 2
  utilization gate and the DES remains their schedulability oracle
  (`benchmarks/fig6_sg_vs_tg.py`).

Every method returns an `ExploreResult` carrying the same `BeamStats`
(wall time, candidates evaluated, evaluated-candidates/sec), so
SRT-vs-TG comparisons — Fig. 6, `benchmarks/dse_bench.py` — read one
result type instead of three.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

from repro_torch.core.dse.beam import BeamResult, BeamStats, beam_search
from repro_torch.core.dse.objective import (
    Constraint,
    Eq3Constraint,
    MinMaxUtil,
    Objective,
    TotalLatency,
)
from repro_torch.core.dse.space import DesignPoint
from repro_torch.core.dse.throughput import TGDesign, throughput_guided_design
from repro_torch.core.perfmodel.hardware import Platform
from repro_torch.core.rt.task import TaskSet, Workload

METHODS = ("beam", "brute", "tg")


@dataclass(frozen=True)
class DSEConfig:
    """One search configuration for `explore`."""

    method: str = "beam"
    #: None -> the method's default (`MinMaxUtil` for beam/brute — the
    #: paper's SRT-guided search — and `TotalLatency` for tg)
    objective: Objective | None = None
    constraint: Constraint = field(default_factory=Eq3Constraint)
    max_m: int = 4
    beam_width: int | None = 8
    max_frontier: int = 200_000
    #: TG only: number of shape clusters / accelerators
    n_accs: int = 4
    evaluator: str = "batched"
    #: beam/brute: allow split boundaries only every this many layers
    #: (1 = the paper's exact layer-granular space; coarsen for long
    #: flattened LM chains)
    split_stride: int = 1

    def __post_init__(self) -> None:
        if self.method not in METHODS:
            raise ValueError(
                f"unknown DSE method {self.method!r}; have {METHODS}"
            )

    def resolved_objective(self) -> Objective:
        if self.objective is not None:
            return self.objective
        return TotalLatency() if self.method == "tg" else MinMaxUtil()


@dataclass
class ExploreResult:
    """Unified result of one `explore` run."""

    method: str
    objective: str
    #: every feasible complete design found (beam/brute; empty for tg)
    succ_pts: list[DesignPoint]
    #: objective-best feasible design (beam/brute; None for tg)
    best: DesignPoint | None
    stats: BeamStats
    #: the TG design (tg method only)
    tg: TGDesign | None = None
    #: `Objective.score` of the returned design, in the objective's own
    #: units for every method (None when no design was found) — the
    #: cross-configuration comparison value
    score: float | None = None

    @property
    def feasible_found(self) -> int:
        return self.stats.feasible_found

    @property
    def tg_eq2_feasible(self) -> bool:
        """Eq. 2 gate for the TG design (``max_util <= 1``); NOT an
        SRT-schedulability verdict — TG backtracks, so the guideline
        theory does not apply and the DES stays the oracle."""
        if self.tg is None:
            return False
        return self.tg.max_util <= 1.0 + 1e-12

    def as_beam_result(self) -> BeamResult:
        """Back-compat view for callers holding a `BeamResult`."""
        return BeamResult(
            succ_pts=self.succ_pts, best=self.best, stats=self.stats
        )


def explore(
    workloads: list[Workload],
    taskset: TaskSet,
    platform: Platform,
    cfg: DSEConfig | None = None,
    **overrides,
) -> ExploreResult:
    """Run one DSE configuration; keyword overrides patch ``cfg``
    (e.g. ``explore(wls, ts, plat, method="brute", max_m=3)``)."""
    cfg = cfg or DSEConfig()
    if overrides:
        cfg = replace(cfg, **overrides)
    objective = cfg.resolved_objective()

    if cfg.method in ("beam", "brute"):
        res = beam_search(
            workloads,
            taskset,
            platform,
            max_m=cfg.max_m,
            beam_width=None if cfg.method == "brute" else cfg.beam_width,
            max_frontier=cfg.max_frontier,
            objective=objective,
            constraint=cfg.constraint,
            evaluator=cfg.evaluator,
            split_stride=cfg.split_stride,
        )
        score = None
        if res.best is not None:
            from repro_torch.core.dse.space import evaluate_design

            score = objective.score(
                evaluate_design(
                    res.best.accs, res.best.splits, workloads, taskset
                ),
                taskset,
            )
        return ExploreResult(
            method=cfg.method,
            objective=objective.name,
            succ_pts=res.succ_pts,
            best=res.best,
            stats=res.stats,
            score=score,
        )

    # -- tg: CHARM-style clustering under the throughput objective ----
    from repro_torch.core.dse.create_acc import _VALID_BLOCKS

    # rtlint: disable=clock-domain -- the DSE's own search time
    t0 = time.perf_counter()
    tg = throughput_guided_design(
        workloads, taskset, platform, n_accs=cfg.n_accs
    )
    # rtlint: disable=clock-domain -- the DSE's own search time
    wall = time.perf_counter() - t0
    # the TG inner loop prices every (cluster, valid block) accelerator
    # candidate once — the analogue of the beam's create_acc count
    evals = len(tg.accs) * len(_VALID_BLOCKS)
    stats = BeamStats(
        create_acc_calls=evals,
        wall_time_s=wall,
        eval_seconds=wall,
        feasible_found=0,
        evaluator="scalar",
    )
    return ExploreResult(
        method="tg",
        objective=objective.name,
        succ_pts=[],
        best=None,
        stats=stats,
        tg=tg,
        score=objective.score(tg.table, taskset),
    )
