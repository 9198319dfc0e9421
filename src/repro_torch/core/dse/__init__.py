"""PHAROS design-space exploration (paper §4).

`explore` is the unified driver (SRT-guided beam and the TG baseline
as configurations of one entry point). The JAX package's exhaustive
search (`brute`) and its provisioning bridge (`provision`) are not
ported yet.
"""
from repro_torch.core.dse.space import (
    DesignPoint,
    design_from_splits,
    evaluate_design,
    fixed_design,
)
from repro_torch.core.dse.create_acc import LatencyCache, create_acc
from repro_torch.core.dse.batch_eval import BatchedDesignEvaluator, resolve_acc
from repro_torch.core.dse.objective import (
    Constraint,
    Eq3Constraint,
    MinMaxUtil,
    Objective,
    TotalLatency,
)
from repro_torch.core.dse.beam import BeamResult, BeamStats, beam_search
from repro_torch.core.dse.explore import DSEConfig, ExploreResult, explore
from repro_torch.core.dse.throughput import (
    TGDesign,
    throughput_guided_design,
    tg_simtasks,
)

__all__ = [
    "DesignPoint",
    "design_from_splits",
    "evaluate_design",
    "fixed_design",
    "LatencyCache",
    "create_acc",
    "BatchedDesignEvaluator",
    "resolve_acc",
    "Objective",
    "Constraint",
    "MinMaxUtil",
    "TotalLatency",
    "Eq3Constraint",
    "BeamResult",
    "BeamStats",
    "beam_search",
    "DSEConfig",
    "ExploreResult",
    "explore",
    "TGDesign",
    "throughput_guided_design",
    "tg_simtasks",
]
