"""PHAROS design-space exploration (paper §4).

`explore` is the one search API (SRT-guided beam/brute and the TG
baseline as configurations of one entry point); `provision` bridges a
search result into the serving stack (scenario + sharded gateway).
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
from repro_torch.core.dse.brute import brute_force_search
from repro_torch.core.dse.explore import DSEConfig, ExploreResult, explore
from repro_torch.core.dse.provision import ProvisionPlan, provision
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
    "brute_force_search",
    "DSEConfig",
    "ExploreResult",
    "explore",
    "ProvisionPlan",
    "provision",
    "TGDesign",
    "throughput_guided_design",
    "tg_simtasks",
]
