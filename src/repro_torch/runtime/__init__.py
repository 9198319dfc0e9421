from repro_torch.runtime.ft import FaultTolerantLoop, HeartbeatMonitor, WorkerState
from repro_torch.runtime.compression import (
    compress_gradients,
    decompress_gradients,
    ErrorFeedbackState,
)
from repro_torch.runtime.straggler import StragglerMitigator
from repro_torch.runtime.elastic import ElasticPlan, plan_remesh

__all__ = [
    "FaultTolerantLoop",
    "HeartbeatMonitor",
    "WorkerState",
    "compress_gradients",
    "decompress_gradients",
    "ErrorFeedbackState",
    "StragglerMitigator",
    "ElasticPlan",
    "plan_remesh",
]
