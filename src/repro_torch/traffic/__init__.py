"""Traffic & admission control for the PHAROS serving stack.

Turns the paper's design-time analysis (Eqs. 2–3, response bounds) into
an *online* layer in front of the serving runtime:

- `arrival`   — seedable arrival models (periodic, sporadic, Poisson,
  bursty MMPP, trace replay) behind one `ArrivalProcess` protocol;
- `admission` — `AdmissionController`: O(stages) admit/reject verdicts
  that agree bit-exactly with a full `srt_schedulable` re-analysis,
  plus headroom/sensitivity reports, and the batched front-end
  (`check_many` / `score_many`) pricing whole tenant cohorts in one
  array pass (docs/scale.md);
- `shedding`  — overload policies (reject-newest, shed-by-value,
  degrade-to-best-effort) + the `BacklogMonitor` that engages them when
  observed backlog contradicts the analysis, and the
  `des_release_shedding` adapter pushing the same decisions into the
  DES;
- `ratelimit` — per-tenant token buckets (`RateLimiter`, array-backed:
  `allow_many` sweeps a whole due batch vectorized, `from_arrays`
  provisions million-tenant fleets) trimming live traffic back to the
  provisioned contract in front of admission;
- `modes`     — mixed-criticality overload modes (`ModeController`):
  HI/LO tenant classes, backlog-triggered HI-mode switches that re-run
  the Eq. 3 admission over the HI survivor set *before* committing,
  and symmetric recovery when the backlog drains;
- `gateway`   — `TrafficGateway`: the admission-controlled front door
  releasing `ArrivalProcess` traffic into a `PharosServer`;
- `scenarios` — named traffic mixes (smart-transportation style) built
  from the paper workloads and the LM `configs/`;
- `clock`     — `WallClock` / deterministic `VirtualClock` shared by
  gateway and server.

The JAX package's sharded gateway (`shard`), live migration
(`migration`) and autoscaler (`autoscale`) are not ported yet.
"""
from repro_torch.traffic.admission import (
    CRITICALITY_HI,
    CRITICALITY_LEVELS,
    CRITICALITY_LO,
    AdmissionController,
    AdmissionDecision,
    HeadroomReport,
    TaskRequest,
    calibrated_requests,
)
from repro_torch.traffic.arrival import (
    ArrivalProcess,
    MMPPArrivals,
    PeriodicArrivals,
    PoissonArrivals,
    SporadicArrivals,
    TraceArrivals,
    merge_arrivals,
)
from repro_torch.traffic.clock import VirtualClock, WallClock
from repro_torch.traffic.gateway import GatewayReport, TrafficGateway
from repro_torch.traffic.modes import (
    MODE_HI,
    MODE_NORMAL,
    MODES,
    ModeController,
    ModeSwitch,
)
from repro_torch.traffic.ratelimit import RateLimiter, TokenBucket
from repro_torch.traffic.scenarios import (
    ArrivalSpec,
    BuiltScenario,
    TenantSpec,
    TrafficScenario,
    build,
    get_scenario,
    list_scenarios,
    materialize,
    register,
    replicate,
    resolve_problem,
)
from repro_torch.traffic.shedding import (
    BacklogMonitor,
    DegradeToBestEffort,
    RejectNewest,
    ShedByValue,
    des_release_shedding,
    get_policy,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "CRITICALITY_HI",
    "CRITICALITY_LEVELS",
    "CRITICALITY_LO",
    "HeadroomReport",
    "TaskRequest",
    "calibrated_requests",
    "ArrivalProcess",
    "PeriodicArrivals",
    "SporadicArrivals",
    "PoissonArrivals",
    "MMPPArrivals",
    "TraceArrivals",
    "merge_arrivals",
    "VirtualClock",
    "WallClock",
    "TrafficGateway",
    "GatewayReport",
    "MODE_HI",
    "MODE_NORMAL",
    "MODES",
    "ModeController",
    "ModeSwitch",
    "ArrivalSpec",
    "TenantSpec",
    "TrafficScenario",
    "BuiltScenario",
    "build",
    "get_scenario",
    "list_scenarios",
    "materialize",
    "register",
    "replicate",
    "resolve_problem",
    "BacklogMonitor",
    "RejectNewest",
    "ShedByValue",
    "DegradeToBestEffort",
    "des_release_shedding",
    "get_policy",
    "RateLimiter",
    "TokenBucket",
]
