"""Cross-layer conformance: one scenario, three layers, one verdict.

- `costmodel` — `CostModel`: per-(task, layer) virtual WCETs from the
  exec model or from wall-clock calibration probes; drives the serving
  runtime's virtual time and exports the same WCETs to the analysis
  (`segment_table`), the DES's limited-preemption chunk schedules
  (`chunk_schedule`) and its overhead accounting (`des_overheads`).
- `harness` — `run_conformance` / `run_case`: differential testing of
  `core.rt` analysis vs the window-boundary `scheduler.des` vs a
  virtual-clock `PharosServer`, enforcing ``analytic bound >= DES >=
  runtime`` and verdict agreement, reporting every `Violation` with
  its margin; `run_sharded_case` (every shard of a placed tenant set
  held to the full contract + bit-exact per-shard admission);
  `run_shedding_case` (overdriven traffic with identical shedding
  armed in DES and runtime, release-matched surviving jobs);
  `run_mode_switch_case` (mixed-criticality overload: twin
  `ModeController`s in DES and runtime must agree on the Eq. 3
  re-proved HI survivor set and lose zero HI deadlines across every
  transition);
  `run_migration_case` (live tenant re-homing on the shared-clock
  co-simulated elastic gateway, DES replayed on the realized release
  stamps: exact survivor-set agreement, zero deadline violations
  during any handover, proof-before-commit membership);
  `run_dse_case` (every DSE-claimed-feasible design held to the three
  layers, and the best design provisioned into a `ShardedGateway`
  that must serve the scenario's traffic violation-free); plus
  `run_wallclock_case`, the calibrated real-clock leg (gateway on
  `WallClock` vs the measured `CostModel`, optionally with
  calibrated-admission mode: tenancy admitted against measured WCETs).
  Every leg runs its server on ``device`` (default ``"cuda"``).

See ``docs/conformance.md`` for the full contract and tolerance model.
"""
from repro_torch.conformance.costmodel import CostModel
from repro_torch.conformance.harness import (
    DEFAULT_SCENARIOS,
    POLICIES,
    PR2_QUANTUM_SLACK,
    PR2_TOL_REL,
    PR3_QUANTUM_SLACK,
    CaseResult,
    ConformanceConfig,
    ConformanceReport,
    DSECaseResult,
    MigrationCaseResult,
    MigrationTenantRow,
    ModeSwitchCaseResult,
    ModeSwitchTaskRow,
    ShardedCaseResult,
    SheddingCaseResult,
    SheddingTaskRow,
    TaskConformance,
    Violation,
    WallClockCase,
    WallClockTask,
    regulate_trace,
    run_case,
    run_conformance,
    run_dse_case,
    run_migration_case,
    run_mode_switch_case,
    run_sharded_case,
    run_shedding_case,
    run_virtual_server,
    run_wallclock_case,
)

__all__ = [
    "CostModel",
    "DEFAULT_SCENARIOS",
    "POLICIES",
    "PR2_QUANTUM_SLACK",
    "PR2_TOL_REL",
    "PR3_QUANTUM_SLACK",
    "CaseResult",
    "ConformanceConfig",
    "ConformanceReport",
    "DSECaseResult",
    "MigrationCaseResult",
    "MigrationTenantRow",
    "ModeSwitchCaseResult",
    "ModeSwitchTaskRow",
    "ShardedCaseResult",
    "SheddingCaseResult",
    "SheddingTaskRow",
    "TaskConformance",
    "Violation",
    "WallClockCase",
    "WallClockTask",
    "regulate_trace",
    "run_case",
    "run_conformance",
    "run_dse_case",
    "run_migration_case",
    "run_mode_switch_case",
    "run_sharded_case",
    "run_shedding_case",
    "run_virtual_server",
    "run_wallclock_case",
]
