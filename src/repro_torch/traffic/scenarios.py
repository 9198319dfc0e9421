"""Scenario registry: named traffic mixes for benchmarks and examples.

A `TrafficScenario` describes a smart-transportation-style deployment as
a set of *tenants*: each references a workload — one of the paper's
five applications (``paper:<name>``, core.workloads) or an LM drawn
from the existing ``configs/`` (``config:<module>:<mode>``, flattened by
`models.extract.arch_workload`) — plus the paper's period knob (ratio
over the single-accelerator reference latency P'), an `ArrivalSpec`
(traffic shape relative to that period), a value for shed-by-value, and
an ``overdrive`` factor (actual traffic rate over the provisioned rate;
``> 1`` deliberately violates the analysis to exercise shedding).

`build` turns a scenario into everything the other layers consume:
provisioned `TaskSet` + DSE design + `SegmentTable` (analysis &
admission), seeded `ArrivalProcess` traces (DES & gateway), and
`TaskRequest` contracts. `BuiltScenario.serve_bundle` rescales the lot
to a wall-clock (or virtual) timebase and materializes `ServeTask`
GEMM chains for the `TrafficGateway`/`PharosServer` path, so examples
and benchmarks name a scenario instead of hand-building task sets.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.core.rt.task import SegmentTable, Task, TaskSet, Workload
from repro_torch.core.workloads import (
    PAPER_WORKLOADS,
    single_acc_reference_latency,
)
from repro_torch.traffic.admission import (
    CRITICALITY_HI,
    CRITICALITY_LEVELS,
    CRITICALITY_LO,
    TaskRequest,
)
from repro_torch.traffic.arrival import (
    ArrivalProcess,
    MMPPArrivals,
    PeriodicArrivals,
    PoissonArrivals,
    SporadicArrivals,
)

_ARRIVAL_KINDS = ("periodic", "sporadic", "poisson", "mmpp")


@dataclass(frozen=True)
class ArrivalSpec:
    """Traffic shape, parameterized *relative* to the tenant period.

    - ``periodic``: releases every period.
    - ``sporadic``: min gap = period, exponential extra gap of mean
      ``jitter`` periods.
    - ``poisson``:  mean rate 1/period; provisioned for
      ``provision_factor`` x mean.
    - ``mmpp``:     calm rate ``calm_factor``/period, burst rate
      ``burst_factor``/period, mean dwells of ``dwells`` periods;
      provisioned for the burst rate.
    """

    kind: str = "periodic"
    jitter: float = 0.3
    calm_factor: float = 0.5
    burst_factor: float = 3.0
    dwells: tuple[float, float] = (40.0, 10.0)
    provision_factor: float = 1.5

    def __post_init__(self) -> None:
        if self.kind not in _ARRIVAL_KINDS:
            raise ValueError(
                f"unknown arrival kind {self.kind!r}; have {_ARRIVAL_KINDS}"
            )

    def build(self, period: float, seed: int) -> ArrivalProcess:
        if self.kind == "periodic":
            return PeriodicArrivals(period=period)
        if self.kind == "sporadic":
            return SporadicArrivals(
                min_gap=period, jitter=self.jitter, seed=seed
            )
        if self.kind == "poisson":
            return PoissonArrivals(
                rate=1.0 / period,
                seed=seed,
                provision_factor=self.provision_factor,
            )
        return MMPPArrivals(
            rates=(self.calm_factor / period, self.burst_factor / period),
            dwells=(self.dwells[0] * period, self.dwells[1] * period),
            seed=seed,
            provision_factor=1.0,
        )

    def analysis_period(self, period: float) -> float:
        """Provisioned inter-arrival bound for Eq. 2 accounting."""
        if self.kind in ("periodic", "sporadic"):
            return period
        if self.kind == "poisson":
            return period / self.provision_factor
        return period / self.burst_factor


@dataclass(frozen=True)
class TenantSpec:
    workload: str  # "paper:<name>" | "config:<module>:<mode>"
    ratio: float  # period = P'(workload) / ratio — the paper's knob
    arrival: ArrivalSpec = ArrivalSpec()
    value: float = 1.0
    name: str = ""
    #: actual traffic rate / provisioned rate; > 1 deliberately breaks
    #: the analysis so overload shedding engages
    overdrive: float = 1.0
    #: batch/seq only used by config:-references
    batch: int = 1
    seq: int = 2048
    #: mixed-criticality class (see `repro_torch.traffic.admission`): "HI"
    #: tenants survive an overload mode switch, "LO" tenants are shed
    #: or demoted by the `ModeController`
    criticality: str = CRITICALITY_LO

    def __post_init__(self) -> None:
        if self.ratio <= 0 or self.overdrive <= 0:
            raise ValueError("ratio and overdrive must be positive")
        if self.criticality not in CRITICALITY_LEVELS:
            raise ValueError(
                f"unknown criticality {self.criticality!r}; "
                f"expected one of {CRITICALITY_LEVELS}"
            )
        if not self.name:
            object.__setattr__(
                self, "name", self.workload.split(":", 1)[-1]
            )


@dataclass(frozen=True)
class TrafficScenario:
    name: str
    description: str
    tenants: tuple[TenantSpec, ...]
    policy: str = "edf"  # serving/DES scheduling policy

    def __post_init__(self) -> None:
        if not self.tenants:
            raise ValueError("scenario has no tenants")


# ---------------------------------------------------------------------------
# workload resolution
# ---------------------------------------------------------------------------
def resolve_workload(spec: TenantSpec) -> Workload:
    ref = spec.workload
    src, _, rest = ref.partition(":")
    if src == "paper":
        try:
            return PAPER_WORKLOADS[rest]
        except KeyError:
            raise KeyError(
                f"unknown paper workload {rest!r}; "
                f"have {sorted(PAPER_WORKLOADS)}"
            ) from None
    if src == "config":
        module, _, mode = rest.partition(":")
        from repro_torch.models.extract import arch_workload

        cfg = importlib.import_module(f"repro_torch.configs.{module}").CONFIG
        return arch_workload(
            cfg, batch=spec.batch, seq=spec.seq, mode=mode or "decode"
        )
    raise ValueError(
        f"workload ref {ref!r} must start with 'paper:' or 'config:'"
    )


# ---------------------------------------------------------------------------
# build: scenario -> analysis artifacts + traffic
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BuiltScenario:
    scenario: TrafficScenario
    workloads: tuple[Workload, ...]
    taskset: TaskSet  # provisioned periods (analysis view)
    design: object  # DesignPoint from the DSE
    table: SegmentTable
    requests: tuple[TaskRequest, ...]
    arrivals: tuple[ArrivalProcess, ...]  # actual traffic (w/ overdrive)

    def des_arrivals(self, horizon: float) -> list[list[float]]:
        """Per-task explicit release times for `simulate_taskset`."""
        return [p.arrivals(horizon) for p in self.arrivals]

    def subset(self, indices, *, name: str | None = None) -> "BuiltScenario":
        """Restrict this built scenario to a tenant subset (in the given
        order) on the *same* pipeline design — the per-shard view a
        `ShardedGateway` places tenants into. Everything tenant-indexed
        is subset together (tenants, workloads, taskset, table rows,
        requests and the already-seeded arrival processes — traffic is
        preserved verbatim, not re-seeded); the design keeps its
        accelerators and stage count with its per-task layer splits
        restricted, so `serve_bundle` and the conformance `CostModel`
        work on the subset unchanged. The identity subset reproduces
        this scenario bit-exactly — the K=1 sharding equivalence.
        """
        from repro_torch.core.dse.space import DesignPoint
        from repro_torch.core.rt.schedulability import max_utilization

        idx = list(indices)
        if not idx:
            raise ValueError("subset needs at least one tenant")
        sub_table = SegmentTable(
            base=[list(self.table.base[i]) for i in idx],
            overhead=list(self.table.overhead),
        )
        sub_taskset = TaskSet(tasks=tuple(self.taskset.tasks[i] for i in idx))
        design = DesignPoint(
            accs=self.design.accs,
            splits=tuple(
                tuple(row[i] for i in idx) for row in self.design.splits
            ),
            max_util=max_utilization(sub_table, sub_taskset, False),
        )
        scen = TrafficScenario(
            name=name or self.scenario.name,
            description=self.scenario.description,
            tenants=tuple(self.scenario.tenants[i] for i in idx),
            policy=self.scenario.policy,
        )
        return BuiltScenario(
            scenario=scen,
            workloads=tuple(self.workloads[i] for i in idx),
            taskset=sub_taskset,
            design=design,
            table=sub_table,
            requests=tuple(self.requests[i] for i in idx),
            arrivals=tuple(self.arrivals[i] for i in idx),
        )

    def serve_bundle(
        self,
        *,
        period_scale: float,
        seed: int = 0,
        rows: int = 128,
        max_dim: int | None = None,
        generator=None,
        device="cuda",
    ):
        """Rescale to the serving timebase and materialize GEMM chains.

        Returns ``(serve_tasks, requests, arrivals)`` for the
        `TrafficGateway`: periods *and* WCETs scale together by
        ``period_scale`` so every utilization — and therefore every
        admission verdict — is preserved; only the time unit changes.
        ``max_dim`` caps surrogate-GEMM dims for cost-model-driven
        virtual runs (see `design_to_segments`). The weights are drawn
        on the CPU from ``generator`` (a `torch.Generator`; default:
        one seeded with ``seed``) and placed on ``device``, so one seed
        gives the same weights on every device.
        """
        import torch

        from repro_torch.pipeline.stage_split import design_to_segments

        serve_tasks = design_to_segments(
            self.design,
            list(self.workloads),
            self.taskset,
            generator=(
                generator
                if generator is not None
                else torch.Generator().manual_seed(seed)
            ),
            rows=rows,
            period_scale=period_scale,
            max_dim=max_dim,
            device=device,
        )
        requests = tuple(
            TaskRequest(
                name=r.name,
                base=tuple(b * period_scale for b in r.base),
                period=r.period * period_scale,
                value=r.value,
                criticality=r.criticality,
            )
            for r in self.requests
        )
        arrivals = tuple(
            spec.arrival.build(
                base_period * period_scale / spec.overdrive,
                seed=seed + 101 * i,
            )
            for i, (spec, base_period) in enumerate(
                zip(self.scenario.tenants, self._base_periods())
            )
        )
        return serve_tasks, requests, arrivals

    def conformance_cost_model(self, serve_tasks, *, period_scale: float = 1.0):
        """The `repro_torch.conformance.CostModel` pricing ``serve_tasks`` on
        this scenario's design — the model-driven replacement for the
        old ``virtual_period_scale`` one-window-per-``virtual_dt``
        quantization: virtual serving is charged per executed window
        from the same exec-model WCETs the analysis uses. Pass the
        same ``period_scale`` the serve bundle was built with so costs
        and periods stay on one timebase.
        """
        from repro_torch.conformance import CostModel

        return CostModel.from_exec_model(
            self.design,
            list(self.workloads),
            serve_tasks,
            period_scale=period_scale,
        )

    def _base_periods(self) -> tuple[float, ...]:
        # un-provisioned tenant periods (P'/ratio), recovered from the
        # provisioned taskset periods
        return tuple(
            t.period * spec.arrival.analysis_period(1.0) ** -1
            for t, spec in zip(self.taskset.tasks, self.scenario.tenants)
        )


def resolve_problem(
    scenario: TrafficScenario, platform
) -> tuple[list[Workload], TaskSet]:
    """Resolve workloads and provisioned periods — the DSE problem a
    scenario defines, before any design is chosen."""
    workloads, periods = [], []
    for spec in scenario.tenants:
        w = resolve_workload(spec)
        p_ref = single_acc_reference_latency(w, platform)
        base_period = p_ref / spec.ratio
        workloads.append(w)
        periods.append(spec.arrival.analysis_period(base_period))
    taskset = TaskSet(
        tasks=tuple(
            Task(workload=w, period=p, name=spec.name)
            for w, p, spec in zip(workloads, periods, scenario.tenants)
        )
    )
    return workloads, taskset


def materialize(
    scenario: TrafficScenario,
    workloads: list[Workload],
    taskset: TaskSet,
    design,
    *,
    seed: int = 0,
) -> BuiltScenario:
    """Turn a chosen `DesignPoint` into a full `BuiltScenario`: segment
    table, admission contracts and seeded traffic. This is the
    DSE -> serving half of `build`, split out so the provisioning
    bridge (the JAX package's `repro.core.dse.provision`) can materialize *any* claimed-
    feasible design — not just the one `build` would have searched."""
    from repro_torch.core.dse.space import evaluate_design

    table = evaluate_design(design.accs, design.splits, workloads, taskset)
    requests = tuple(
        TaskRequest(
            name=spec.name,
            base=tuple(table.base[i]),
            period=taskset.tasks[i].period,
            value=spec.value,
            criticality=spec.criticality,
        )
        for i, spec in enumerate(scenario.tenants)
    )
    arrivals = tuple(
        spec.arrival.build(
            (taskset.tasks[i].period / spec.arrival.analysis_period(1.0))
            / spec.overdrive,
            seed=seed + 101 * i,
        )
        for i, spec in enumerate(scenario.tenants)
    )
    return BuiltScenario(
        scenario=scenario,
        workloads=tuple(workloads),
        taskset=taskset,
        design=design,
        table=table,
        requests=requests,
        arrivals=arrivals,
    )


def build(
    scenario: TrafficScenario,
    platform,
    *,
    max_m: int = 3,
    beam_width: int = 6,
    seed: int = 0,
    design=None,
) -> BuiltScenario:
    """Resolve workloads, size periods, run the DSE, seed the traffic.

    ``design`` (a `DesignPoint`) skips the search and materializes the
    given design instead — the JAX package's `repro.core.dse.provision` path.
    """
    from repro_torch.core.dse.explore import explore

    workloads, taskset = resolve_problem(scenario, platform)
    if design is None:
        res = explore(
            workloads,
            taskset,
            platform,
            method="beam",
            max_m=max_m,
            beam_width=beam_width,
        )
        design = res.best
        if design is None:
            raise ValueError(
                f"scenario {scenario.name!r} has no feasible design on "
                f"{platform.name}: lower the ratios or the provisioning"
            )
    return materialize(scenario, workloads, taskset, design, seed=seed)


def replicate(built: BuiltScenario, copies: int) -> BuiltScenario:
    """``copies`` independent copies of every tenant on the same
    pipeline design: names suffixed ``#c<i>``, traffic re-seeded per
    copy (same shapes, fresh randomness), per-task design splits
    duplicated. The result deliberately overcommits one pipeline —
    the population the sharded admission (`repro.traffic.shard`) has
    to triage and the autoscaler (`repro.traffic.autoscale`) has to
    absorb by growing the fleet."""
    from dataclasses import replace as dc_replace

    from repro_torch.core.dse.space import DesignPoint

    if copies < 1:
        raise ValueError("need at least one copy")
    n = len(built.requests)
    tenants, workloads, tasks, base, reqs, arrs = [], [], [], [], [], []
    for c in range(copies):
        for i in range(n):
            spec = built.scenario.tenants[i]
            name = spec.name if c == 0 else f"{spec.name}#c{c}"
            tenants.append(dc_replace(spec, name=name))
            workloads.append(built.workloads[i])
            t = built.taskset.tasks[i]
            tasks.append(
                Task(
                    workload=t.workload,
                    period=t.period,
                    deadline=t.deadline,
                    sporadic=t.sporadic,
                    name=name,
                )
            )
            base.append(list(built.table.base[i]))
            r = built.requests[i]
            reqs.append(dc_replace(r, name=name))
            proc = built.arrivals[i]
            arrs.append(
                dc_replace(proc, seed=proc.seed + 7919 * c)
                if hasattr(proc, "seed")
                else proc
            )
    return BuiltScenario(
        scenario=TrafficScenario(
            name=f"{built.scenario.name}x{copies}",
            description=built.scenario.description,
            tenants=tuple(tenants),
            policy=built.scenario.policy,
        ),
        workloads=tuple(workloads),
        taskset=TaskSet(tasks=tuple(tasks)),
        design=DesignPoint(
            accs=built.design.accs,
            splits=tuple(
                tuple(row[i % len(row)] for i in range(copies * n))
                for row in built.design.splits
            ),
            max_util=built.design.max_util * copies,
        ),
        table=SegmentTable(base=base, overhead=list(built.table.overhead)),
        requests=tuple(reqs),
        arrivals=tuple(arrs),
    )


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
SCENARIOS: dict[str, TrafficScenario] = {}


def register(scenario: TrafficScenario) -> TrafficScenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> TrafficScenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        ) from None


def list_scenarios() -> list[tuple[str, str]]:
    return [(s.name, s.description) for _, s in sorted(SCENARIOS.items())]


register(
    TrafficScenario(
        name="steady_city",
        description=(
            "Baseline smart-transportation mix: periodic LiDAR "
            "perception (PointNet) + periodic camera backbone "
            "(MLP-Mixer), comfortably provisioned"
        ),
        tenants=(
            TenantSpec("paper:pointnet", ratio=1.0, value=3.0),
            TenantSpec("paper:mlp_mixer", ratio=0.8, value=1.0),
        ),
    )
)

register(
    TrafficScenario(
        name="rush_hour",
        description=(
            "Bursty peak traffic: sporadic LiDAR (sensor-synced with "
            "jitter) + MMPP camera stream whose burst state triples "
            "the rate — the admission layer provisions for the burst"
        ),
        tenants=(
            TenantSpec(
                "paper:pointnet",
                ratio=0.8,
                arrival=ArrivalSpec(kind="sporadic", jitter=0.25),
                value=3.0,
            ),
            TenantSpec(
                "paper:deit_t",
                # effective provisioned ratio is 3x this (the burst
                # rate): 0.3 * 3 = 0.9 of the reference latency
                ratio=0.3,
                arrival=ArrivalSpec(
                    kind="mmpp",
                    calm_factor=0.5,
                    burst_factor=3.0,
                    dwells=(40.0, 10.0),
                ),
                value=1.0,
            ),
        ),
    )
)

register(
    TrafficScenario(
        name="sensor_fusion",
        description=(
            "Three-tenant fusion rig: sporadic point-cloud transformer, "
            "periodic ResMLP segmentation, Poisson DeiT detections"
        ),
        tenants=(
            TenantSpec(
                "paper:point_transformer",
                ratio=0.4,
                arrival=ArrivalSpec(kind="sporadic", jitter=0.4),
                value=2.0,
            ),
            TenantSpec("paper:resmlp", ratio=0.35, value=1.5),
            TenantSpec(
                "paper:deit_t",
                ratio=0.25,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.5),
                value=1.0,
            ),
        ),
    )
)

register(
    TrafficScenario(
        name="copilot_decode",
        description=(
            "Safety + assistant: periodic DeiT safety monitor sharing "
            "the pipeline with Poisson LM decode traffic "
            "(stablelm-1.6b from configs/), decode valued lowest"
        ),
        tenants=(
            TenantSpec("paper:deit_t", ratio=0.5, value=5.0),
            TenantSpec(
                "config:stablelm_1_6b:decode",
                ratio=0.3,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.3),
                value=0.5,
                batch=8,
                seq=2048,
            ),
        ),
    )
)

register(
    TrafficScenario(
        name="multi_tenant_rush",
        description=(
            "Four-tenant peak mix for the multi-gateway scale layer: "
            "sporadic LiDAR, an MMPP camera stream overdriven past its "
            "burst provisioning, Poisson segmentation and a periodic "
            "backbone — the shard/ratelimit/shedding benchmark scenario"
        ),
        tenants=(
            TenantSpec(
                "paper:pointnet",
                ratio=0.4,
                arrival=ArrivalSpec(kind="sporadic", jitter=0.25),
                value=3.0,
            ),
            TenantSpec(
                "paper:deit_t",
                ratio=0.12,
                arrival=ArrivalSpec(
                    kind="mmpp",
                    calm_factor=0.5,
                    burst_factor=3.0,
                    dwells=(30.0, 10.0),
                ),
                value=1.0,
                overdrive=3.0,
            ),
            TenantSpec(
                "paper:resmlp",
                ratio=0.25,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.5),
                value=2.0,
                overdrive=3.0,
            ),
            TenantSpec("paper:mlp_mixer", ratio=0.3, value=1.5),
        ),
    )
)

register(
    TrafficScenario(
        name="noisy_neighbor",
        description=(
            "Two well-behaved safety tenants sharing the pipeline with "
            "a low-value Poisson tenant sending 5x its provisioned "
            "rate — the per-tenant rate-limiting and DES-level "
            "shedding stress scenario"
        ),
        tenants=(
            TenantSpec("paper:pointnet", ratio=0.7, value=4.0),
            TenantSpec(
                "paper:resmlp",
                ratio=0.5,
                arrival=ArrivalSpec(kind="sporadic", jitter=0.2),
                value=2.0,
            ),
            TenantSpec(
                "paper:deit_t",
                ratio=0.25,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.3),
                value=0.4,
                overdrive=5.0,
            ),
        ),
    )
)

register(
    TrafficScenario(
        name="sharded_city",
        description=(
            "Four periodic city tenants, comfortably provisioned and "
            "contract-honouring — the sharded-gateway conformance "
            "scenario (placement policies partition it across K "
            "pipeline shards)"
        ),
        tenants=(
            TenantSpec("paper:pointnet", ratio=0.45, value=3.0),
            TenantSpec("paper:mlp_mixer", ratio=0.35, value=1.0),
            TenantSpec("paper:resmlp", ratio=0.3, value=2.0),
            TenantSpec("paper:deit_t", ratio=0.25, value=1.5),
        ),
    )
)

register(
    TrafficScenario(
        name="av_stack",
        description=(
            "AV mixed-criticality stack: safety-critical LiDAR + camera "
            "perception (HI) sharing the pipeline with a best-effort "
            "infotainment tenant (LO) overdriven 5x past its "
            "provisioning — the mode-switch conformance scenario "
            "(overdriven, so it stays out of DEFAULT_SCENARIOS)"
        ),
        tenants=(
            TenantSpec(
                "paper:pointnet",
                ratio=0.55,
                value=5.0,
                criticality=CRITICALITY_HI,
                name="lidar_perception",
            ),
            TenantSpec(
                "paper:deit_t",
                ratio=0.3,
                value=3.0,
                criticality=CRITICALITY_HI,
                name="camera_monitor",
            ),
            TenantSpec(
                "paper:mlp_mixer",
                ratio=0.25,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.3),
                value=0.5,
                overdrive=5.0,
                criticality=CRITICALITY_LO,
                name="infotainment",
            ),
        ),
    )
)

register(
    TrafficScenario(
        name="overload_2x",
        description=(
            "Deliberate 2x overdrive on the camera tenant: traffic "
            "arrives at twice the provisioned rate, contradicting the "
            "analysis — the shedding-policy stress scenario"
        ),
        tenants=(
            TenantSpec("paper:pointnet", ratio=0.8, value=3.0),
            TenantSpec(
                "paper:mlp_mixer",
                ratio=0.7,
                arrival=ArrivalSpec(kind="poisson", provision_factor=1.2),
                value=1.0,
                overdrive=2.0,
            ),
        ),
    )
)
