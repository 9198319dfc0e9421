"""DSE -> serving provisioning bridge.

Before this module, a DSE result was a dead end: `beam_search` returned
`DesignPoint`s, and the serving stack (`repro_torch.traffic`) re-ran its own
search inside `traffic.scenarios.build` — DSE output never reached the
gateway, the shards, or the conformance harness. `provision` closes the
loop:

    DSE-chosen design  ->  segment table + admission contracts
                       ->  tenant -> shard plan (per-shard Eq. 3)
                       ->  `ShardedGateway` ready to serve

A `ProvisionPlan` is the deployable artifact: the materialized
`BuiltScenario` (same traffic seeds `build` would have used), the
tenant->shard `ShardPlan` (the *same* `plan_shards` path the gateway
constructor uses, so what is checked is what runs), and the per-shard
admission contracts — one `TaskRequest` tuple per shard, each of which
a per-shard `AdmissionController` re-verifies bit-exactly at `open`.

The JAX package's `repro.conformance.run_dse_case` drives this bridge
differentially: every DSE-claimed-feasible design must also be feasible
under the DES and the executing runtime, and the provisioned
`ShardedGateway` must serve the scenario's traffic with zero
violations.

Imports from `repro_torch.traffic` stay inside functions: `core` is the
bottom layer and `traffic` imports it at module scope.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dse.explore import DSEConfig, ExploreResult, explore
from repro_torch.core.dse.space import DesignPoint


@dataclass(frozen=True)
class ProvisionPlan:
    """A DSE-chosen design wired to a concrete serving deployment."""

    #: the materialized scenario (design, table, contracts, traffic)
    built: object  # BuiltScenario
    design: DesignPoint
    #: tenant -> shard assignment (`repro_torch.traffic.shard.ShardPlan`)
    plan: object
    placement: str
    policy: str
    #: per-shard admission contracts: `TaskRequest`s each shard's
    #: controller re-admits (original tenant order within the shard)
    contracts: tuple[tuple, ...]

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    def shard_utilizations(self) -> tuple[tuple[float, ...], ...]:
        """Per-shard post-admission Eq. 2 stage utilizations — the
        capacity ledger the plan hands each replica."""
        preemptive = self.policy == "edf"
        out = []
        for members in self.plan.members:
            util = [0.0] * self.design.n_stages
            for i in members:
                du = self.built.requests[i].utilization(
                    (0.0,) * self.design.n_stages, preemptive
                )
                for k in range(self.design.n_stages):
                    util[k] += du[k]
            out.append(tuple(util))
        return tuple(out)

    def admission_controllers(self):
        """One freshly-seeded `AdmissionController` per shard, loaded
        with this plan's contracts (raises if any contract does not
        fit — a provisioned plan must admit its own tenants)."""
        from repro_torch.traffic.admission import AdmissionController

        controllers = []
        for contract in self.contracts:
            ctl = AdmissionController(
                [0.0] * self.design.n_stages,
                preemptive=(self.policy == "edf"),
            )
            for req in contract:
                dec = ctl.admit(req)
                if not dec.admitted:
                    raise ValueError(
                        f"provisioned contract rejects {req.name!r}: "
                        f"{dec.reason}"
                    )
            controllers.append(ctl)
        return controllers

    def sharded_gateway(self, **kwargs):
        """Build the `ShardedGateway` this plan describes (same
        placement, same per-shard constructor path); ``kwargs`` go to
        `ShardedGateway.from_built`, ``device=`` among them."""
        from repro_torch.traffic.shard import ShardedGateway

        return ShardedGateway.from_built(
            self.built,
            shards=self.plan.n_shards,
            placement=self.placement,
            policy=self.policy,
            **kwargs,
        )


def provision(
    scenario,
    platform=None,
    *,
    design: DesignPoint | None = None,
    result: ExploreResult | None = None,
    cfg: DSEConfig | None = None,
    shards: int = 1,
    placement="least_loaded",
    policy: str | None = None,
    seed: int = 0,
) -> ProvisionPlan:
    """Provision a scenario from a DSE result.

    ``scenario`` is a `TrafficScenario` or registry name. The design
    comes from (in priority order) ``design``, ``result.best``, or a
    fresh `explore` run under ``cfg``. Returns the `ProvisionPlan`
    binding that design to a tenant->shard assignment and per-shard
    Eq. 3 admission contracts.
    """
    from repro_torch.core.perfmodel.hardware import paper_platform
    from repro_torch.traffic.scenarios import (
        get_scenario,
        materialize,
        resolve_problem,
    )
    from repro_torch.traffic.shard import plan_shards

    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    platform = platform or paper_platform(16)
    workloads, taskset = resolve_problem(scenario, platform)
    if design is None:
        if result is None:
            result = explore(workloads, taskset, platform, cfg)
        design = result.best
        if design is None:
            raise ValueError(
                f"scenario {scenario.name!r}: the DSE found no feasible "
                "design to provision"
            )
    built = materialize(scenario, workloads, taskset, design, seed=seed)
    policy = policy or scenario.policy
    placement_obj, plan = plan_shards(
        built.requests,
        shards,
        placement,
        n_stages=design.n_stages,
        preemptive=(policy == "edf"),
    )
    contracts = tuple(
        tuple(built.requests[i] for i in members)
        for members in plan.members
    )
    return ProvisionPlan(
        built=built,
        design=design,
        plan=plan,
        placement=placement_obj.name,
        policy=policy,
        contracts=contracts,
    )
