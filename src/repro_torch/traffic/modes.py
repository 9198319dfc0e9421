"""Mixed-criticality overload modes for the serving stack.

The shedding layer (`repro_torch.traffic.shedding`) reacts to overload one
release at a time: when a tenant's observed backlog contradicts the
analysis, the *cheapest* work is dropped or demoted, regardless of what
it is. Safety-critical deployments need the inverse contract — a
Vestal-style mixed-criticality story in the spirit of MESC's
criticality-inversion analysis and HetSched's quality-of-mission
scheduling (see PAPERS.md): tenants carry a criticality class
(`TaskRequest.criticality`, "HI"/"LO"), and overload triggers a *mode
switch* with per-class guarantees instead of a per-job value call.

`ModeController` is that state machine:

- **normal mode** — every admitted tenant keeps its Eq. 3 guarantee;
  releases flow untouched.
- **HI-mode switch** — driven by the exact `BacklogMonitor` hysteresis
  the shedding layer uses (engage when pending backlog exceeds the
  analysis-derived limit, disengage at half of it). Before the switch
  *commits*, the controller re-runs Eq. 3 admission for the surviving
  HI set on a fresh `AdmissionController` — the per-class guarantee is
  re-*proved*, not assumed; a HI tenant that fails the re-proof (e.g.
  under a tightened `hi_util_cap`) is excluded from the survivor set
  and handled like LO work. While in HI mode every LO release is shed
  (``action="drop"``) or demoted to best-effort (``action="degrade"``),
  and the gateway tightens LO rate limiting (`release_cost`).
- **symmetric recovery** — when every tenant's backlog has drained
  below the disengage threshold, the controller re-proves the full
  guaranteed set and switches back to normal mode.

The controller implements the same duck type the DES's release-time
shedding hook consumes (`observe`/`engaged`/`classify`, see
`repro_torch.scheduler.des.ReleaseShedding`), so one object serves as
``SimConfig.shedding`` in the DES and as ``TrafficGateway(modes=...)``
in the runtime; `run_mode_switch_case` in the conformance harness
checks the two layers agree on the survivor set and that HI tenants
miss zero deadlines across every transition. Mode transitions are
recorded in `switches` and drained (`drain_events`) by the host layer,
which stamps the current time and emits the ``mode_switch`` trace kind.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.traffic.admission import (
    CRITICALITY_HI,
    CRITICALITY_LO,
    AdmissionController,
    TaskRequest,
)
from repro_torch.traffic.shedding import (
    BEST_EFFORT,
    DROP,
    SUBMIT,
    BacklogMonitor,
)

#: the two overload modes (extensible in the same way the criticality
#: levels are: one mode per shed threshold)
MODE_NORMAL = "normal"
MODE_HI = "hi"
MODES = (MODE_NORMAL, MODE_HI)

#: LO-handling verdicts a controller may apply while in HI mode
MODE_ACTIONS = ("drop", "degrade")


@dataclass(frozen=True)
class ModeSwitch:
    """One committed mode transition.

    ``survivors`` is the guarantee set *after* the transition: the
    re-proved HI tenants on a switch into HI mode, the full guaranteed
    set on recovery. ``max_util`` / ``schedulable`` are the Eq. 3
    re-proof that gated the commit (`AdmissionController.check` on a
    fresh controller).
    """

    mode: str
    survivors: tuple[str, ...]
    max_util: float
    schedulable: bool


class ModeController:
    """Criticality-aware overload-mode state machine (module docstring).

    ``admission`` supplies the analysis context (overheads, preemption
    model, response bounds for the backlog limits); ``requests`` are
    the tenant contracts in task-index order — the same order the DES
    and the gateway index tasks by. ``action`` picks the LO fate in HI
    mode; ``hi_util_cap`` optionally tightens the Eq. 3 cap the HI
    re-proof must meet; ``lo_release_cost`` is the token-bucket cost
    multiplier the gateway charges LO releases while in HI mode.
    """

    def __init__(
        self,
        admission: AdmissionController,
        requests,
        *,
        monitor: BacklogMonitor | None = None,
        action: str = "degrade",
        hi_util_cap: float | None = None,
        lo_release_cost: float = 2.0,
        bound_policy: str | None = None,
    ):
        if action not in MODE_ACTIONS:
            raise ValueError(
                f"unknown mode action {action!r}; have {MODE_ACTIONS}"
            )
        if lo_release_cost < 1.0:
            raise ValueError("lo_release_cost must be >= 1.0")
        self.admission = admission
        self.requests: tuple[TaskRequest, ...] = tuple(requests)
        self.monitor = monitor or BacklogMonitor()
        self.action = action
        self.hi_util_cap = hi_util_cap
        self.lo_release_cost = lo_release_cost
        self.bound_policy = bound_policy
        self.mode = MODE_NORMAL
        self.switches: list[ModeSwitch] = []
        self._survivors: frozenset[str] = frozenset()
        self._pending: list[ModeSwitch] = []
        self._limits: tuple[int, ...] | None = None

    # -- identity (SheddingPolicy-compatible surface) -------------------
    @property
    def name(self) -> str:
        return f"mode_{self.action}"

    @property
    def drops(self) -> bool:
        """Whether HI mode removes LO work (vs demoting it)."""
        return self.action == "drop"

    @property
    def engaged(self) -> dict[int, bool]:
        """Per-task hysteresis state (the DES reads this dict)."""
        return self.monitor.engaged

    @property
    def survivors(self) -> tuple[str, ...]:
        """The current guarantee set, admission order."""
        if self.mode == MODE_NORMAL:
            return tuple(r.name for r in self._guaranteed())
        return tuple(
            r.name for r in self._guaranteed() if r.name in self._survivors
        )

    # -- the backlog-driven state machine -------------------------------
    def limits(self) -> tuple[int, ...]:
        """Analysis-derived engage limits, one per task (lazy: response
        bounds need the admitted set, which the gateway only commits at
        `open`)."""
        if self._limits is None:
            bounds = self.admission.response_bounds(self.bound_policy)
            self._limits = tuple(
                self.monitor.limit_for(
                    bounds.get(r.name, math.inf), r.period
                )
                for r in self.requests
            )
        return self._limits

    def observe(self, task_idx: int, pending: int) -> bool:
        """Feed one backlog observation; commit any resulting mode
        transition. Same signature the DES's shedding hook uses."""
        on = self.monitor.observe(task_idx, pending, self.limits()[task_idx])
        self._maybe_transition()
        return on

    def _any_engaged(self) -> bool:
        eng = self.monitor.engaged
        return any(eng.get(i, False) for i in range(len(self.requests)))

    def _guaranteed(self) -> list[TaskRequest]:
        return [r for r in self.requests if not r.best_effort]

    def _prove(self, requests) -> tuple[tuple[str, ...], float, bool]:
        """Eq. 3 re-proof: greedily re-admit ``requests`` on a fresh
        controller. Returns (admitted names, max stage util, all fit)."""
        ctl = AdmissionController(
            self.admission.overheads,
            preemptive=self.admission.preemptive,
            util_cap=(
                self.hi_util_cap
                if self.hi_util_cap is not None
                else self.admission.util_cap
            ),
        )
        names, all_fit = [], True
        for r in requests:
            if ctl.admit(r).admitted:
                names.append(r.name)
            else:
                all_fit = False
        utils = ctl.utilizations()
        return tuple(names), (max(utils) if utils else 0.0), all_fit

    def _maybe_transition(self) -> None:
        overloaded = self._any_engaged()
        if self.mode == MODE_NORMAL and overloaded:
            # re-prove Eq. 3 for the HI set *before* the switch commits
            hi = [
                r
                for r in self._guaranteed()
                if r.criticality == CRITICALITY_HI
            ]
            names, max_util, all_fit = self._prove(hi)
            self.mode = MODE_HI
            self._survivors = frozenset(names)
            sw = ModeSwitch(
                mode=MODE_HI,
                survivors=names,
                max_util=max_util,
                schedulable=all_fit,
            )
            self.switches.append(sw)
            self._pending.append(sw)
        elif self.mode == MODE_HI and not overloaded:
            # symmetric recovery: the full guaranteed set is re-proved
            # and restored
            names, max_util, all_fit = self._prove(self._guaranteed())
            self.mode = MODE_NORMAL
            self._survivors = frozenset()
            sw = ModeSwitch(
                mode=MODE_NORMAL,
                survivors=names,
                max_util=max_util,
                schedulable=all_fit,
            )
            self.switches.append(sw)
            self._pending.append(sw)

    def drain_events(self) -> list[ModeSwitch]:
        """Transitions committed since the last drain — the host layer
        (DES / gateway) stamps its clock and emits ``mode_switch``."""
        out, self._pending = self._pending, []
        return out

    # -- per-release verdicts -------------------------------------------
    def classify(
        self, task_idx: int, overloaded=(), admission=None, requests=None
    ) -> str:
        """Release verdict for ``task_idx`` under the current mode.

        Signature-compatible with both the DES shedding hook
        (positional ``overloaded``) and `SheddingPolicy.classify`; the
        verdict depends only on the committed mode and the survivor
        set, never on which tenant happens to be overloaded.
        """
        if self.mode != MODE_HI:
            return SUBMIT
        r = self.requests[task_idx]
        if not r.best_effort and r.name in self._survivors:
            return SUBMIT
        return DROP if self.action == "drop" else BEST_EFFORT

    def release_cost(self, task_idx: int) -> float:
        """Token-bucket cost of one release — the gateway's HI-mode
        rate tightening: LO releases pay ``lo_release_cost`` tokens
        while HI mode holds, halving (by default) their sustained
        rate; survivors always pay 1."""
        if self.mode != MODE_HI:
            return 1.0
        r = self.requests[task_idx]
        if not r.best_effort and r.name in self._survivors:
            return 1.0
        return self.lo_release_cost


def criticality_counts(requests) -> dict[str, int]:
    """Tenant count per criticality level (reporting helper)."""
    out = {CRITICALITY_HI: 0, CRITICALITY_LO: 0}
    for r in requests:
        out[r.criticality] = out.get(r.criticality, 0) + 1
    return out
