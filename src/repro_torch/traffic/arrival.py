"""Arrival models: how jobs actually reach a PHAROS deployment.

The paper's analysis (Eqs. 2–3) assumes periodic/sporadic releases with
a known minimum inter-arrival; live traffic is messier. Every generator
here implements one `ArrivalProcess` protocol:

- ``arrivals(horizon)``   — release times in ``[0, horizon)``, sorted.
  Deterministic: the same (params, seed) always produce the same trace,
  and extending the horizon only appends (prefix-stable), so DES runs,
  gateway runs and benchmarks all see the same traffic.
- ``mean_rate()``         — long-run jobs/second.
- ``analysis_period()``   — the inter-arrival bound handed to the Eq. 2
  utilization accounting. For periodic/sporadic traffic this is exact
  (the minimum gap). Poisson/MMPP traffic has *no* minimum gap, so the
  admission layer provisions for ``provision_factor`` times the mean
  rate (MMPP: the peak-state rate) — a documented heuristic, with the
  overload-shedding layer as the safety net for the residual tail risk.

Generators: `PeriodicArrivals`, `SporadicArrivals` (min inter-arrival +
optional random extra gap), `PoissonArrivals`, `MMPPArrivals` (2-state
Markov-modulated Poisson — the bursty model), `TraceArrivals` (replay).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable


@runtime_checkable
class ArrivalProcess(Protocol):
    def arrivals(self, horizon: float) -> list[float]: ...

    def mean_rate(self) -> float: ...

    def analysis_period(self) -> float: ...


@dataclass(frozen=True)
class PeriodicArrivals:
    """Strictly periodic releases: ``phase + n * period``."""

    period: float
    phase: float = 0.0

    def __post_init__(self) -> None:
        if self.period <= 0:
            raise ValueError("period must be positive")

    def arrivals(self, horizon: float) -> list[float]:
        out, t = [], self.phase
        while t < horizon:
            out.append(t)
            t += self.period
        return out

    def mean_rate(self) -> float:
        return 1.0 / self.period

    def analysis_period(self) -> float:
        return self.period


@dataclass(frozen=True)
class SporadicArrivals:
    """Sporadic releases: gaps of ``min_gap`` plus an exponential extra
    gap of mean ``jitter * min_gap``. ``jitter == 0`` degenerates to
    exactly periodic (gap == min_gap), which is what ties the sporadic
    model back to the paper's periodic analysis."""

    min_gap: float
    jitter: float = 0.0
    phase: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.min_gap <= 0:
            raise ValueError("min_gap must be positive")
        if self.jitter < 0:
            raise ValueError("jitter must be non-negative")

    def arrivals(self, horizon: float) -> list[float]:
        rng = random.Random(self.seed)
        out, t = [], self.phase
        while t < horizon:
            out.append(t)
            extra = (
                rng.expovariate(1.0 / (self.jitter * self.min_gap))
                if self.jitter > 0
                else 0.0
            )
            t += self.min_gap + extra
        return out

    def mean_rate(self) -> float:
        return 1.0 / (self.min_gap * (1.0 + self.jitter))

    def analysis_period(self) -> float:
        return self.min_gap


@dataclass(frozen=True)
class PoissonArrivals:
    """Memoryless arrivals at ``rate`` jobs/s (exponential gaps)."""

    rate: float
    phase: float = 0.0
    seed: int = 0
    #: utilization is provisioned for rate * provision_factor (Poisson
    #: has no minimum gap; see module docstring)
    provision_factor: float = 1.5

    def __post_init__(self) -> None:
        if self.rate <= 0:
            raise ValueError("rate must be positive")
        if self.provision_factor < 1.0:
            raise ValueError("provision_factor must be >= 1")

    def arrivals(self, horizon: float) -> list[float]:
        rng = random.Random(self.seed)
        out, t = [], self.phase + rng.expovariate(self.rate)
        while t < horizon:
            out.append(t)
            t += rng.expovariate(self.rate)
        return out

    def mean_rate(self) -> float:
        return self.rate

    def analysis_period(self) -> float:
        return 1.0 / (self.rate * self.provision_factor)


@dataclass(frozen=True)
class MMPPArrivals:
    """2-state Markov-modulated Poisson process — the bursty model.

    The process alternates between a *calm* state (Poisson at
    ``rates[0]``) and a *burst* state (Poisson at ``rates[1]``), with
    exponential dwell times of mean ``dwells[s]`` seconds. Utilization
    is provisioned for the burst-state rate: bursts shorter than the
    response-time scale then stay inside the analysis, and sustained
    bursts beyond it are the shedding layer's problem by construction.
    """

    rates: tuple[float, float]
    dwells: tuple[float, float]
    phase: float = 0.0
    seed: int = 0
    provision_factor: float = 1.0  # applied to the burst-state rate

    def __post_init__(self) -> None:
        if len(self.rates) != 2 or len(self.dwells) != 2:
            raise ValueError("MMPP needs exactly two states")
        if min(self.rates) < 0 or max(self.rates) <= 0:
            raise ValueError("rates must be non-negative, one positive")
        if min(self.dwells) <= 0:
            raise ValueError("dwell times must be positive")

    def arrivals(self, horizon: float) -> list[float]:
        rng = random.Random(self.seed)
        out: list[float] = []
        t, state = self.phase, 0
        state_end = t + rng.expovariate(1.0 / self.dwells[0])
        while t < horizon:
            rate = self.rates[state]
            if rate <= 0:
                t = state_end
            else:
                nxt = t + rng.expovariate(rate)
                if nxt < state_end:
                    t = nxt
                    if t < horizon:
                        out.append(t)
                    continue
                t = state_end
            state = 1 - state
            state_end = t + rng.expovariate(1.0 / self.dwells[state])
        return out

    def mean_rate(self) -> float:
        d0, d1 = self.dwells
        return (self.rates[0] * d0 + self.rates[1] * d1) / (d0 + d1)

    def peak_rate(self) -> float:
        return max(self.rates)

    def analysis_period(self) -> float:
        return 1.0 / (self.peak_rate() * self.provision_factor)


@dataclass(frozen=True)
class TraceArrivals:
    """Replay recorded release times (e.g. a production trace)."""

    times: tuple[float, ...]
    #: optional provisioned period for the analysis; 0 -> min gap
    provisioned_period: float = 0.0

    def __post_init__(self) -> None:
        ts = tuple(float(t) for t in self.times)
        if any(t < 0 for t in ts):
            raise ValueError("trace times must be non-negative")
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("trace times must be non-decreasing")
        object.__setattr__(self, "times", ts)

    def arrivals(self, horizon: float) -> list[float]:
        return [t for t in self.times if t < horizon]

    def mean_rate(self) -> float:
        if len(self.times) < 2:
            return 0.0
        span = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / span if span > 0 else math.inf

    def analysis_period(self) -> float:
        if self.provisioned_period > 0:
            return self.provisioned_period
        if len(self.times) < 2:
            return math.inf
        gap = min(b - a for a, b in zip(self.times, self.times[1:]))
        return gap if gap > 0 else 0.0


def merge_arrivals(
    processes: Sequence[ArrivalProcess], horizon: float
) -> list[tuple[float, int]]:
    """Interleave per-task traces into one sorted release schedule of
    ``(time, task_index)`` — ties release lower task indices first."""
    sched = [
        (t, i)
        for i, p in enumerate(processes)
        for t in p.arrivals(horizon)
    ]
    sched.sort()
    return sched
