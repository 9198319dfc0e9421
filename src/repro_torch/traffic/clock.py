"""Injectable clocks for the serving runtime.

`PharosServer` takes ``clock``/``sleep`` callables; these classes bundle
the two so one time source backs both:

- `WallClock` — real time (`time.perf_counter` / `time.sleep`); the
  production mode.
- `VirtualClock` — a manually-advanced timebase: ``sleep`` advances the
  clock instead of blocking, and the owner may charge arbitrary spans
  with ``advance`` (e.g. one modeled WCET per executed tile window).
  Runs are then deterministic and faster than real time.
"""
from __future__ import annotations

import time


class WallClock:
    """Real time."""

    def now(self) -> float:
        # rtlint: disable=clock-domain -- the WallClock implementation
        return time.perf_counter()

    def sleep(self, dt: float) -> None:
        # rtlint: disable=clock-domain -- the WallClock implementation
        time.sleep(dt)


class VirtualClock:
    """Deterministic manual timebase (starts at ``start``)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("cannot advance a clock backwards")
        self._t += dt

    def sleep(self, dt: float) -> None:  # sleeping == advancing
        self.advance(dt)
