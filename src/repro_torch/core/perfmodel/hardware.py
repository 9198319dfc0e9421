"""Hardware constants for the target platform (TPU v5e).

The same constants feed (a) the DSE/scheduling latency model and (b) the
roofline analysis in EXPERIMENTS.md §Roofline, so the two are consistent
by construction.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TPUChip:
    """One TPU chip (v5e numbers per the assignment brief)."""

    peak_flops: float = 197e12  # bf16 FLOP/s
    hbm_bw: float = 819e9  # bytes/s
    ici_bw: float = 50e9  # bytes/s per link
    hbm_bytes: float = 16e9  # capacity
    vmem_bytes: float = 64 * 2**20  # usable VMEM budget for kernel tiling
    mxu_dim: int = 128  # systolic array edge
    #: sustained fraction of peak for well-shaped GEMMs (MXU pipeline,
    #: weight-stationary refill, XLA overheads)
    mxu_eff: float = 0.85
    #: fixed per-layer dispatch/launch overhead, seconds
    dispatch_s: float = 2e-6


@dataclass(frozen=True)
class Platform:
    """A partitionable pool of identical chips (the DSE resource budget).

    The paper's resource vector R = (AIE, on-chip mem, on-chip BW, DDR BW)
    collapses on TPU to whole chips (each chip brings its own HBM/VMEM
    bandwidth) plus the per-stage block-shape choice; `DESIGN.md` §2
    records this adaptation.
    """

    name: str
    total_chips: int
    chip: TPUChip = TPUChip()

    def __post_init__(self) -> None:
        if self.total_chips < 1:
            raise ValueError("platform needs at least one chip")


TPU_V5E = TPUChip()

#: Full production pod — the multi-pod dry-run target (16x16 per pod).
POD_PLATFORM = Platform(name="v5e-pod", total_chips=256)


def paper_platform(total_chips: int = 16) -> Platform:
    """Small slice used for the paper-reproduction benchmarks.

    The paper's VCK5000 hosts <=4 accelerators; a 16-chip slice with
    max_M=4 reproduces the same partition-granularity regime.
    """
    return Platform(name=f"v5e-slice-{total_chips}", total_chips=total_chips)
