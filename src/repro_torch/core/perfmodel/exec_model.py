"""Layer/stage latency model — the TPU analogue of CHARM's Exec() (Eq. 1).

An accelerator (stage) is ``AccDesign(chips, block)``. A GEMM layer
``(M, K, N)`` executes output-stationary: the ``M x N`` output is tiled
into ``(bm, bn)`` tiles, each accumulated over ``ceil(K/bk)`` k-steps;
tiles are distributed across the stage's chips. Latency is

    max(compute, hbm, ici) + dispatch

where compute includes MXU-alignment efficiency (padding waste when a
dimension does not fill the block/MXU) — this is what penalizes
shape-mismatched accelerators in the DSE exactly like the paper's
"inefficient partition" children (paper Fig. 5C/D discussion).

Preemption overhead terms (Eq. 5) come from the same block shape:
``e_tile`` = one k-step of one tile, ``e_store`` = spilling the fp32
partial tile to HBM, ``e_load`` = reloading operand + partial buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

from repro_torch.core.perfmodel.hardware import TPUChip, TPU_V5E
from repro_torch.core.rt.task import LayerDesc

#: candidate Pallas block shapes (bm, bk, bn); all K/N are lane-aligned
#: (multiples of 128), bm may drop to sublane granularity for small-M
#: workloads at proportional MXU-efficiency cost.
BLOCK_CANDIDATES: tuple[tuple[int, int, int], ...] = (
    (32, 128, 128),
    (64, 128, 128),
    (128, 128, 128),
    (128, 128, 256),
    (128, 256, 128),
    (256, 128, 128),
    (256, 128, 256),
    (256, 256, 256),
    (512, 128, 256),
    (512, 256, 512),
)

_ACC_BYTES = 4  # fp32 partial accumulator


def vmem_bytes_for_block(
    block: tuple[int, int, int], dtype_bytes: int = 2
) -> int:
    """Double-buffered operand tiles + fp32 accumulator tile."""
    bm, bk, bn = block
    return 2 * dtype_bytes * (bm * bk + bk * bn) + _ACC_BYTES * bm * bn


@dataclass(frozen=True)
class AccDesign:
    """One PHAROS accelerator realized as a TPU stage."""

    chips: int
    block: tuple[int, int, int] = (128, 128, 128)
    chip: TPUChip = TPU_V5E

    def __post_init__(self) -> None:
        if self.chips < 1:
            raise ValueError("stage needs >= 1 chip")
        if vmem_bytes_for_block(self.block) > self.chip.vmem_bytes:
            raise ValueError(f"block {self.block} exceeds VMEM budget")


def _mxu_eff(block: tuple[int, int, int], chip: TPUChip) -> float:
    """Fraction of MXU peak a (bm,bk,bn)-blocked GEMM can sustain."""
    bm, bk, bn = block
    d = chip.mxu_dim
    fill = min(bm, d) / d * min(bk, d) / d * min(bn, d) / d
    return chip.mxu_eff * fill


@lru_cache(maxsize=1 << 20)
def _latency_cached(
    M: int,
    K: int,
    N: int,
    flops: float,
    bytes_rw: float,
    dtype_bytes: int,
    chips: int,
    block: tuple[int, int, int],
) -> float:
    chip = TPU_V5E
    bm, bk, bn = block
    m_tiles = math.ceil(M / bm)
    n_tiles = math.ceil(N / bn)
    k_steps = math.ceil(K / bk)
    tiles = m_tiles * n_tiles
    tiles_per_chip = math.ceil(tiles / chips)

    # --- compute term: padded-tile flops at block-limited MXU rate ---
    eff = _mxu_eff(block, chip)
    tile_step_flops = 2.0 * bm * bk * bn
    compute = tiles_per_chip * k_steps * tile_step_flops / (chip.peak_flops * eff)
    # non-GEMM extra flops (e.g. softmax/scan) ride on the vector unit at
    # ~1/8 of MXU peak; LayerDesc.flops overrides account for them.
    gemm_flops = 2.0 * M * K * N
    if flops > gemm_flops:
        compute += (flops - gemm_flops) / (chips * chip.peak_flops * 0.125)

    # --- HBM term: per-chip operand/result traffic ---
    if bytes_rw > 0:
        hbm = bytes_rw / (chips * chip.hbm_bw)
    else:
        per_chip = dtype_bytes * (
            tiles_per_chip * k_steps * (bm * bk + bk * bn)
            + tiles_per_chip * bm * bn
        )
        hbm = per_chip / chip.hbm_bw

    # --- ICI term: activation scatter/gather across the stage ---
    ici = 0.0
    if chips > 1:
        moved = dtype_bytes * (M * K + M * N) * (chips - 1) / chips
        ici = moved / (chips * chip.ici_bw)

    return max(compute, hbm, ici) + chip.dispatch_s


def layer_latency(layer: LayerDesc, acc: AccDesign) -> float:
    """``bl_{i,j} = Exec(l_{i,j}, acc)`` in seconds (paper Eq. 1)."""
    return _latency_cached(
        layer.M,
        layer.K,
        layer.N,
        layer.gemm_flops(),
        layer.bytes_rw,
        layer.dtype_bytes,
        acc.chips,
        acc.block,
    )


def segment_latency(layers: tuple[LayerDesc, ...], acc: AccDesign) -> float:
    """``b_i^k``: a task segment runs its layers back-to-back."""
    return sum(layer_latency(l, acc) for l in layers)


def preemption_overheads(acc: AccDesign) -> tuple[float, float, float]:
    """``(e_tile, e_store, e_load)`` for the stage (paper Eq. 5).

    Tile-granular preemption: the preemptor waits one k-step of the
    in-flight tile, the fp32 partial tile spills to HBM, and resume
    reloads both operand tiles plus the partial tile.
    """
    chip = acc.chip
    bm, bk, bn = acc.block
    eff = _mxu_eff(acc.block, chip)
    e_tile = 2.0 * bm * bk * bn / (chip.peak_flops * eff)
    e_store = _ACC_BYTES * bm * bn / chip.hbm_bw + chip.dispatch_s
    e_load = (
        2 * (bm * bk + bk * bn) + _ACC_BYTES * bm * bn
    ) / chip.hbm_bw + chip.dispatch_s
    return (e_tile, e_store, e_load)


def xi(acc: AccDesign) -> float:
    """Total preemption overhead ``xi^k`` (Eq. 5)."""
    return sum(preemption_overheads(acc))
