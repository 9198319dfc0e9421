"""Public API for the preemptible matmul (window wrappers + progress
model).

A *job segment* on an accelerator is a chain of GEMMs; each GEMM is a
sequence of tile windows. `MatmulProgress` is the on-host progress-table
entry (paper Fig. 2): the flat index of the next unexecuted tile. The
serving scheduler (repro_torch.pipeline.serve) preempts by simply not
issuing the next window and running another job's window instead.

The functions run where their tensors are: on the card through the
CUDA kernel, on the CPU through its plain version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels.preemptible_matmul.kernel import matmul_window_call

DEFAULT_BLOCK = (128, 128, 128)


def grid_geometry(M: int, N: int, K: int, block: tuple[int, int, int]):
    """(n_tiles_m, n_tiles_n, k_steps, total_tiles); dims must divide."""
    bm, bk, bn = block
    if M % bm or N % bn or K % bk:
        raise ValueError(
            f"shape ({M},{K},{N}) not divisible by block {block}; "
            "pad operands first (pad_operands)"
        )
    n_m, n_n, k_steps = M // bm, N // bn, K // bk
    return n_m, n_n, k_steps, n_m * n_n


def pick_window(total_tiles: int, requested: int) -> int:
    """Largest divisor of ``total_tiles`` that is <= requested.

    Windows must tile the grid exactly so every (start, window) call
    covers in-range tiles only.
    """
    w = max(1, min(requested, total_tiles))
    while total_tiles % w:
        w -= 1
    return w


def pad_operands(a, b, block: tuple[int, int, int]):
    """Zero-pad (a, b) up to block multiples; returns (a, b, unpad_fn)."""
    bm, bk, bn = block
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError("inner dims disagree")
    Mp = math.ceil(M / bm) * bm
    Kp = math.ceil(K / bk) * bk
    Np = math.ceil(N / bn) * bn
    ap = F.pad(a, (0, Kp - K, 0, Mp - M))
    bp = F.pad(b, (0, Np - N, 0, Kp - K))
    return ap, bp, lambda c: c[:M, :N]


@dataclass
class MatmulProgress:
    """Progress-table entry for one in-flight GEMM (paper Fig. 2)."""

    next_tile: int
    total_tiles: int

    @property
    def done(self) -> bool:
        return self.next_tile >= self.total_tiles

    @property
    def fraction(self) -> float:
        return self.next_tile / self.total_tiles


def matmul_window(
    a,
    b,
    c_acc,
    start: int,
    *,
    block=DEFAULT_BLOCK,
    window_tiles: int = 8,
):
    """Run one window of output tiles starting at flat index ``start``.

    Returns ``(c_acc, next_tile)``; ``c_acc`` (fp32, block-multiple
    shape) is updated in place. The caller owns scheduling: to preempt,
    simply stop calling; to resume, call again with the saved
    ``next_tile``.
    """
    M, K = a.shape
    _, N = b.shape
    _, n_n, k_steps, total = grid_geometry(M, N, K, block)
    w = pick_window(total, window_tiles)
    c_acc = matmul_window_call(
        start,
        a,
        b,
        c_acc,
        block=block,
        window=w,
        n_tiles_n=n_n,
        k_steps=k_steps,
    )
    return c_acc, min(start + w, total)


def matmul_resumable(
    a,
    b,
    *,
    block=DEFAULT_BLOCK,
    window_tiles: int = 8,
    start_tile: int = 0,
    max_windows: int | None = None,
    c_acc=None,
):
    """Run (part of) ``a @ b`` window by window.

    Returns ``(c_acc, progress)``; run to completion when
    ``max_windows`` is None. Restart by passing the previous ``c_acc``
    (updated in place) and ``progress.next_tile``.
    """
    M, K = a.shape
    _, N = b.shape
    _, _, _, total = grid_geometry(M, N, K, block)
    w = pick_window(total, window_tiles)
    if c_acc is None:
        c_acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    tile = start_tile
    steps = 0
    while tile < total and (max_windows is None or steps < max_windows):
        c_acc, tile = matmul_window(
            a, b, c_acc, tile, block=block, window_tiles=w
        )
        steps += 1
    return c_acc, MatmulProgress(next_tile=tile, total_tiles=total)


def matmul(a, b, *, block=DEFAULT_BLOCK, window_tiles: int = 64):
    """Plain full matmul through the preemptible kernel (for testing)."""
    c, prog = matmul_resumable(a, b, block=block, window_tiles=window_tiles)
    if not prog.done:
        raise RuntimeError("matmul stopped before its last tile")
    return c
