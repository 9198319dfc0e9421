"""Plain PyTorch version and oracles of the preemptible matmul.

The serving path is exact fp32: both TF32 switches are stated and set
off here, so a float32 product on the card runs in full float32 like
the kernel it is compared with (TF32 keeps about three decimal digits).
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def matmul_ref(a, b):
    """Full product in fp32 (the kernel accumulates in fp32)."""
    return a.float() @ b.float()


def matmul_window_ref(a, b, c_acc, start: int, window: int, block):
    """Oracle for one window: add A@B's contribution for the output
    tiles with flat index in [start, start + window), leave the rest.
    Returns a new tensor; ``c_acc`` is not modified."""
    bm, _, bn = block
    M, _ = a.shape
    _, N = b.shape
    n_m, n_n = M // bm, N // bn
    full = matmul_ref(a, b)
    out = c_acc.clone()
    for flat in range(start, min(start + window, n_m * n_n)):
        i, j = divmod(flat, n_n)
        sl = (slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn))
        out[sl] = c_acc[sl] + full[sl]
    return out


def matmul_partial_ref(a, b, upto_tile: int, block):
    """Oracle for a fresh run preempted after ``upto_tile`` tiles."""
    c0 = torch.zeros(
        (a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device
    )
    return matmul_window_ref(a, b, c0, 0, upto_tile, block)


def matmul_window_plain(a, b, c_acc, start: int, window: int, block):
    """The window the kernel computes, in plain PyTorch: adds A@B into
    output tiles ``[start, start + window)`` of ``c_acc`` **in place**
    (fp32 accumulation) and returns ``c_acc``.

    Consecutive tiles of one tile row are one strip, so a window costs
    one product per tile row it touches, and only its own FLOPs.
    """
    bm, _, bn = block
    n_n = b.shape[1] // bn
    flat, end = start, start + window
    while flat < end:
        i, j = divmod(flat, n_n)
        j_end = min(n_n, j + (end - flat))
        rows = slice(i * bm, (i + 1) * bm)
        cols = slice(j * bn, j_end * bn)
        c_acc[rows, cols] += a[rows].float() @ b[:, cols].float()
        flat += j_end - j
    return c_acc
