"""Public API for the selective scan."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import mamba_scan_call

DEFAULT_CHUNK = 64


def mamba_scan(dt, B, C, x, A, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """Selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``,
    ``y_t = <h_t, C_t>``.

    dt, x: (Bb, S, di); B, C: (Bb, S, ns); A: (di, ns); h0: (Bb, di, ns),
    zero when None. Operands are taken as contiguous float32. Returns
    (y (Bb, S, di), h_final (Bb, di, ns)), float32. ``chunk`` is the
    plain (CPU) version's chunk length, shrunk to a divisor of S as the
    JAX wrapper does; the CUDA kernel does not chunk.
    """
    if h0 is None:
        Bb, _, di = x.shape
        h0 = torch.zeros((Bb, di, A.shape[1]), dtype=torch.float32,
                         device=x.device)
    ops = (t.float().contiguous() for t in (dt, B, C, x, A, h0))
    return mamba_scan_call(*ops, chunk=chunk)
