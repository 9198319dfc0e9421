"""Plain PyTorch version of the selective scan, and a step-by-step
oracle.

`mamba_scan_plain` is the chunked form of ``repro.models.ssm._mamba_impl``
and ``repro.kernels.mamba_scan.ref``: within a chunk the diagonal affine
recurrence ``h_t = a_t h_{t-1} + b_t`` runs as an inclusive scan under

    (a_l, b_l) o (a_r, b_r) = (a_l a_r, b_l a_r + b_r),

here a log-depth (Hillis-Steele) scan, and chunks are chained by the
carried ``h``. No ``exp(-cumsum)`` rescale is used: ``dt * A`` can be
large and negative, and such a rescale overflows. It is what
`mamba_scan_call` runs for CPU tensors and what the CUDA kernel is held
against on the card. Peak memory is a few ``(Bb, chunk, di, ns)`` fp32
tensors.
"""
from __future__ import annotations

import torch


def chunk_size(chunk: int, S: int) -> int:
    """The chunk the model uses for length S: ``min(chunk, S)`` halved
    until it divides S."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


def _inclusive_scan(a, b):
    """Hillis-Steele inclusive scan of (a, b) along dim 1 under the
    combine above: after the step at offset ``off``, element t holds the
    composition of elements ``t - 2*off + 1 .. t``."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def mamba_scan_plain(dt, B, C, x, A, h0, *, chunk: int = 64):
    """dt, x: (Bb, S, di); B, C: (Bb, S, ns); A: (di, ns); h0: (Bb, di, ns).

    ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = sum_n h_t C_t``.
    Returns (y (Bb, S, di), h_final (Bb, di, ns)), both float32.
    """
    S = x.shape[1]
    c = chunk_size(chunk, S)
    dt, B, C, x, A, h = (t.float() for t in (dt, B, C, x, A, h0))
    ys = []
    for start in range(0, S, c):
        sl = slice(start, start + c)
        dt_c = dt[:, sl]
        a = torch.exp(dt_c[..., None] * A)  # (Bb, c, di, ns)
        b = (dt_c * x[:, sl])[..., None] * B[:, sl, None, :]
        aa, bb = _inclusive_scan(a, b)
        hs = bb + aa * h[:, None]
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_scan_steps(dt, B, C, x, A, h0):
    """The recurrence one step at a time, in float64: the tests' oracle.
    Returns (y, h_final) as float32."""
    dt, B, C, x, A, h = (t.double() for t in (dt, B, C, x, A, h0))
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (
            (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        )
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1).float(), h.float()
