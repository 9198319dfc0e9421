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


def mamba_scan_backward_plain(dt, B, C, x, A, h0, dy, dh_final=None, *,
                              chunk: int = 64):
    """Gradient of the selective scan, chunk by chunk in fp32.

    dt, x, dy: (Bb, S, di); B, C: (Bb, S, ns); A: (di, ns); h0 and
    dh_final (the cotangent of h_final, zero when None): (Bb, di, ns).
    With a_t = exp(dt_t A) and g_t the adjoint of h_t (g_{S-1} =
    dh_final + dy_{S-1} C_{S-1}, g_t = a_{t+1} g_{t+1} + dy_t C_t):

        dx_t  = dt_t sum_n g_t B_t
        ddt_t = sum_n g_t h_{t-1} a_t A + x_t sum_n g_t B_t
        dB_t  = sum_d g_t dt_t x_t,   dC_t = sum_d h_t dy_t
        dA    = sum over b, t of g_t h_{t-1} a_t dt_t
        dh0   = a_0 g_0

    The forward keeps h at each chunk start; each chunk's states and
    adjoints are inclusive scans (`_inclusive_scan`, the adjoints' on the
    time-reversed chunk), chained by the carried h and g. Returns (ddt,
    dB, dC, dx, dA, dh0), float32.
    """
    S = x.shape[1]
    c = chunk_size(chunk, S)
    dt, B, C, x, A, h, dy = (t.float() for t in (dt, B, C, x, A, h0, dy))
    starts = []
    for c0 in range(0, S, c):
        starts.append(h)
        sl = slice(c0, c0 + c)
        a = torch.exp(dt[:, sl, :, None] * A)
        b = (dt[:, sl] * x[:, sl])[..., None] * B[:, sl, None, :]
        aa, bb = _inclusive_scan(a, b)
        h = bb[:, -1] + aa[:, -1] * h
    # g_S := dh_final, a_S := 1: the carry into each chunk from the next
    q = (torch.zeros_like(h) if dh_final is None else dh_final.float())
    a_next = torch.ones_like(h)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.zeros_like(A)
    for ci in reversed(range(len(starts))):
        sl = slice(ci * c, ci * c + c)
        dt_c, x_c, B_c, C_c, dy_c = (t[:, sl] for t in (dt, x, B, C, dy))
        a = torch.exp(dt_c[..., None] * A)  # (Bb, c, di, ns)
        b = (dt_c * x_c)[..., None] * B_c[:, :, None, :]
        aa, bb = _inclusive_scan(a, b)
        hs = bb + aa * starts[ci][:, None]  # h_t
        h_prev = torch.cat([starts[ci][:, None], hs[:, :-1]], dim=1)
        # reversed chunk: g'_s = m_s g'_{s-1} + dy C, m_s = a_{t+1}
        m = torch.cat([a[:, 1:], a_next[:, None]], dim=1).flip(1)
        e = (dy_c[..., None] * C_c[:, :, None, :]).flip(1)
        mm, ee = _inclusive_scan(m, e)
        g = (ee + mm * q[:, None]).flip(1)  # g_t
        q, a_next = g[:, 0], a[:, 0]
        gB = torch.einsum("bcdn,bcn->bcd", g, B_c)
        gpa = g * h_prev * a
        dx[:, sl] = dt_c * gB
        ddt[:, sl] = torch.einsum("bcdn,dn->bcd", gpa, A) + x_c * gB
        dB[:, sl] = torch.einsum("bcdn,bcd->bcn", g, dt_c * x_c)
        dC[:, sl] = torch.einsum("bcdn,bcd->bcn", hs, dy_c)
        dA += torch.einsum("bcdn,bcd->dn", gpa, dt_c)
        del a, b, aa, bb, hs, h_prev, m, e, mm, ee, g, gpa
    return ddt, dB, dC, dx, dA, a_next * q
