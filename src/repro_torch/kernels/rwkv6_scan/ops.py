"""Public API for the RWKV-6 WKV scan."""
from __future__ import annotations

from repro_torch.kernels.rwkv6_scan.kernel import MAX_CHUNK, rwkv6_scan_call

DEFAULT_CHUNK = MAX_CHUNK


def rwkv6_scan(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK):
    """WKV-6 recurrence over (B, S, H, hd) tensors from a zero state.

    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``;
    ``y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)``.
    Returns (y (B, S, H, hd) fp32, S_final (B, H, hd, hd) fp32).
    ``chunk`` is the plain (CPU) version's chunk length, at most 64.
    """
    return rwkv6_scan_call(r, k, v, w, u, chunk=chunk)
