"""The port's WKV-6 scan against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages: r,
k, v normal (k scaled by 0.3), decays ``exp(-exp(logit))`` with logits
clamped to the model's ``_DECAY_CLAMP`` range, u normal x 0.1. The JAX
side runs as its own tests run it (the Pallas kernel in interpret mode,
and the step-by-step oracle ``rwkv6_scan_ref``); the port's side is its
plain chunked version, which is what its wrapper takes for CPU tensors.

Tolerance: 1e-4 of the max for y and for S_final, the reference's own
tolerance between its chunked kernel and its stepwise oracle. The
chunked forms rescale k by 1/prod(w) (here ``k / max(W, 1e-30)``, on the
TPU ``k * exp(-cumw)``), which loses a few digits against the stepwise
recurrence; they are not bit for bit.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as ref_scan
from repro.kernels.rwkv6_scan.ops import _shrink_to_divisor
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.kernel import (
    MAX_CHUNK,
    STAGE_STEPS,
    rwkv6_scan_call,
)
from repro_torch.kernels.rwkv6_scan.ref import chunk_size

torch.set_num_threads(1)

TOL = 1e-4


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, S, H, hd)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    logit = np.clip(rng.standard_normal((B, S, H, hd)), -8, -1)
    w = np.exp(-np.exp(logit)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize(
    "S,chunk", [(64, 16), (128, 32), (32, 32), (100, 64), (96, 64)]
)
def test_plain_matches_pallas_kernel_and_stepwise_oracle(S, chunk):
    arrs = _inputs(2, S, 2, 16, seed=S + chunk)
    y, s_fin = rwkv6_scan(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert y.dtype == s_fin.dtype == torch.float32
    assert y.shape == (2, S, 2, 16) and s_fin.shape == (2, 2, 16, 16)
    jarrs = [jnp.asarray(a) for a in arrs]
    for want_y, want_s in (ref_scan(*jarrs, chunk=chunk), rwkv6_scan_ref(*jarrs)):
        assert _rel(y.numpy(), want_y) <= TOL
        assert _rel(s_fin.numpy(), want_s) <= TOL


@pytest.mark.parametrize("S", [1, 7, 48, 100, 128, 1000])
def test_chunk_follows_the_model(S):
    """The plain version chunks S as the JAX model and kernel do."""
    assert chunk_size(64, S) == _shrink_to_divisor(64, S)


def test_state_carries_across_calls_as_one_scan():
    """Zero initial state: y of a prefix does not depend on the suffix,
    and the state after a prefix is that of the stepwise oracle."""
    arrs = _inputs(1, 64, 2, 16, seed=9)
    t = [torch.from_numpy(a) for a in arrs]
    y_full, _ = rwkv6_scan(*t)
    y_head, s_head = rwkv6_scan(*(x[:, :40] for x in t[:4]), t[4])
    assert _rel(y_head.numpy(), y_full[:, :40].numpy()) <= TOL
    _, s_want = rwkv6_scan_ref(*(jnp.asarray(a[:, :40]) for a in arrs[:4]),
                               jnp.asarray(arrs[4]))
    assert _rel(s_head.numpy(), s_want) <= TOL


def test_cpu_wrapper_counts_nothing_and_checks_inputs():
    t = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 16, seed=1)]
    before = rwkv6_scan_call.launches
    rwkv6_scan_call(*t)
    assert rwkv6_scan_call.launches == before
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_scan_call(*t, chunk=MAX_CHUNK * 2)
    with pytest.raises(ValueError, match="u must be"):
        rwkv6_scan_call(*t[:4], t[4][:1])
    with pytest.raises(ValueError, match="disagree"):
        rwkv6_scan_call(t[0], t[1][:, :8], t[2], t[3], t[4])


def _row_groups(hd):
    """The CUDA kernel's row groups for head width ``hd``: group g holds
    rows 4g..4g+3 and hd/2+4g..hd/2+4g+3, in that order (at hd 64 the 8
    groups of csrc/rwkv6_scan.cu, one per lane row of a compute warp)."""
    half = hd // 2
    return [[4 * g + q for q in range(4)] + [half + 4 * g + q for q in range(4)]
            for g in range(half // 4)]


def _fma(a, b, c):
    """fp32 fused multiply-add: the product and sum in float64 (exact
    product of two floats), rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order_scan(r, k, v, w, u):
    """WKV-6 in the CUDA kernel's summation order, on float32 tensors.

    Per step: the bonus ``b_t = Σ_i r_i u_i k_i`` as one FMA chain
    ``(r_i u_i) k_i`` over each row group's rows, the groups' sums added
    pairwise (the lanes' butterfly); y's partial per group as an FMA chain
    ``r_i S_{t-1}[i]`` over its rows, the groups' partials added in group
    order, then ``fma(b_t, v_t, ·)``; the state ``fma(w_i, S_{t-1}[i],
    k_i v_t)``."""
    B, S, H, hd = r.shape
    idx = torch.tensor(_row_groups(hd))  # (groups, rows)
    st = torch.zeros((B, H, hd, hd), dtype=torch.float32)
    ys = torch.empty((B, S, H, hd), dtype=torch.float32)
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, hd)
        ru, kg, rg = (rt * u)[..., idx], kt[..., idx], rt[..., idx]  # (B, H, G, R)
        sg = st[:, :, idx]  # (B, H, G, R, hd)
        bon = ru[..., 0] * kg[..., 0]
        part = rg[..., 0, None] * sg[..., 0, :]
        for j in range(1, idx.shape[1]):
            bon = _fma(ru[..., j], kg[..., j], bon)
            part = _fma(rg[..., j, None], sg[..., j, :], part)
        while bon.shape[-1] > 1:
            bon = bon[..., 0::2] + bon[..., 1::2]
        y = part[:, :, 0]
        for g in range(1, idx.shape[0]):
            y = y + part[:, :, g]
        ys[:, t] = _fma(bon, vt, y)
        st = _fma(wt[..., :, None], st, kt[..., :, None] * vt[..., None, :])
    return ys, st


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("logit", [-8.0, -1.0])
def test_kernel_summation_order_matches_stepwise_oracle(hd, logit):
    """The CUDA kernel's order of summation (bonus out of the state,
    partial y per row group summed in order), emulated on the CPU at
    S 2048 with every decay at one clamp end, against the JAX package's
    step-by-step oracle: 1e-4 of the max, the kernel's bound against the
    plain version on the card."""
    r, k, v, _, u = _inputs(1, 2048, 2, hd, seed=hd)
    w = np.full_like(r, np.exp(-np.exp(logit)), dtype=np.float32)
    y, s_fin = _kernel_order_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    want_y, want_s = rwkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, w, u)))
    assert np.isfinite(y.numpy()).all() and np.isfinite(s_fin.numpy()).all()
    assert _rel(y.numpy(), want_y) <= TOL
    assert _rel(s_fin.numpy(), want_s) <= TOL


def test_stage_steps_is_the_kernels():
    """The stage length the card tests probe is the one compiled in."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "rwkv6_scan.cu").read_text()
    assert f"constexpr int kT = {STAGE_STEPS};" in src
