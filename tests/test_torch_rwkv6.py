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

The gradient: the plain backward (a step-by-step recurrence) against
torch autograd of the plain chunked forward and ``jax.vjp`` of the
stepwise oracle at the same 1e-4 of the max, for the same reason; the
backward kernels' fp32 order, emulated here, against float64 autograd
at 1e-4 of the max, their bound against the plain version on the card.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as ref_scan
from repro.kernels.rwkv6_scan.ops import _shrink_to_divisor
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.kernel import (
    BWD_CHUNK,
    BWD_GROUPS,
    MAX_CHUNK,
    STAGE_STEPS,
    rwkv6_scan_backward_call,
    rwkv6_scan_call,
)
from repro_torch.kernels.rwkv6_scan.ref import (
    chunk_size,
    rwkv6_scan_backward_plain,
    rwkv6_scan_plain,
)

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


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------
def _cotangents(B, S, H, hd, seed, with_ds):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    ds = (rng.standard_normal((B, H, hd, hd)).astype(np.float32) if with_ds
          else None)
    return dy, ds


@pytest.mark.parametrize("S,with_ds", [(64, False), (37, True), (100, True),
                                       (1, True)])
def test_plain_backward_matches_autograd_and_jax(S, with_ds):
    """The plain backward against torch autograd of the plain chunked
    forward and against ``jax.vjp`` of the reference's stepwise oracle,
    with and without a cotangent on S_final: 1e-4 of the max, the
    forward's tolerance (the chunked form's ``k / prod(w)`` rescale loses
    a few digits, and its gradient with it)."""
    arrs = _inputs(2, S, 2, 16, seed=S)
    dy, ds = _cotangents(2, S, 2, 16, S + 1, with_ds)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, s_fin = rwkv6_scan_plain(*ts, chunk=chunk_size(MAX_CHUNK, S))
    outs, cots = [y], [torch.from_numpy(dy)]
    if with_ds:
        outs.append(s_fin)
        cots.append(torch.from_numpy(ds))
    want_torch = torch.autograd.grad(outs, ts, cots)
    _, vjp = jax.vjp(rwkv6_scan_ref, *(jnp.asarray(a) for a in arrs))
    want_jax = vjp((jnp.asarray(dy), jnp.asarray(ds if with_ds else np.zeros(
        (2, 2, 16, 16), np.float32))))
    got = rwkv6_scan_backward_plain(*(torch.from_numpy(a) for a in arrs),
                                    torch.from_numpy(dy),
                                    None if ds is None else torch.from_numpy(ds))
    for g, wt, wj in zip(got, want_torch, want_jax):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        if not np.abs(np.asarray(wj)).max():  # dw at S 1: S_{-1} = 0
            assert not g.abs().max() and not wt.abs().max()
            continue
        assert _rel(g.numpy(), wj) <= TOL
        assert _rel(g.numpy(), wt.numpy()) <= TOL


def test_scan_is_differentiable_through_the_plain_versions():
    """On CPU tensors the autograd function runs the plain forward and
    `rwkv6_scan_backward_plain`; with grad off it is the forward alone."""
    arrs = _inputs(1, 40, 2, 16, seed=5)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    dy, ds = _cotangents(1, 40, 2, 16, 6, True)
    y, s_fin = rwkv6_scan(*ts)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, s_fin), ts,
                                (torch.from_numpy(dy), torch.from_numpy(ds)))
    want = rwkv6_scan_backward_plain(*(t.detach() for t in ts),
                                     torch.from_numpy(dy), torch.from_numpy(ds))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    # only y used: S_final's cotangent is taken as zero
    (gr,) = torch.autograd.grad(rwkv6_scan(*ts)[0], ts[0], torch.from_numpy(dy))
    assert torch.equal(gr, rwkv6_scan_backward_plain(
        *(t.detach() for t in ts), torch.from_numpy(dy))[0])
    with torch.inference_mode():
        assert rwkv6_scan(*ts)[0].grad_fn is None


def test_cpu_backward_wrapper_counts_nothing_and_checks_inputs():
    t = [torch.from_numpy(a) for a in _inputs(1, 16, 2, 16, seed=1)]
    dy = torch.zeros_like(t[0])
    before = rwkv6_scan_backward_call.launches
    rwkv6_scan_backward_call(*t, dy)
    assert rwkv6_scan_backward_call.launches == before
    with pytest.raises(ValueError, match="dy must be"):
        rwkv6_scan_backward_call(*t, dy[:, :8])
    with pytest.raises(ValueError, match="ds_final must be"):
        rwkv6_scan_backward_call(*t, dy, torch.zeros((1, 2, 16, 8)))


def _pairwise(x):
    """Sum over the last axis pairwise in order, as an xor butterfly
    leaves it in every lane: ((x0 + x1) + (x2 + x3)) + ..."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _halving(x):
    """Sum over the last axis as a reduce-scatter leaves it, halving the
    payload at each level: x[:n/2] + x[n/2:], then again."""
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _in_order(x, order):
    """Sum over the last axis one term at a time, in ``order``."""
    out = x[..., order[0]]
    for g in order[1:]:
        out = out + x[..., g]
    return out


def _group_row_sums(m, x, groups):
    """``sum_j m[..., i, j] x[..., i, j]`` over each column group, in the
    kernel's order: the group's 16 columns as 2 lanes of 8, an FMA chain
    over a lane's 8 columns, then the row's 2 lanes added. ``x``
    broadcasts against ``m`` (a row vector for S dy and G v, the state
    for rowsum(G * S)). Returns (..., rows, groups)."""
    *lead, rows, hd = m.shape
    mm = m.reshape(*lead, rows, groups, 2, hd // groups // 2)
    vv = x.expand_as(m).reshape(*lead, rows, groups, 2, hd // groups // 2)
    acc = mm[..., 0] * vv[..., 0]
    for c in range(1, mm.shape[-1]):
        acc = _fma(mm[..., c], vv[..., c], acc)
    return _pairwise(acc)


def _dot_by_parts(a, b, parts):
    """``sum_j a_j b_j`` over hd: an FMA chain over each of ``parts``
    runs of hd / parts, then the parts pairwise (the kernel's v . dy and
    sum_i r u k, 16 threads of 4)."""
    aa = a.reshape(*a.shape[:-1], parts, -1)
    bb = b.reshape(*b.shape[:-1], parts, -1)
    acc = aa[..., 0] * bb[..., 0]
    for c in range(1, aa.shape[-1]):
        acc = _fma(aa[..., c], bb[..., c], acc)
    return _pairwise(acc)


def _kernel_order_backward(r, k, v, w, u, dy, ds_final, stash_every,
                           groups=BWD_GROUPS, group_order=None):
    """The backward kernels' arithmetic on float32 (B·H, S, hd) tensors.
    The sweep: the state step by step, S_{t-1} dy_t per column group J
    (`_group_row_sums`) and the groups summed in ``group_order`` (default
    the kernel's, 0, 1, ...), the state kept after every ``stash_every``
    steps and after the last. The reverse: G carried back, (G v)^J per
    group and summed in the same order, rowsum(G * S) taken exactly at
    each kept state (per group, then summed) and walked down to the next
    (``w dw = Q - k (G v)``, ``Q <- Q - k (G v) + r (S dy)``), dv's
    columns over the group's 64 rows (a lane's 4 rows in order, then the
    warp's 16 row quads halving), v . dy and sum_i r u k over 16 parts of
    4 pairwise, du over the steps in reverse order."""
    Bh, S, hd = r.shape
    order = list(range(groups)) if group_order is None else list(group_order)
    st = torch.zeros((Bh, hd, hd))
    P = torch.empty((Bh, S, hd))
    ends = {}
    for t in range(S):
        P[:, t] = _in_order(_group_row_sums(st, dy[:, t, None, :], groups), order)
        st = _fma(w[:, t, :, None], st, k[:, t, :, None] * v[:, t, None, :])
        if t % stash_every == stash_every - 1 or t == S - 1:
            ends[t] = st
    vdy = _dot_by_parts(v, dy, hd // 4)
    ruk = _dot_by_parts(r * u, k, hd // 4)
    G = ds_final.clone()
    GV, DV, dw = (torch.empty((Bh, S, hd)) for _ in range(3))
    Q = None
    for t in range(S - 1, -1, -1):
        if t in ends:
            Q = _in_order(_group_row_sums(G, ends[t], groups), order)
        GV[:, t] = _in_order(_group_row_sums(G, v[:, t, None, :], groups), order)
        qm = _fma(-k[:, t], GV[:, t], Q)
        dw[:, t] = qm / w[:, t]
        Q = _fma(r[:, t], P[:, t], qm)
        kk = k[:, t].reshape(Bh, hd // 4, 4)[..., None]  # (row quad, row)
        gg = G.reshape(Bh, hd // 4, 4, hd)
        pv = kk[:, :, 0] * gg[:, :, 0]
        for j in range(1, 4):
            pv = _fma(kk[:, :, j], gg[:, :, j], pv)
        DV[:, t] = _halving(pv.transpose(-1, -2))
        G = _fma(w[:, t, :, None], G, r[:, t, :, None] * dy[:, t, None, :])
    dr = _fma(u * k, vdy[..., None], P)
    dk = _fma(u * r, vdy[..., None], GV)
    dv = _fma(ruk[..., None], dy, DV)
    du = torch.zeros((Bh, hd))
    for t in range(S - 1, -1, -1):
        du = _fma(r[:, t] * k[:, t], vdy[:, t, None], du)
    return dr, dk, dv, dw, du


def _steps_backward64(r, k, v, w, u, dy, ds):
    """float64 autograd of the step-by-step recurrence: the oracle."""
    ts = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    rr, kk, vv, ww, uu = ts
    st = torch.zeros(r.shape[0], r.shape[-1], r.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(r.shape[1]):
        kv = kk[:, t, :, None] * vv[:, t, None, :]
        ys.append(torch.einsum("bd,bde->be", rr[:, t], st + uu[None, :, None] * kv))
        st = ww[:, t, :, None] * st + kv
    return torch.autograd.grad((torch.stack(ys, 1), st), ts, (dy.double(), ds.double()))


@pytest.mark.parametrize("logit", [-8.0, -1.0])
def test_backward_kernel_summation_order_matches_float64(logit):
    """The backward kernels' order (module `_kernel_order_backward`: the
    state split into BWD_GROUPS column groups, the groups' partial rows
    summed in group order, the decay's gradient walked from the state
    stashed every BWD_CHUNK steps), emulated on the CPU at S 2048, hd
    64, every decay at one clamp end, with a cotangent on S_final,
    against float64 autograd of the step-by-step recurrence: 1e-4 of the
    max, the kernel's bound against the plain version on the card. The
    walk anchored at each stash is held no worse on dw than the identity
    walked from the last step alone, which subtracts sums over the whole
    sequence (the reason for the anchors; observed 9.9e-7 / 3.3e-7
    against 1.8e-6 / 1.5e-6)."""
    arrs = _inputs(1, 2048, 1, 64, seed=3)
    r, k, v = (torch.from_numpy(a[:, :, 0]) for a in arrs[:3])
    u = torch.from_numpy(arrs[4][0])
    w = torch.full_like(r, float(np.exp(-np.exp(logit))))
    dy, ds = (torch.from_numpy(a) for a in _cotangents(1, 2048, 1, 64, 4, True))
    dy, ds = dy[:, :, 0], ds[:, 0]
    want = _steps_backward64(r, k, v, w, u, dy, ds)
    got = _kernel_order_backward(r, k, v, w, u, dy, ds, BWD_CHUNK)
    for g in got:
        assert bool(torch.isfinite(g).all())
    for g, x in zip(got[:4], want[:4]):
        assert _rel(g.numpy(), x.numpy()) <= TOL
    assert _rel(got[4][0].numpy(), want[4].numpy()) <= TOL
    unanchored = _kernel_order_backward(r, k, v, w, u, dy, ds, 2 * r.shape[1])[3]
    assert _rel(got[3].numpy(), want[3].numpy()) <= _rel(unanchored.numpy(),
                                                         want[3].numpy())


@pytest.mark.parametrize("decay", [0.1, 0.01])
def test_backward_kernel_dw_rounding_grows_as_one_over_w(decay):
    """Decays far below the model's clamp (w >= 0.69), where the kernel's
    ``dw = (Q - k (G v)) / w`` cancels: its order emulated at S 512 with
    a cotangent on S_final against float64 autograd. dr, dk, dv and du
    keep 1e-4 of the max; dw's error, Q's rounding (a few fp32 ulp of
    the state's scale) divided by w, stays within 4e-7 / w of its max
    (observed 1.8e-6 at w 0.1 and 1.6e-5 at w 0.01), so the wrapper's
    stated 1e-4 holds down to w 0.004."""
    S = 512
    arrs = _inputs(1, S, 1, 64, seed=3)
    r, k, v = (torch.from_numpy(a[:, :, 0]) for a in arrs[:3])
    u = torch.from_numpy(arrs[4][0])
    w = torch.full_like(r, decay)
    dy, ds = (torch.from_numpy(a) for a in _cotangents(1, S, 1, 64, 4, True))
    dy, ds = dy[:, :, 0], ds[:, 0]
    want = _steps_backward64(r, k, v, w, u, dy, ds)
    got = _kernel_order_backward(r, k, v, w, u, dy, ds, BWD_CHUNK)
    for i in (0, 1, 2):
        assert _rel(got[i].numpy(), want[i].numpy()) <= TOL
    assert _rel(got[4][0].numpy(), want[4].numpy()) <= TOL
    assert _rel(got[3].numpy(), want[3].numpy()) <= 4e-7 / decay


def _bwd_source():
    return (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
            / "rwkv6_scan_bwd.cu").read_text()


def test_backward_stash_interval_is_the_kernels():
    """The stash interval, the column groups and the lane layout the
    emulation above follows are the ones compiled in."""
    src = _bwd_source()
    assert f"constexpr int kStash = {BWD_CHUNK};" in src
    assert f"constexpr int kGroups = {BWD_GROUPS};" in src
    assert "constexpr int kGCols = kHD / kGroups;" in src
    assert "p.row0 = 4 * (lane / 2);" in src
    assert "p.col0 = kGCols * p.grp + 8 * p.ch;" in src


def test_backward_group_order_is_the_sources():
    """The once-a-tile sums run in the order the emulation takes: the
    groups' partial rows of S dy (the sweep), of G v and of rowsum(G * S)
    (the reverse) in group order, and the walk on their sums. An
    emulation that sums the groups in another order gives other bits (so
    the order it follows is one that matters)."""
    src = _bwd_source()
    for snippet in (
        "for (int g = 1; g < kGroups; ++g) add4(p, ld4(Pt + g * kTile + o));",
        "for (int g = 1; g < kGroups; ++g) add4(gv, ld4(GVt + g * kTile + o));",
        "const float gv = ((GVt[o] + GVt[kTile + o]) + GVt[2 * kTile + o]) + GVt[3 * kTile + o];",
        "if (anchor) Q = ((QJ[i] + QJ[kHD + i]) + QJ[2 * kHD + i]) + QJ[3 * kHD + i];",
        "const float qm = fmaf(-ks[o], gv, Q);",
        "Q = fmaf(rs[o], ps[o], qm);",
    ):
        assert snippet in src
    S = 96
    arrs = _inputs(1, S, 1, 64, seed=9)
    r, k, v, w = (torch.from_numpy(a[:, :, 0]) for a in arrs[:4])
    u = torch.from_numpy(arrs[4][0])
    dy, ds = (torch.from_numpy(a) for a in _cotangents(1, S, 1, 64, 10, True))
    dy, ds = dy[:, :, 0], ds[:, 0]
    kernel = _kernel_order_backward(r, k, v, w, u, dy, ds, BWD_CHUNK)
    other = _kernel_order_backward(r, k, v, w, u, dy, ds, BWD_CHUNK,
                                   group_order=range(BWD_GROUPS - 1, -1, -1))
    for i in (0, 1, 3):  # dr, dk, dw sum the groups' partials
        assert not torch.equal(kernel[i], other[i])
    for i in (2, 4):  # dv and du do not
        assert torch.equal(kernel[i], other[i])
