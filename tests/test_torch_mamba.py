"""The port's selective scan and mamba mixer against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX scan runs as its own tests run it (the Pallas kernel in interpret
mode, and the associative-scan oracle ``mamba_scan_ref``); the port's
side is its plain chunked scan, which is what its wrapper takes for CPU
tensors, and a float64 step-by-step oracle.

Tolerances, with their reasons:

- the scan: 1e-4 of the max for y and h_final, the reference's own
  tolerance between its chunked kernel and its oracle (the scans
  multiply the same decays in another order; observed ~1e-7). The CUDA
  kernel's own order of summation is emulated here and held to the same
  bound, as the card holds the kernel to the plain version.
- the gradient: the plain backward against torch autograd of the plain
  scan and ``jax.vjp`` of the oracle at 1e-4 of the max (the same decays
  multiplied in other orders); the backward kernels' fp32 order,
  emulated here, against float64 autograd at the same bound, which the
  card holds the kernels to against the plain version.
- the mixer in float32: 1e-4 of the max (same arithmetic in another
  order), except the conv cache, which both sides round to bf16 from
  fp32 values ~1e-7 apart: a rounding can flip there, so it is held to
  one bf16 ulp (2^-7 of the max).
- the mixer in bfloat16: relative L2 3e-2, as the port's other bf16
  comparisons. PyTorch and XLA round the bf16 elementwise ops (silu,
  the conv's products) at the same places but not always to the same
  ulp; one layer's output is observed ~0.5% apart.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke_config
from repro.configs.jamba_v0_1_52b import CONFIG as REF_JAMBA
from repro.kernels.mamba_scan import mamba_scan as ref_scan
from repro.kernels.mamba_scan.kernel import mamba_scan_call as ref_scan_call
from repro.kernels.mamba_scan.ops import _shrink_to_divisor
from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro.models import ssm as RS
from repro_torch import convert
from repro_torch.configs import load_config, smoke_config
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mamba_scan.kernel import (
    BWD_CHANNELS,
    BWD_CHUNK,
    STAGE_STEPS,
    mamba_scan_backward_call,
    mamba_scan_call,
)
from repro_torch.kernels.mamba_scan.ref import (
    chunk_size,
    mamba_scan_backward_plain,
    mamba_scan_plain,
    mamba_scan_steps,
)
from repro_torch.models import ssm as S

torch.set_num_threads(1)

TOL = 1e-4
BF16_ULP = 2.0**-7
BF16_REL_L2 = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _scan_inputs(B, S_, di, ns, seed, dt_scale=1.0):
    """dt = softplus(normal) (x dt_scale), B, C, x normal, A = -|normal|,
    h0 normal: as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S_, di)))) * dt_scale).astype(np.float32)
    Bm = rng.standard_normal((B, S_, ns)).astype(np.float32)
    Cm = rng.standard_normal((B, S_, ns)).astype(np.float32)
    x = rng.standard_normal((B, S_, di)).astype(np.float32)
    A = -np.abs(rng.standard_normal((di, ns))).astype(np.float32)
    h0 = rng.standard_normal((B, di, ns)).astype(np.float32)
    return dt, Bm, Cm, x, A, h0


@pytest.mark.parametrize("S_,chunk", [(32, 8), (64, 16), (64, 64), (48, 16), (100, 64)])
def test_plain_scan_matches_pallas_kernel_and_oracles(S_, chunk):
    arrs = _scan_inputs(2, S_, 16, 4, seed=S_ + chunk)
    t = [torch.from_numpy(a) for a in arrs[:5]]
    y, h = mamba_scan(*t, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (2, S_, 16) and h.shape == (2, 16, 4)
    j = [jnp.asarray(a) for a in arrs[:5]]
    for want_y, want_h in (ref_scan(*j, chunk=chunk), mamba_scan_ref(*j),
                           mamba_scan_steps(*t, torch.zeros(2, 16, 4))):
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


def test_scan_from_h0_chains_as_one_scan():
    """Two halves with the carried h equal one full scan, and a scan from
    a non-zero h0 equals the reference's from the same h0."""
    dt, Bm, Cm, x, A, h0 = (torch.from_numpy(a) for a in _scan_inputs(1, 32, 8, 4, seed=9))
    y_full, h_full = mamba_scan(dt, Bm, Cm, x, A, chunk=8)
    y1, h1 = mamba_scan(dt[:, :16], Bm[:, :16], Cm[:, :16], x[:, :16], A, chunk=8)
    y2, h2 = mamba_scan(dt[:, 16:], Bm[:, 16:], Cm[:, 16:], x[:, 16:], A, h1, chunk=8)
    assert _rel(torch.cat([y1, y2], dim=1), y_full) <= TOL
    assert _rel(h2, h_full) <= TOL
    y, h = mamba_scan(dt, Bm, Cm, x, A, h0, chunk=8)
    j = [jnp.asarray(a.numpy()) for a in (dt, Bm, Cm, x, A, h0)]
    for want_y, want_h in (ref_scan(*j, chunk=8), mamba_scan_ref(*j)):
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


def test_scan_takes_large_negative_decay_exponents():
    """dt * A past -200: the decays underflow to 0, nothing overflows
    (no exp(-cumsum) rescale), and the oracle agrees."""
    arrs = _scan_inputs(1, 64, 8, 4, seed=3, dt_scale=60.0)
    assert (arrs[0][..., None] * arrs[4]).min() < -200
    t = [torch.from_numpy(a) for a in arrs]
    y, h = mamba_scan(*t, chunk=16)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    want_y, want_h = mamba_scan_steps(*t)
    assert _rel(y, want_y) <= TOL
    assert _rel(h, want_h) <= TOL


#: lanes that share a channel's 16 states in the CUDA kernel (``kLanes``)
KERNEL_LANES = 4
LOG2E = 1.4426950408889634


def _kernel_order_scan(dt, Bm, Cm, x, A, h0, lanes=KERNEL_LANES):
    """The CUDA kernel's arithmetic, step by step in float32: each decay
    as 2^(dt * (A log2 e)) with results below 2^-126 flushed to 0 (one
    ``ex2.approx.ftz``), y as the partial sums of ``lanes`` lanes, lane g
    summing states g, g + lanes, g + 2 lanes, ... in that order, added in
    pairs: (y_0 + y_1) + (y_2 + y_3)."""
    a2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    h = h0.clone()
    ns = A.shape[1]
    per = ns // lanes
    ys = []
    for t in range(x.shape[1]):
        e = torch.exp2(dt[:, t, :, None] * a2)
        e = torch.where(e < 2.0**-126, torch.zeros_like(e), e)
        h = e * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        hc = h * Cm[:, t, None, :]
        parts = []
        for g in range(lanes):
            acc = hc[..., g]
            for j in range(1, per):
                acc = acc + hc[..., g + lanes * j]
            parts.append(acc)
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        ys.append(parts[0])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("underflow", [False, True])
def test_kernel_summation_order_matches_reference(underflow):
    """The CUDA kernel's order (states split over 4 lanes by n mod 4, y
    summed across them in pairs, one flushed exp2 per decay), emulated on
    the CPU at S 2048 with A drawn per element and h0 normal, against the
    JAX package's Pallas kernel (interpret mode) and its associative-scan
    oracle: 1e-4 of the max, the kernel's bound against the plain version
    on the card. dt is the model's softplus(normal - 4.6), so that most
    decays stay near 1 for hundreds of steps; with ``underflow`` every
    16th step has dt 50 and dt * A reaches -1e3."""
    rng = np.random.default_rng(18)
    Bb, S_, di, ns = 1, 2048, 32, 16
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S_, di)) - 4.6)).astype(np.float32)
    if underflow:
        dt[:, ::16] = 50.0
    Bm = rng.standard_normal((Bb, S_, ns)).astype(np.float32)
    Cm = rng.standard_normal((Bb, S_, ns)).astype(np.float32)
    x = rng.standard_normal((Bb, S_, di)).astype(np.float32)
    A = -np.exp(0.5 + 1.5 * rng.standard_normal((di, ns))).astype(np.float32)
    h0 = rng.standard_normal((Bb, di, ns)).astype(np.float32)
    arrs = (dt, Bm, Cm, x, A, h0)
    assert ((dt[..., None] * A).min() < -1e3) == underflow
    y, h = _kernel_order_scan(*(torch.from_numpy(a) for a in arrs))
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    j = [jnp.asarray(a) for a in arrs]
    for want_y, want_h in (ref_scan_call(*j, chunk=256), mamba_scan_ref(*j)):
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


def test_kernel_constants_are_the_sources():
    """The stage length the card tests probe, and the lane split the
    emulation above follows, are the ones compiled in."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "mamba_scan.cu").read_text()
    assert f"constexpr int kT = {STAGE_STEPS};" in src
    assert f"constexpr int kLanes = {KERNEL_LANES};" in src


@pytest.mark.parametrize("S_", [1, 7, 48, 100, 256, 2048])
def test_chunk_follows_the_model(S_):
    """The plain version chunks S as the JAX model and wrapper do."""
    assert chunk_size(64, S_) == _shrink_to_divisor(64, S_)
    assert chunk_size(256, S_) == _shrink_to_divisor(256, S_)


def test_cpu_wrapper_counts_nothing_and_checks_inputs():
    t = [torch.from_numpy(a) for a in _scan_inputs(1, 16, 8, 4, seed=1)]
    before = mamba_scan_call.launches
    mamba_scan_call(*t, chunk=8)
    assert mamba_scan_call.launches == before
    dt, Bm, Cm, x, A, h0 = t
    with pytest.raises(ValueError, match="chunk"):
        mamba_scan_call(*t, chunk=0)
    with pytest.raises(ValueError, match="h0 must be"):
        mamba_scan_call(dt, Bm, Cm, x, A, h0[:, :4], chunk=8)
    with pytest.raises(ValueError, match="B must be"):
        mamba_scan_call(dt, Bm[:, :8], Cm, x, A, h0, chunk=8)
    with pytest.raises(ValueError, match="dt must be"):
        mamba_scan_call(dt[:, :8], Bm, Cm, x, A, h0, chunk=8)
    with pytest.raises(ValueError, match="A must be"):
        mamba_scan_call(dt, Bm, Cm, x, A[:4], h0, chunk=8)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
def _mixer(dtype, seed=1):
    rcfg = ref_smoke_config(REF_JAMBA)
    cfg = smoke_config(load_config("jamba_v0_1_52b"))
    p = RS.mamba_init(jax.random.PRNGKey(seed), rcfg)
    if dtype == "float32":
        p = {k: v.astype(jnp.float32) for k, v in p.items()}
    tp = {k: convert._lm_tensor(np.asarray(v), "cpu") for k, v in p.items()}
    return rcfg, cfg, p, tp


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    return jx, convert._lm_tensor(np.asarray(jx), "cpu")


def _close(got, want, dtype):
    if dtype == "float32":
        assert _rel(got, want) <= TOL
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2


def _cache_close(got, want, dtype):
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    w = {k: convert._lm_tensor(np.asarray(v), "cpu") for k, v in want.items()}
    for key in got:
        assert got[key].dtype == w[key].dtype, key
        assert got[key].shape == w[key].shape, key
    if dtype == "float32":
        assert _rel(got["ssm"], w["ssm"]) <= TOL
        assert _rel(got["conv"], w["conv"]) <= BF16_ULP
    else:
        for key in got:
            assert _rel_l2(got[key], w[key]) <= BF16_REL_L2, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [24, 20])
def test_mamba_prefill_matches_reference(dtype, seq):
    """Output and decode cache of ``_mamba_impl`` / ``mamba_prefill``;
    S = 20 is not a multiple of the smoke chunk 8 (it shrinks to 4)."""
    rcfg, cfg, p, tp = _mixer(dtype)
    jx, tx = _x((2, seq, cfg.d_model), dtype, seed=seq)
    want, want_cache = RS.mamba_prefill(p, jx, rcfg)
    got, got_cache = S.mamba_prefill(tp, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    _cache_close(got_cache, want_cache, dtype)
    impl, _ = S._mamba_impl(tp, tx, cfg)
    assert torch.equal(S.mamba(tp, tx, cfg), impl)
    assert torch.equal(impl, got)
    _close(S.mamba(tp, tx, cfg), RS.mamba(p, jx, rcfg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype):
    """Three decode steps from the reference's own prefill cache, on the
    same token inputs: outputs and caches."""
    rcfg, cfg, p, tp = _mixer(dtype, seed=2)
    jx, _ = _x((2, 16, cfg.d_model), dtype, seed=5)
    _, r_cache = RS.mamba_prefill(p, jx, rcfg)
    cache = {k: convert._lm_tensor(np.asarray(v), "cpu") for k, v in r_cache.items()}
    for i in range(3):
        jt, tt = _x((2, 1, cfg.d_model), dtype, seed=100 + i)
        want, r_cache = RS.mamba_decode(p, jt, rcfg, r_cache)
        got, cache = S.mamba_decode(tp, tt, cfg, cache)
        assert got.dtype == tt.dtype and got.shape == tt.shape
        _close(got, want, dtype)
        for key in ("conv", "ssm"):
            w = convert._lm_tensor(np.asarray(r_cache[key]), "cpu")
            assert cache[key].dtype == w.dtype and cache[key].shape == w.shape, key
            _close(cache[key], w, dtype)


def test_mamba_init_and_cache_have_the_reference_layout():
    rcfg = ref_smoke_config(REF_JAMBA)
    cfg = smoke_config(load_config("jamba_v0_1_52b"))
    want = {k: convert._lm_tensor(np.asarray(v), "cpu")
            for k, v in RS.mamba_init(jax.random.PRNGKey(0), rcfg).items()}
    got = S.mamba_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()
    }
    for key in ("dt_bias", "D", "conv_b", "norm"):  # not drawn
        assert torch.equal(got[key], want[key]), key
    # log(1..ns): the two libraries' logs may differ in the last bit
    assert torch.allclose(got["A_log"], want["A_log"], rtol=1e-6, atol=0)
    assert got["conv_w"].float().std().item() == pytest.approx(0.1, rel=0.2)
    cache = S.mamba_cache_init(cfg, 3, device="cpu")
    ref = RS.mamba_cache_init(rcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in cache.items()} == {
        k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in ref.items()
    }


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------
def _scan_cotangents(B, S_, di, ns, seed, with_dh):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, S_, di)).astype(np.float32)
    dh = rng.standard_normal((B, di, ns)).astype(np.float32) if with_dh else None
    return dy, dh


@pytest.mark.parametrize("S_,chunk,with_dh", [(32, 8, False), (48, 16, True),
                                              (100, 64, True), (1, 8, True)])
def test_plain_backward_matches_autograd_and_jax(S_, chunk, with_dh):
    """The plain backward against torch autograd of the plain chunked
    scan and against ``jax.vjp`` of the reference's associative-scan
    oracle, from a normal h0, with and without a cotangent on h_final:
    1e-4 of the max, the forward's tolerance (the same decays multiplied
    in other orders)."""
    arrs = _scan_inputs(2, S_, 12, 8, seed=S_ + chunk)
    dy, dh = _scan_cotangents(2, S_, 12, 8, S_ + 1, with_dh)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, h = mamba_scan_plain(*ts, chunk=chunk)
    outs, cots = [y], [torch.from_numpy(dy)]
    if with_dh:
        outs.append(h)
        cots.append(torch.from_numpy(dh))
    want_torch = torch.autograd.grad(outs, ts, cots)
    _, vjp = jax.vjp(mamba_scan_ref, *(jnp.asarray(a) for a in arrs))
    want_jax = vjp((jnp.asarray(dy), jnp.asarray(
        dh if with_dh else np.zeros_like(arrs[5]))))
    got = mamba_scan_backward_plain(*(torch.from_numpy(a) for a in arrs),
                                    torch.from_numpy(dy),
                                    None if dh is None else torch.from_numpy(dh),
                                    chunk=chunk)
    for g, wt, wj in zip(got, want_torch, want_jax):
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert _rel(g, wj) <= TOL
        assert _rel(g, wt) <= TOL


def test_scan_is_differentiable_through_the_plain_versions():
    """On CPU tensors the autograd function runs the plain forward and
    `mamba_scan_backward_plain`; with grad off it is the forward alone."""
    arrs = _scan_inputs(1, 40, 8, 4, seed=5)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    dy, dh = (torch.from_numpy(a) for a in _scan_cotangents(1, 40, 8, 4, 6, True))
    y, h = mamba_scan(*ts, chunk=8)
    assert y.grad_fn is not None
    grads = torch.autograd.grad((y, h), ts, (dy, dh))
    want = mamba_scan_backward_plain(*(t.detach() for t in ts), dy, dh, chunk=8)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with torch.inference_mode():
        assert mamba_scan(*ts, chunk=8)[0].grad_fn is None


def test_cpu_backward_wrapper_counts_nothing_and_checks_inputs():
    t = [torch.from_numpy(a) for a in _scan_inputs(1, 16, 8, 4, seed=1)]
    dy = torch.zeros_like(t[3])
    before = mamba_scan_backward_call.launches
    mamba_scan_backward_call(*t, dy, chunk=8)
    assert mamba_scan_backward_call.launches == before
    with pytest.raises(ValueError, match="dy must be"):
        mamba_scan_backward_call(*t, dy[:, :8], chunk=8)
    with pytest.raises(ValueError, match="dh_final must be"):
        mamba_scan_backward_call(*t, dy, t[5][:, :4], chunk=8)


def _pairwise(x):
    """Sum over the last axis pairwise in order, as an xor butterfly
    leaves it in every lane: ((x0 + x1) + (x2 + x3)) + ..."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _fma(a, b, c):
    """fp32 fused multiply-add: the product and sum in float64, rounded
    once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _decay(dt, A):
    """a_t as the backward kernels take it, as the forward kernel does:
    2^(dt (A log2 e)), A pre-scaled in fp32, results below 2^-126
    flushed to 0 (one ``ex2.approx.ftz``)."""
    e = torch.exp2(dt * (A * torch.tensor(LOG2E, dtype=torch.float32)))
    return torch.where(e < 2.0**-126, torch.zeros_like(e), e)


def _halving(x):
    """Sum over the last axis as a reduce-scatter leaves it, halving the
    payload at each level: x[:n/2] + x[n/2:], then again."""
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _kernel_order_backward(dt, Bm, Cm, x, A, h0, dy, dh, chan=BWD_CHANNELS,
                           over_warp=_halving):
    """The backward kernels' arithmetic, step by step in float32: a_t =
    `_decay` once per step and state, p = a_t h, h recomputed as
    ``fma(dt x, B, p)``, and the adjoint carried back with the same a_t;
    per thread the 4 states 4j..4j+3 in order, then the xor-1, 2
    butterfly over a channel's 4 threads (gB, the ddt sum); dB and dC
    over d as a thread's 2 channels in order, then the warp's 8 channel
    pairs by the reduce-scatter (``over_warp``: pairs c and c + 4, then
    + 2, then + 1), then the block's warps in order, then the blocks in
    order; dA over the batch in order."""
    Bb, S_, di = x.shape
    ns = A.shape[1]
    p_all, a_all, h = [], [], h0.clone()
    for t in range(S_):
        a_t = _decay(dt[:, t, :, None], A)
        p = a_t * h
        p_all.append(p)
        a_all.append(a_t)
        h = _fma((dt[:, t] * x[:, t])[..., None], Bm[:, t, None, :], p)
    q = dh.clone()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    da = torch.zeros_like(h0)
    n_blk = -(-di // chan)
    pad = n_blk * chan - di

    def over_d(e):  # (Bb, di, ns) -> (Bb, ns)
        e = torch.nn.functional.pad(e, (0, 0, 0, pad))
        e = e.reshape(Bb, n_blk, chan // 16, 8, 2, ns)  # blocks, warps, pairs
        e = e[..., 0, :] + e[..., 1, :]
        per_warp = over_warp(e.transpose(-1, -2))  # (Bb, blocks, warps, ns)
        out = per_warp[:, :, 0]
        for w in range(1, per_warp.shape[2]):
            out = out + per_warp[:, :, w]
        tot = out[:, 0]
        for b in range(1, n_blk):
            tot = tot + out[:, b]
        return tot

    for t in range(S_ - 1, -1, -1):
        dtv, xv, dyv = dt[:, t, :, None], x[:, t, :, None], dy[:, t, :, None]
        dtx = dtv * xv
        b_t, c_t, p = Bm[:, t, None, :], Cm[:, t, None, :], p_all[t]
        g = _fma(dyv, c_t, q)
        dc = _fma(dtx, b_t, p) * dyv
        db = g * dtx
        gb, gpa = g * b_t, (g * p) * A
        gbs, gps = [gb[..., 0::4]], [gpa[..., 0::4]]
        for j in range(1, 4):
            gbs.append(_fma(g[..., j::4], b_t[..., j::4], gbs[-1]))
            gps.append(_fma(g[..., j::4] * p[..., j::4], A[:, j::4], gps[-1]))
        gb = _pairwise(gbs[-1])[..., None]
        gpa = _pairwise(gps[-1])[..., None]
        da = _fma(g * p, dtv, da)
        q = a_all[t] * g
        ddt[:, t] = _fma(xv, gb, gpa)[..., 0]
        dx[:, t] = (dtv * gb)[..., 0]
        dB[:, t], dC[:, t] = over_d(db), over_d(dc)
    dA = da[0]
    for b in range(1, Bb):
        dA = dA + da[b]
    return ddt, dB, dC, dx, dA, q


def _steps_backward64(dt, Bm, Cm, x, A, h0, dy, dh):
    """float64 autograd of the step-by-step recurrence: the oracle."""
    ts = [t.double().requires_grad_() for t in (dt, Bm, Cm, x, A, h0)]
    dt_, B_, C_, x_, A_, h = ts
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt_[:, t, :, None] * A_) * h + (
            (dt_[:, t] * x_[:, t])[..., None] * B_[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    return torch.autograd.grad((torch.stack(ys, 1), h), ts, (dy.double(), dh.double()))


@pytest.mark.parametrize("underflow", [False, True])
def test_backward_kernel_summation_order_matches_float64(underflow):
    """The backward kernels' order (`_kernel_order_backward`), emulated on
    the CPU at S 2048 over two batch rows and two blocks of channels, A
    drawn per element, h0 and the h_final cotangent normal, against
    float64 autograd of the step-by-step recurrence: 1e-4 of the max, the
    kernel's bound against the plain version on the card. dt is the
    model's softplus(normal - 4.6); with ``underflow`` every 16th step
    has dt 50 and the decays there flush to 0."""
    rng = np.random.default_rng(19)
    Bb, S_, di, ns = 2, 2048, 2 * BWD_CHANNELS, 16
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S_, di)) - 4.6)).astype(np.float32)
    if underflow:
        dt[:, ::16] = 50.0
    Bm, Cm = (rng.standard_normal((Bb, S_, ns)).astype(np.float32) for _ in range(2))
    x, dy = (rng.standard_normal((Bb, S_, di)).astype(np.float32) for _ in range(2))
    A = -np.exp(0.5 + 1.5 * rng.standard_normal((di, ns))).astype(np.float32)
    h0, dh = (rng.standard_normal((Bb, di, ns)).astype(np.float32) for _ in range(2))
    ts = [torch.from_numpy(a) for a in (dt, Bm, Cm, x, A, h0, dy, dh)]
    got = _kernel_order_backward(*ts)
    want = _steps_backward64(*ts)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel(g, w) <= TOL


def _bwd_source():
    return (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
            / "mamba_scan_bwd.cu").read_text()


def test_backward_kernel_constants_are_the_sources():
    """The stash interval and the block's channels the emulation above
    follows are the ones compiled in, and the reverse takes one
    exponential per state element and step, kept for the adjoint."""
    src = _bwd_source()
    assert f"constexpr int kT = {BWD_CHUNK};" in src
    assert f"constexpr int kChan = {BWD_CHANNELS};" in src
    reverse = src[src.index("scan_bwd_reverse_kernel("):src.index("scan_bwd_dbc_kernel(")]
    assert reverse.count("ex2(") == 1
    assert "e[t][k][j] = ex2(dtv[k] * a2[k][j]);" in reverse
    assert "q[k][j] = e[t][k][j] * g[j];" in reverse
    assert "constexpr int kCPL = 2;" in src


def test_backward_reduce_scatter_order_is_the_sources():
    """dB and dC over a thread's 2 channels, then the warp's 8 channel
    pairs, run as the emulation's reduce-scatter (xor 16 with 4 values,
    xor 8 with 2, xor 4 with 1, each lane keeping one half), then the
    block's warps in order. The butterfly it replaced (xor 4, 8, 16 on
    every value) sums the same channels in another order and gives
    other bits."""
    src = _bwd_source()
    for snippet in (
        "k4[j] = (hi ? dc[j] : db[j]) + __shfl_xor_sync(kFull, hi ? db[j] : dc[j], 16);",
        "k2[j] = (mid ? k4[j + 2] : k4[j]) + __shfl_xor_sync(kFull, mid ? k4[j] : k4[j + 2], 8);",
        "return (lo ? k2[1] : k2[0]) + __shfl_xor_sync(kFull, lo ? k2[0] : k2[1], 4);",
        "= chan_sum(db, dc, lane);",
        "db[j] = k ? db[j] + bj : bj;  // the thread's two channels in order",
        "dc[j] = k ? dc[j] + cj : cj;",
        "for (int w = 1; w < kWarps; ++w) {",
    ):
        assert snippet in src
    rng = np.random.default_rng(23)
    Bb, S_, di, ns = 1, 64, BWD_CHANNELS, 16
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S_, di)) - 4.6)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bb, S_, ns)).astype(np.float32) for _ in range(2))
    x, dy = (rng.standard_normal((Bb, S_, di)).astype(np.float32) for _ in range(2))
    A = -np.exp(0.5 + 1.5 * rng.standard_normal((di, ns))).astype(np.float32)
    h0, dh = (rng.standard_normal((Bb, di, ns)).astype(np.float32) for _ in range(2))
    ts = [torch.from_numpy(a) for a in (dt, Bm, Cm, x, A, h0, dy, dh)]
    kernel = _kernel_order_backward(*ts)
    butterfly = _kernel_order_backward(*ts, over_warp=_pairwise)
    for i in (1, 2):  # dB, dC
        assert not torch.equal(kernel[i], butterfly[i])
    for i in (0, 3, 4, 5):
        assert torch.equal(kernel[i], butterfly[i])
