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
from repro_torch.kernels.mamba_scan.kernel import STAGE_STEPS, mamba_scan_call
from repro_torch.kernels.mamba_scan.ref import chunk_size, mamba_scan_steps
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
