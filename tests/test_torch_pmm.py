"""The port's preemptible matmul against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it (the Pallas kernel in interpret
mode); the port's side runs its plain version, which is what its
wrapper takes for CPU tensors. Tolerances are those of
``tests/test_kernels.py``: fp32 products agree to rel 1e-5 (different
summation order only), bf16 inputs to rel 2e-2 (the port upcasts the
same bf16 values; the slack covers the reference's oracle, which also
rounds through bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.preemptible_matmul import matmul as ref_matmul
from repro.kernels.preemptible_matmul import matmul_resumable as ref_resumable
from repro.kernels.preemptible_matmul import matmul_window as ref_window
from repro.kernels.preemptible_matmul.ref import matmul_ref as jax_matmul_ref
from repro.kernels.preemptible_matmul.ref import (
    matmul_window_ref as jax_window_ref,
)
from repro_torch.kernels.preemptible_matmul import (
    grid_geometry,
    matmul,
    matmul_resumable,
    matmul_window,
    pad_operands,
    pick_window,
)
from repro_torch.kernels.preemptible_matmul.kernel import matmul_window_call
from repro_torch.kernels.preemptible_matmul.ref import (
    matmul_partial_ref,
    matmul_ref,
    matmul_window_plain,
    matmul_window_ref,
)

torch.set_num_threads(1)

BLOCK = (128, 128, 128)
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _pair(shape, seed, dtype="float32"):
    """The same values as a JAX array and a CPU tensor (bf16 rounding is
    done once, by JAX, and carried across exactly)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dtype][1])
    return jx, tx


# ---------------------------------------------------------------------------
# the four test_pmm_* cases of tests/test_kernels.py, against the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "M,K,N", [(128, 128, 128), (256, 128, 384), (384, 256, 256)]
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pmm_full_product(M, K, N, dtype):
    ja, ta = _pair((M, K), 0, dtype)
    jb, tb = _pair((K, N), 1, dtype)
    want = ref_matmul(ja, jb, block=BLOCK, window_tiles=2)
    got = matmul(ta, tb, block=BLOCK, window_tiles=2)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel_err(got, want) < tol
    assert _rel_err(got, jax_matmul_ref(ja, jb)) < tol


@pytest.mark.parametrize("window", [1, 2, 3, 6])
def test_pmm_window_oracle(window):
    M, K, N = 256, 128, 384  # 2x3 = 6 tiles
    ja, ta = _pair((M, K), 2)
    jb, tb = _pair((K, N), 3)
    w = pick_window(6, window)
    jc = jnp.zeros((M, N), jnp.float32)
    c = torch.zeros((M, N))
    for start in range(0, 6, w):
        want_ref, _ = ref_window(ja, jb, jc, start, block=BLOCK, window_tiles=w)
        # the port updates c in place: take the oracle from a clone first
        want = matmul_window_ref(ta, tb, c.clone(), start, w, BLOCK)
        got, nxt = matmul_window(ta, tb, c, start, block=BLOCK, window_tiles=w)
        assert got is c and nxt == min(start + w, 6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(want_ref), rtol=1e-4, atol=1e-4)
        jc = want_ref
    np.testing.assert_allclose(c, matmul_ref(ta, tb), rtol=1e-4, atol=1e-4)


def test_pmm_preempt_resume_identity():
    """Preempting between windows and resuming is exact (paper §3.4)."""
    M, K, N = 256, 256, 256
    ja, ta = _pair((M, K), 4, "bfloat16")
    jb, tb = _pair((K, N), 5, "bfloat16")
    c1, prog = matmul_resumable(ta, tb, block=BLOCK, window_tiles=1, max_windows=3)
    assert not prog.done and prog.next_tile == 3
    rc1, rprog = ref_resumable(ja, jb, block=BLOCK, window_tiles=1, max_windows=3)
    assert rprog.next_tile == prog.next_tile
    np.testing.assert_allclose(
        c1, matmul_partial_ref(ta, tb, 3, BLOCK), rtol=1e-2, atol=1e-2
    )
    np.testing.assert_allclose(c1, np.asarray(rc1), rtol=1e-2, atol=1e-2)
    # interleave: run an unrelated job (separate buffers), then resume
    matmul_resumable(tb, ta, block=BLOCK, window_tiles=2)
    c2, prog2 = matmul_resumable(
        ta, tb, block=BLOCK, window_tiles=1, start_tile=prog.next_tile, c_acc=c1
    )
    assert prog2.done
    assert _rel_err(c2, matmul_ref(ta, tb)) < 2e-2
    assert _rel_err(c2, jax_matmul_ref(ja, jb)) < 2e-2


def test_pmm_geometry_and_window_picker():
    n_m, n_n, k_steps, total = grid_geometry(384, 256, 128, BLOCK)
    assert (n_m, n_n, k_steps, total) == (3, 2, 1, 6)
    assert pick_window(6, 4) == 3  # largest divisor <= 4
    assert pick_window(6, 7) == 6
    assert pick_window(5, 2) == 1
    with pytest.raises(ValueError):
        grid_geometry(100, 128, 128, BLOCK)


# ---------------------------------------------------------------------------
# the plain version and the wrapper's contract
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start,window", [(0, 1), (1, 4), (2, 3), (0, 6), (5, 1)])
def test_plain_window_equals_oracle_and_jax(start, window):
    """Windows that start mid-row and span rows, with a non-zero
    accumulator: the in-place plain version equals both oracles."""
    M, K, N = 256, 256, 384
    ja, ta = _pair((M, K), 6)
    jb, tb = _pair((K, N), 7)
    jc, c = _pair((M, N), 8)
    want = matmul_window_ref(ta, tb, c.clone(), start, window, BLOCK)
    want_jax = np.asarray(jax_window_ref(ja, jb, jc, start, window, BLOCK))
    got = matmul_window_plain(ta, tb, c, start, window, BLOCK)
    assert got is c
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, b = torch.zeros(128, 128), torch.zeros(128, 256)
    c = torch.zeros(128, 256)
    kw = dict(block=BLOCK, window=1, n_tiles_n=2, k_steps=1)
    with pytest.raises(ValueError, match="float32"):
        matmul_window_call(0, a, b, c.double(), **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul_window_call(0, a.half(), b.half(), c, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_window_call(0, a, torch.zeros(256, 128).t(), c, **kw)
    with pytest.raises(ValueError, match="outside"):
        matmul_window_call(1, a, b, c, block=BLOCK, window=2, n_tiles_n=2, k_steps=1)
    with pytest.raises(ValueError, match="shapes disagree"):
        matmul_window_call(0, a, b, torch.zeros(128, 128), **kw)
    # neither CPU nor CUDA: no plain fallback, no kernel
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul_window_call(
            0, a.to("meta"), b.to("meta"), c.to("meta"), **kw
        )


def test_cpu_path_counts_no_launch():
    before = matmul_window_call.launches
    matmul(torch.ones(128, 128), torch.ones(128, 128))
    assert matmul_window_call.launches == before


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does: on the int32 view, add half
    of the 13 dropped bits to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_emulation_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, 1 + 2**-11 + 2**-20, -(1 + 2**-11), 1 + 2**-12, 3.0])
    assert _tf32(x).tolist() == [1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]


def test_three_tf32_products_meet_the_card_bound_and_one_does_not():
    """The CUDA window kernel multiplies fp32 operands on the tensor cores
    as three TF32 products (a_lo b_hi + a_hi b_lo + a_hi b_hi, with hi =
    tf32(x) and lo = tf32(x - hi)). At the largest main-path window
    (M 128, K 1664, N 3072, all 24 tiles), with the card check's inputs,
    that stays within the check's 1e-5 of the max against the plain fp32
    version; one TF32 product misses it."""
    M, K, N = 128, 1664, 3072
    rng = np.random.default_rng(15)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)) / K**0.5
    c0 = torch.from_numpy(rng.standard_normal((M, N), dtype=np.float32))
    _, n_n, _, total = grid_geometry(M, N, K, BLOCK)
    want = matmul_window_plain(a, b, c0.clone(), 0, total, BLOCK)
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    three = c0 + ((a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi)
    one = c0 + a_hi @ b_hi
    assert _rel_err(three, want) <= 1e-5
    assert _rel_err(one, want) > 1e-5


def test_pad_operands_round_trip():
    a = torch.randn(100, 70, generator=torch.Generator().manual_seed(0))
    b = torch.randn(70, 200, generator=torch.Generator().manual_seed(1))
    ap, bp, unpad = pad_operands(a, b, BLOCK)
    assert ap.shape == (128, 128) and bp.shape == (128, 256)
    np.testing.assert_allclose(unpad(matmul(ap, bp)), a @ b, rtol=1e-5, atol=1e-5)
