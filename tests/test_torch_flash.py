"""The port's flash attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it (the Pallas kernel in interpret
mode, and its materialised oracle ``attention_ref``); the port's side is
its plain version, which is what its wrapper takes for CPU tensors.
Causal only, as the LM path uses it; MHA and GQA; sequence lengths that
64 does not divide (the CUDA kernel's block), and one that it does.

Tolerances: element by element, |got - want| <= rtol |want| + floor
rms(want), the measure the CUDA kernel is held to on the card
(``flash_attention.ref.tol_ratio``). In float32 both sides compute the
same fp32 softmax in another summation order: (1e-5, 1e-4). In bfloat16
both keep fp32 statistics and round the output to bf16 once, so they
differ by at most one bf16 ulp of each value: (2^-7, 1e-3). The
log-sum-exp the forward hands to the backward is fp32 on both sides,
from the same fp32 scores summed in another order: 1e-5.

The bf16 backward kernel's arithmetic (P from the forward's log-sum-exp,
P and dS fed to the tensor cores as bf16 hi + lo, fp32 sums over 64-row
tiles) is emulated here, where no card is, and held to the bound the
card holds the kernel to (``BACKWARD_TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_call,
    flash_attention_call,
)
from repro_torch.kernels.flash_attention.ref import (
    BACKWARD_TOL,
    LOG2E,
    NEG_INF,
    attention_backward_plain,
    attention_plain,
    tol_ratio,
)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_torch(jx, dtype):
    """A JAX output as a CPU tensor of the test's dtype (exact)."""
    return torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(DTYPES[dtype][1])


def _pair(shape, seed, dtype):
    """The same values as a JAX array and a CPU tensor (bf16 rounding is
    done once, by JAX, and carried across exactly)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dtype][0])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dtype][1])
    return jx, tx


def _qkv(B, S, H, Hkv, hd, dtype, seed=0):
    q = _pair((B, S, H, hd), seed, dtype)
    k = _pair((B, S, Hkv, hd), seed + 1, dtype)
    v = _pair((B, S, Hkv, hd), seed + 2, dtype)
    return q, k, v


@pytest.mark.parametrize("hd", [16, 32])  # the CUDA kernels' narrow widths
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "S,H,Hkv", [(72, 4, 4), (100, 8, 2), (120, 4, 1), (64, 4, 2)]
)
def test_plain_matches_pallas_kernel_and_oracle(dtype, S, H, Hkv, hd):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, S, H, Hkv, hd, dtype, seed=S + H)
    got = flash_attention(tq, tk, tv)
    assert got.shape == (2, S, H, hd)
    assert tol_ratio(got, _as_torch(ref_flash(jq, jk, jv), dtype)) <= 1.0
    assert tol_ratio(got, _as_torch(attention_ref(jq, jk, jv), dtype)) <= 1.0


def _pv(p, v, p_split):
    """The P V product of one K/V block, P fed as the kernel feeds it:
    fp32 (the SIMT kernel), "hi_lo" (the tensor-core kernel: P_hi =
    bf16(P) and P_lo = bf16(P - P_hi), both products summed in fp32) or
    "bf16" (P rounded to bf16 once, as a textbook tensor-core kernel)."""
    if p_split is None:
        return torch.einsum("bqk,bkd->bqd", p, v)
    hi = p.bfloat16().float()
    out = torch.einsum("bqk,bkd->bqd", hi, v)
    if p_split == "hi_lo":
        out = out + torch.einsum("bqk,bkd->bqd", (p - hi).bfloat16().float(), v)
    return out


def _online_softmax(q, k, v, block=64, p_split=None):
    """Causal GQA attention in the CUDA kernel's order: 64-row query
    blocks sweep 64-row K/V blocks to the diagonal with a running max,
    sum and accumulator in fp32, and the output rounds once at the end.
    ``p_split`` says how P enters the P V product (`_pv`); the row sums
    are always taken from the fp32 P."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((B, S, H, hd))
    for h in range(H):
        kh, vh = kf[:, :, h // group], vf[:, :, h // group]
        for q0 in range(0, S, block):
            qb = qf[:, q0:q0 + block, h]
            rows = torch.arange(q0, q0 + qb.shape[1])[:, None]
            m = torch.full(qb.shape[:2], NEG_INF)
            l = torch.zeros(qb.shape[:2])
            acc = torch.zeros(qb.shape)
            for k0 in range(0, q0 + qb.shape[1], block):
                s = torch.einsum("bqd,bkd->bqk", qb, kh[:, k0:k0 + block]) * hd**-0.5
                cols = torch.arange(k0, k0 + s.shape[2])[None]
                s = s.masked_fill(cols > rows, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + _pv(p, vh[:, k0:k0 + block], p_split)
                m = m_new
            out[:, q0:q0 + block, h] = acc / l[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tolerance_passes_online_order_and_catches_late_rows(dtype):
    """The card's measure accepts the kernel's own arithmetic (an online
    softmax over 64-row blocks) and refuses a kernel that is 2% wrong on
    the later half of the rows, whose values are far smaller than row 0's
    (the largest |want| is row 0 = v[0] under causal attention)."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 600, 2, 1, 64, dtype, seed=11)
    want = attention_plain(tq, tk, tv)
    got = _online_softmax(tq, tk, tv)
    assert tol_ratio(got, want) <= 1.0
    wrong = got.float()
    wrong[:, 300:] *= 1.02
    assert tol_ratio(wrong.to(want.dtype), want) > 1.0


def test_tensor_core_p_split_meets_the_bound_and_plain_bf16_p_does_not():
    """The bf16 CUDA kernel multiplies P V on the tensor cores. With P
    fed as P_hi + P_lo (two bf16 terms, one fp32 sum) it stays within
    the kernel's bound (one bf16 ulp of each output), at the head width
    and a prompt length of the LM path; with P rounded to bf16 once it
    does not, so the bound is what forces the split."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 1024, 4, 2, 128, "bfloat16", seed=21)
    want = attention_plain(tq, tk, tv)
    assert tol_ratio(_online_softmax(tq, tk, tv, p_split="hi_lo"), want) <= 1.0
    assert tol_ratio(_online_softmax(tq, tk, tv, p_split="bf16"), want) > 1.0


def test_output_keeps_q_dtype_and_head_mapping():
    """Query head h reads KV head h // (H // Hkv): with one KV head per
    group made distinct, each group of query heads sees only its own."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 40, 6, 3, 16, "bfloat16", seed=3)
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    for h in range(6):
        kv = h // 2
        one = attention_plain(tq[:, :, h:h + 1], tk[:, :, kv:kv + 1],
                              tv[:, :, kv:kv + 1])
        assert torch.equal(out[:, :, h:h + 1], one)


def test_causal_rows_ignore_the_future():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 50, 2, 2, 16, "float32", seed=5)
    full = flash_attention(tq, tk, tv)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 30:] = 7.0
    tv2[:, 30:] = -7.0
    part = flash_attention(tq, tk2, tv2)
    assert torch.allclose(full[:, :30], part[:, :30], rtol=0, atol=0)
    assert not torch.allclose(full[:, 30:], part[:, 30:])


def test_cpu_wrapper_counts_nothing_and_checks_shapes():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 16, 4, 2, 16, "float32")
    before = flash_attention_call.launches
    flash_attention_call(tq, tk, tv)
    assert flash_attention_call.launches == before
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_call(tq, tk[:, :, :1].expand(-1, -1, 3, -1), tv[:, :, :1].expand(-1, -1, 3, -1))
    with pytest.raises(ValueError, match="disagree"):
        flash_attention_call(tq, tk[:, :8], tv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_call(tq.double(), tk.double(), tv.double())


# ---------------------------------------------------------------------------
# the log-sum-exp the forward hands to the backward
# ---------------------------------------------------------------------------
#: the forward's lse (fp32) against the JAX reference's, from the same
#: fp32 scores summed in another order
LSE_TOL = 1e-5


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv", [(72, 4, 4), (100, 8, 2)])
def test_plain_lse_matches_jax_logsumexp(dtype, causal, S, H, Hkv, hd):
    """The lse the CPU path of `flash_attention_call` returns is
    ``jax.nn.logsumexp`` of the JAX reference's scaled, masked scores
    (``attention_ref``'s), in base 2; its output is the same bits as
    without lse."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, S, H, Hkv, hd, dtype, seed=S + 7)
    got_o, got = flash_attention_call(tq, tk, tv, causal=causal, return_lse=True)
    assert got.dtype == torch.float32 and got.shape == (2, H, S)
    assert torch.equal(got_o, flash_attention_call(tq, tk, tv, causal=causal))
    kx = jnp.repeat(jk, H // Hkv, axis=2).astype(jnp.float32)
    s = jnp.einsum("bqhd,bshd->bhqs", jq.astype(jnp.float32), kx) * (hd**-0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s, NEG_INF)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)) * LOG2E
    np.testing.assert_allclose(got.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)


def test_backward_wrapper_takes_the_forward_lse():
    """On the CPU the backward wrapper runs the plain gradient with P
    rebuilt from the lse it is given: the same gradients as the
    normalised softmax, within fp32 rounding; an lse of the wrong shape
    or type is refused."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 50, 4, 2, 16, "float32", seed=9)
    do = _qkv(1, 50, 4, 2, 16, "float32", seed=19)[0][1]
    o, lse = flash_attention_call(tq, tk, tv, return_lse=True)
    got = flash_attention_backward_call(tq, tk, tv, o, do, lse)
    want = attention_backward_plain(tq, tk, tv, o, do)
    for g, w in zip(got, want):
        assert tol_ratio(g, w, BACKWARD_TOL) <= 1.0
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_call(tq, tk, tv, o, do, lse[:, :2])
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_call(tq, tk, tv, o, do, lse.double())


# ---------------------------------------------------------------------------
# the bf16 backward kernel's numerics, tile by tile
# ---------------------------------------------------------------------------
def _feed(x, split):
    """An fp32 operand as the kernel feeds it to the tensor cores: fp32
    (``None``), two bf16 terms hi = bf16(x) and lo = bf16(x - hi) whose
    products are summed in fp32 ("hi_lo"), or one bf16 term ("bf16").
    Returned as the list of terms, each exact in fp32."""
    if split is None:
        return [x]
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split == "hi_lo" else [hi]


def _mm(a, b, split):
    """a b with a fed as `_feed` says and fp32 sums."""
    return sum(t @ b for t in _feed(a, split))


def _forward_lse(q, k, block=64):
    """Each row's log-sum-exp in base 2 as the bf16 forward kernel keeps
    it: a running max m in log2 units and a sum l over 64-key blocks up
    to the diagonal, lse = m + log2(l). q: (S, hd), k: (S, hd) fp32."""
    S, hd = q.shape
    sl2 = LOG2E * hd**-0.5
    lse = torch.empty(S)
    for q0 in range(0, S, block):
        rows = torch.arange(q0, min(q0 + block, S))[:, None]
        m = torch.full((len(rows),), NEG_INF)
        l = torch.zeros(len(rows))
        for k0 in range(0, q0 + len(rows), block):
            s = q[q0:q0 + block] @ k[k0:k0 + block].T
            cols = torch.arange(k0, k0 + s.shape[1])[None]
            s = s.masked_fill(cols > rows, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1) * sl2)
            p = torch.exp2(s * sl2 - m_new[:, None])
            l = torch.exp2(m - m_new) * l + p.sum(-1)
            m = m_new
        lse[q0:q0 + block] = m + torch.log2(l)
    return lse


def _tiled_backward(q, k, v, o, do, *, p_split, ds_split, block=64):
    """Causal GQA attention's (dq, dk, dv) in the bf16 kernel's order:
    the dK/dV pass walks, per 64-key tile, the group's heads and the
    64-query tiles at or below the diagonal; the dQ pass walks, per
    64-query tile, the key tiles up to it. P^T and dS^T are rebuilt from
    the forward's lse and D = rowsum(dO O), masked, and fed to their
    products as ``p_split`` / ``ds_split`` say (`_feed`); s and dP are
    exact products of the bf16 inputs; every sum is fp32; each gradient
    is rounded once."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    sl2, scale = LOG2E * hd**-0.5, hd**-0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), torch.zeros(vf.shape)
    for b in range(B):
        for kvh in range(Hkv):
            heads = range(kvh * group, (kvh + 1) * group)
            lse = {h: _forward_lse(qf[b, :, h], kf[b, :, kvh]) for h in heads}
            dd = {h: (dof[b, :, h] * of[b, :, h]).sum(-1) for h in heads}
            kk, vv = kf[b, :, kvh], vf[b, :, kvh]
            for k0 in range(0, S, block):
                kt, vt = kk[k0:k0 + block], vv[k0:k0 + block]
                keys = torch.arange(k0, k0 + len(kt))[:, None]
                acc_k, acc_v = torch.zeros(kt.shape), torch.zeros(vt.shape)
                for h in heads:
                    for q0 in range(k0, S, block):
                        qt, dot = qf[b, q0:q0 + block, h], dof[b, q0:q0 + block, h]
                        queries = torch.arange(q0, q0 + len(qt))[None]
                        st, dpt = kt @ qt.T, vt @ dot.T
                        pt = torch.exp2(st * sl2 - lse[h][q0:q0 + block][None])
                        dst = pt * (dpt - dd[h][q0:q0 + block][None])
                        keep = keys <= queries
                        pt, dst = pt * keep, dst * keep
                        acc_v += _mm(pt, dot, p_split)
                        acc_k += _mm(dst, qt, ds_split)
                dk[b, k0:k0 + block, kvh] = acc_k * scale
                dv[b, k0:k0 + block, kvh] = acc_v
            for h in heads:
                for q0 in range(0, S, block):
                    qt, dot = qf[b, q0:q0 + block, h], dof[b, q0:q0 + block, h]
                    rows = torch.arange(q0, q0 + len(qt))[:, None]
                    acc = torch.zeros(qt.shape)
                    for k0 in range(0, q0 + len(qt), block):
                        kt, vt = kk[k0:k0 + block], vv[k0:k0 + block]
                        cols = torch.arange(k0, k0 + len(kt))[None]
                        p = torch.exp2((qt @ kt.T) * sl2 - lse[h][q0:q0 + block][:, None])
                        ds = p * ((dot @ vt.T) - dd[h][q0:q0 + block][:, None])
                        acc += _mm(ds * (cols <= rows), kt, ds_split)
                    dq[b, q0:q0 + block, h] = acc * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def test_backward_split_meets_the_bound_and_single_bf16_p_or_ds_does_not():
    """The bf16 backward kernel feeds P and dS to the tensor cores. With
    each as hi + lo (two bf16 terms, one fp32 sum) all three gradients
    stay within the kernel's bound (`BACKWARD_TOL`, one bf16 ulp of each
    gradient) at a head width and sequence length of the training path;
    with P rounded to bf16 once dv does not, and with dS rounded once dq
    and dk do not: the bound is what forces both splits."""
    (_, tq), (_, tk), (_, tv) = _qkv(1, 1024, 2, 1, 64, "bfloat16", seed=31)
    do = _qkv(1, 1024, 2, 1, 64, "bfloat16", seed=41)[0][1]
    o = attention_plain(tq, tk, tv)
    want = attention_backward_plain(tq, tk, tv, o, do)

    def ratios(p_split, ds_split):
        got = _tiled_backward(tq, tk, tv, o, do, p_split=p_split, ds_split=ds_split)
        return [tol_ratio(g, w, BACKWARD_TOL) for g, w in zip(got, want)]

    assert max(ratios("hi_lo", "hi_lo")) <= 1.0
    assert ratios("bf16", "hi_lo")[2] > 1.0  # dv
    dq_r, dk_r, _ = ratios("hi_lo", "bf16")
    assert dq_r > 1.0 and dk_r > 1.0

