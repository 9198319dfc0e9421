"""The port's CUDA kernels (preemptible matmul, flash attention, WKV-6,
the selective scan) against their plain versions, on the card. Marked ``cuda``; each test skips, with its reason, where no card
is visible. Imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the window kernel's fp32 path (three TF32 products on the
tensor cores) is fp32-exact to 1e-5 of the max; bf16 inputs are exact
products on both sides (2e-2, as the reference's bf16 tests). Flash attention: the kernel and
the plain version both keep fp32 statistics and differ in summation
order and the online rescale; each output element is held to its own
size, |got - want| <= rtol |want| + floor rms(want), with (rtol, floor)
from ``flash_attention.ref.KERNEL_TOL``: (1e-5, 1e-4) for fp32 and
(2^-7, 1e-3) for bf16, one bf16 ulp of each value.
WKV-6: the kernel's exact step-by-step recurrence against the plain
chunked form, whose ``k / prod(w)`` rescale loses a few more digits
(1e-4 of the max, as the reference's own kernel test); where the
kernel must ignore what lies outside its (batch row, head), or run
twice on the same inputs, the result is held bit for bit. Selective scan:
the kernel's step-by-step recurrence against the plain chunked scan,
which multiplies the same decays in another order (1e-4 of the max, the
reference's tolerance between its kernel and its oracle); held bit for
bit where the kernel must ignore another batch row or run twice. int8-KV
decode step: the card's bf16-operand, fp32-result products against the
CPU's fp32 products of the same bf16-rounded operands, which differ only
in summation order (1e-5 of the max in fp32; relative L2 3e-2 in bf16,
where the output's own rounding may flip), with equal codes and scales.
The gateway and the sharded gateway (provisioned, migrating,
autoscaled) on the card run through ``chip_smoke.py``'s gateway and
sharded-phase helpers at a reduced size, with those phases' checks:
report (and for the sharded runs trace) equal to the CPU run's, one
launch per window, every completed job's chained output within
``CHAIN_REL_TOL`` of float64.
"""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from repro_torch.configs import load_config, smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_call
from repro_torch.kernels.flash_attention.ref import attention_plain, tol_ratio
from repro_torch.kernels.mamba_scan.kernel import STAGE_STEPS as SCAN_STAGE_STEPS
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_call
from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain
from repro_torch.kernels.preemptible_matmul import grid_geometry, matmul_resumable
from repro_torch.kernels.preemptible_matmul.kernel import matmul_window_call
from repro_torch.kernels.preemptible_matmul.ref import (
    matmul_ref,
    matmul_window_plain,
)
from repro_torch.kernels.rwkv6_scan.kernel import STAGE_STEPS, rwkv6_scan_call
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_plain
from repro_torch.models import layers as L

BLOCK = (128, 128, 128)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(x, y):
    return ((x - y).abs().max() / y.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "M,K,N,start,window",
    [(128, 128, 128, 0, 1), (128, 1664, 3072, 0, 24), (128, 3072, 768, 2, 3),
     (1024, 512, 1024, 6, 2), (256, 384, 384, 2, 3),
     (256, 1664, 768, 4, 4),  # tiles 4, 5 | 6, 7: across a tile row
     (256, 1664, 3072, 20, 24)],  # wide blocks, across a tile row
)
def test_kernel_window_matches_plain(card, dtype, M, K, N, start, window):
    gen = torch.Generator(device=card).manual_seed(M + K + N)
    a = torch.randn((M, K), generator=gen, device=card).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=card) / math.sqrt(K)).to(dtype)
    c0 = torch.randn((M, N), generator=gen, device=card)
    _, n_n, k_steps, _ = grid_geometry(M, N, K, BLOCK)
    before = matmul_window_call.launches
    got = matmul_window_call(start, a, b, c0.clone(), block=BLOCK,
                             window=window, n_tiles_n=n_n, k_steps=k_steps)
    assert matmul_window_call.launches == before + 1
    want = matmul_window_plain(a, b, c0.clone(), start, window, BLOCK)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,window", [(96, 2), (1632, 24)])
def test_kernel_window_takes_any_k_multiple_of_32(card, dtype, K, window):
    """The bf16 path stages K in 64-deep slices: a K that is an odd
    multiple of 32 ends on a half slice, which must read as zeros. Both
    block shapes: 2 tiles take the narrow one, 24 the wide one."""
    M, N, block = 128, 3072, (128, 32, 128)
    gen = torch.Generator(device=card).manual_seed(K)
    a = torch.randn((M, K), generator=gen, device=card).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=card) / math.sqrt(K)).to(dtype)
    c0 = torch.randn((M, N), generator=gen, device=card)
    _, n_n, k_steps, _ = grid_geometry(M, N, K, block)
    got = matmul_window_call(0, a, b, c0.clone(), block=block, window=window,
                             n_tiles_n=n_n, k_steps=k_steps)
    want = matmul_window_plain(a, b, c0.clone(), 0, window, block)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_window_is_bit_identical_across_launches(card, dtype):
    """Each output element is summed by one block in one fixed order (no
    split-K, no atomics), so the same operands give the same bits."""
    M, K, N = 128, 1664, 3072
    gen = torch.Generator(device=card).manual_seed(7)
    a = torch.randn((M, K), generator=gen, device=card).to(dtype)
    b = (torch.randn((K, N), generator=gen, device=card) / math.sqrt(K)).to(dtype)
    c0 = torch.randn((M, N), generator=gen, device=card)
    _, n_n, k_steps, total = grid_geometry(M, N, K, BLOCK)
    kw = dict(block=BLOCK, window=total, n_tiles_n=n_n, k_steps=k_steps)
    first = matmul_window_call(0, a, b, c0.clone(), **kw)
    second = matmul_window_call(0, a, b, c0.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_preempt_resume_identity(card):
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn((512, 256), generator=gen, device=card)
    b = torch.randn((256, 384), generator=gen, device=card)
    c1, prog = matmul_resumable(a, b, block=BLOCK, window_tiles=2, max_windows=2)
    assert prog.next_tile == 4 and not prog.done
    matmul_resumable(b.t().contiguous(), a.t().contiguous(), block=BLOCK)
    c2, prog2 = matmul_resumable(a, b, block=BLOCK, window_tiles=2,
                                 start_tile=prog.next_tile, c_acc=c1)
    assert prog2.done
    assert _rel(c2, matmul_ref(a, b)) <= 1e-5


@pytest.mark.cuda
def test_kernel_refuses_blocks_it_does_not_take(card):
    a = torch.zeros((64, 64), device=card)
    with pytest.raises(ValueError, match="block"):
        matmul_window_call(0, a, a, a.clone(), block=(64, 64, 64), window=1,
                           n_tiles_n=1, k_steps=1)


def _qkv(card, B, S, H, Hkv, hd, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=card).to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=card).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,Hkv,hd,causal",
    [(2, 256, 32, 8, 128, True), (1, 1000, 4, 4, 64, True),
     (2, 77, 8, 1, 128, True), (1, 200, 4, 2, 64, False),
     (2, 1000, 8, 2, 64, True), (2, 1000, 8, 2, 128, False),
     (2, 77, 4, 2, 64, False)],
)
def test_flash_kernel_matches_plain(card, dtype, B, S, H, Hkv, hd, causal):
    q, k, v = _qkv(card, B, S, H, Hkv, hd, dtype, S + H)
    before = flash_attention_call.launches
    got = flash_attention_call(q, k, v, causal=causal)
    assert flash_attention_call.launches == before + 1
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert tol_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd", [(1000, 64), (1000, 128), (77, 64), (77, 128)])
def test_flash_kernel_ragged_tile_never_reads_the_next_batch(card, S, hd, causal):
    """With B = 2 the memory past batch 0's last position is batch 1's.
    Fill batch 1 with NaN: batch 0's ragged last K/V tile must read zeros
    there (the kernel's tensor maps run over (hd, heads, S, B)), or a
    masked probability of 0 times NaN poisons its rows."""
    q, k, v = _qkv(card, 2, S, 8, 2, hd, torch.bfloat16, S + hd)
    for t in (q, k, v):
        t[1] = float("nan")
    got = flash_attention_call(q, k, v, causal=causal)
    want = attention_plain(q[:1], k[:1], v[:1], causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
    assert tol_ratio(got[:1], want) <= 1.0


@pytest.mark.cuda
def test_kernels_refuse_misaligned_operands(card):
    """Contiguous views that start 4 bytes into their storage: the window
    kernel copies 16-byte pieces and TMA reads 16-byte aligned rows."""
    def shifted(shape, dtype):
        n, skip = math.prod(shape), 4 // torch.tensor([], dtype=dtype).element_size()
        return torch.zeros(n + skip, dtype=dtype, device=card)[skip:].view(shape)

    a = shifted((128, 128), torch.float32)
    b = torch.zeros((128, 128), device=card)
    before = matmul_window_call.launches
    with pytest.raises(ValueError, match="aligned"):
        matmul_window_call(0, a, b, torch.zeros_like(b), block=BLOCK,
                           window=1, n_tiles_n=1, k_steps=1)
    assert matmul_window_call.launches == before
    q = shifted((1, 64, 2, 64), torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=card)
    before = flash_attention_call.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_call(q, k, k)
    assert flash_attention_call.launches == before


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_widths(card):
    q, k, v = _qkv(card, 1, 64, 2, 2, 96, torch.bfloat16, 0)
    before = flash_attention_call.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_call(q, k, v)
    assert flash_attention_call.launches == before


def _wkv_inputs(card, B, S, H, hd, seed, logit=None):
    """As the model feeds the scan: decay logits normal, clamped to the
    model's [-8, -1], or all equal to ``logit``."""
    gen = torch.Generator(device=card).manual_seed(seed)
    r = torch.randn((B, S, H, hd), generator=gen, device=card)
    k = torch.randn((B, S, H, hd), generator=gen, device=card) * 0.3
    v = torch.randn((B, S, H, hd), generator=gen, device=card)
    logits = torch.randn((B, S, H, hd), generator=gen, device=card).clamp(-8, -1)
    if logit is not None:
        logits = torch.full_like(logits, logit)
    w = torch.exp(-torch.exp(logits))
    u = torch.randn((H, hd), generator=gen, device=card) * 0.1
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,logit",
    [(2, 256, 8, None), (1, 1000, 4, None), (1, 37, 2, None),
     # S at and around one TMA stage of the kernel, and past 2048
     (1, 1, 2, None), (1, STAGE_STEPS - 1, 2, None), (1, STAGE_STEPS, 2, None),
     (1, STAGE_STEPS + 1, 2, None), (1, 2049, 2, None),
     (2, 256, 64, None),  # the main path's B·H
     (1, 1000, 4, -8.0), (1, 1000, 4, -1.0)],  # decays at both clamp ends
)
def test_wkv6_kernel_matches_plain(card, B, S, H, logit):
    r, k, v, w, u = _wkv_inputs(card, B, S, H, 64, S, logit)
    before = rwkv6_scan_call.launches
    y, s_final = rwkv6_scan_call(r, k, v, w, u)
    assert rwkv6_scan_call.launches == before + 1
    y_want, s_want = rwkv6_scan_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert _rel(y, y_want) <= 1e-4
    assert _rel(s_final, s_want) <= 1e-4


def _nan_tailed(x):
    """``x`` copied to the front of a larger buffer whose tail is NaN:
    contiguous and aligned, with NaN past its last element."""
    buf = torch.full((x.numel() + 64 * 64,), float("nan"), device=x.device)
    buf[: x.numel()] = x.flatten()
    return buf[: x.numel()].view(x.shape)


@pytest.mark.cuda
def test_wkv6_kernel_reads_only_its_own_batch_row_and_head(card):
    """NaN in batch row 1, in head 1 of batch row 0, and past the end of
    the tensors; S ragged against the stage. Heads 0 and 2 of batch row 0
    must come out finite and equal to a clean run's, bit for bit."""
    B, S, H = 2, STAGE_STEPS + 13, 3
    clean = _wkv_inputs(card, B, S, H, 64, 7)
    y_clean, s_clean = rwkv6_scan_call(*clean)
    dirty = []
    for x in clean[:4]:
        x = x.clone()
        x[1] = float("nan")
        x[0, :, 1] = float("nan")
        dirty.append(_nan_tailed(x))
    u = clean[4].clone()
    u[1] = float("nan")
    y, s_final = rwkv6_scan_call(*dirty, u)
    torch.cuda.synchronize()
    for h in (0, 2):
        assert torch.isfinite(y[0, :, h]).all() and torch.isfinite(s_final[0, h]).all()
        assert torch.equal(y[0, :, h], y_clean[0, :, h])
        assert torch.equal(s_final[0, h], s_clean[0, h])


@pytest.mark.cuda
def test_wkv6_kernel_is_deterministic(card):
    """Two launches on the same inputs: bit-identical y and state."""
    ops = _wkv_inputs(card, 2, 256, 64, 64, 3)
    y1, s1 = rwkv6_scan_call(*ops)
    y2, s2 = rwkv6_scan_call(*ops)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_wkv6_kernel_refuses_what_it_does_not_take(card):
    r, k, v, w, u = _wkv_inputs(card, 1, 16, 2, 32, 0)
    before = rwkv6_scan_call.launches
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan_call(r, k, v, w, u)
    r, k, v, w, u = _wkv_inputs(card, 1, 16, 2, 64, 0)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan_call(r.bfloat16(), k, v, w, u)
    shifted = torch.empty(r.numel() + 1, device=card)[1:].view(r.shape)
    shifted.copy_(r)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        rwkv6_scan_call(shifted, k, v, w, u)
    assert rwkv6_scan_call.launches == before


def _scan_inputs(card, B, S, di, ns, seed, h0=False, a="init"):
    """As the model feeds the scan: dt = softplus(normal - 2), B, C, x
    normal; h0 zero or normal. A is the model's init, -(1..ns) on every
    row (``a="init"``), or drawn per element, -exp(normal(0.5, 1.5)), so
    that no two rows share a decay (``"random"``); ``"underflow"`` also
    sets dt to 50 on every 16th step, so that dt * A reaches -1e3 and the
    decays flush to 0."""
    gen = torch.Generator(device=card).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device=card) - 2.0)
    Bm = torch.randn((B, S, ns), generator=gen, device=card)
    Cm = torch.randn((B, S, ns), generator=gen, device=card)
    x = torch.randn((B, S, di), generator=gen, device=card)
    if a == "init":
        A = -torch.arange(1, ns + 1, dtype=torch.float32, device=card).expand(di, ns).contiguous()
    else:
        A = -torch.exp(0.5 + 1.5 * torch.randn((di, ns), generator=gen, device=card))
    if a == "underflow":
        dt[:, ::16] = 50.0
        assert (dt[..., None] * A).min().item() < -1e3
    h = (torch.randn((B, di, ns), generator=gen, device=card) if h0
         else torch.zeros((B, di, ns), device=card))
    return dt, Bm, Cm, x, A, h


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,di,h0,a",
    [(2, 256, 512, False, "init"), (1, 1000, 8192, False, "init"),
     (2, 77, 96, True, "init"), (3, 64, 8200, True, "init"),
     # S at and around one TMA stage of the kernel, and past 2048
     (1, 1, 96, True, "random"), (1, SCAN_STAGE_STEPS - 1, 96, True, "random"),
     (1, SCAN_STAGE_STEPS, 96, True, "random"),
     (1, SCAN_STAGE_STEPS + 1, 96, True, "random"), (2, 1000, 96, True, "random"),
     (1, 2049, 96, True, "random"),
     (1, 16, 96, True, "random"), (1, 17, 96, True, "random"),  # its 16-step groups
     # d_inner not a multiple of the block's channels
     (3, 100, 8200, True, "random"), (3, 40, 100, True, "random"),
     (2, 2048, 8192, True, "random"),  # the main path's shape, A per element
     (2, 300, 512, True, "underflow")],
)
def test_mamba_scan_kernel_matches_plain(card, B, S, di, h0, a):
    """Ragged S, d_inner not a multiple of the block, non-zero h0, A per
    element, decays that flush to 0."""
    ops = _scan_inputs(card, B, S, di, 16, S + di, h0, a)
    before = mamba_scan_call.launches
    y, h = mamba_scan_call(*ops, chunk=64)
    assert mamba_scan_call.launches == before + 1
    y_want, h_want = mamba_scan_plain(*ops, chunk=64)
    torch.cuda.synchronize()
    assert y.shape == (B, S, di) and h.shape == (B, di, 16)
    assert bool(torch.isfinite(y).all() and torch.isfinite(h).all())
    assert _rel(y, y_want) <= 1e-4
    assert _rel(h, h_want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dirty", [0, 1])
def test_mamba_scan_kernel_reads_only_its_own_batch_row(card, dirty):
    """NaN in every operand's batch row ``dirty`` and past the end of
    dt, B, C and x, with S ragged against the stage: the other batch row
    comes out finite and equal to a clean run's, bit for bit. Its steps
    past S are the dirty row's first steps (row 0 clean) or the NaN tail
    (row 1 clean)."""
    B, S, di = 2, SCAN_STAGE_STEPS + 13, 100
    clean = _scan_inputs(card, B, S, di, 16, 7, True, "random")
    y_clean, h_clean = mamba_scan_call(*clean, chunk=64)
    dt, Bm, Cm, x, A, h0 = (t.clone() for t in clean)
    for t in (dt, Bm, Cm, x, h0):
        t[dirty] = float("nan")
    dt, Bm, Cm, x = (_nan_tailed(t) for t in (dt, Bm, Cm, x))
    y, h = mamba_scan_call(dt, Bm, Cm, x, A, h0, chunk=64)
    torch.cuda.synchronize()
    keep = 1 - dirty
    assert bool(torch.isfinite(y[keep]).all() and torch.isfinite(h[keep]).all())
    assert torch.equal(y[keep], y_clean[keep])
    assert torch.equal(h[keep], h_clean[keep])


@pytest.mark.cuda
def test_mamba_scan_kernel_is_deterministic(card):
    """Two launches on the same inputs: bit-identical y and h."""
    ops = _scan_inputs(card, 2, 300, 8200, 16, 3, True, "random")
    y1, h1 = mamba_scan_call(*ops, chunk=64)
    y2, h2 = mamba_scan_call(*ops, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_mamba_scan_kernel_refuses_what_it_does_not_take(card):
    dt, Bm, Cm, x, A, h0 = _scan_inputs(card, 1, 16, 64, 16, 0)
    before = mamba_scan_call.launches
    with pytest.raises(ValueError, match="float32"):
        mamba_scan_call(dt.bfloat16(), Bm, Cm, x, A, h0, chunk=8)
    x_t = torch.randn((1, 64, 16), device=card).transpose(1, 2)  # (1, 16, 64)
    assert not x_t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_call(dt, Bm, Cm, x_t, A, h0, chunk=8)
    small = _scan_inputs(card, 1, 16, 64, 8, 0)
    with pytest.raises(ValueError, match="d_state 16"):
        mamba_scan_call(*small, chunk=8)
    ops = [dt, Bm, Cm, x, A, h0]
    for i in range(6):  # each operand 4 bytes into its storage
        shifted = torch.empty(ops[i].numel() + 1, device=card)[1:].view(ops[i].shape)
        shifted.copy_(ops[i])
        assert shifted.is_contiguous() and shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="aligned"):
            mamba_scan_call(*ops[:i], shifted, *ops[i + 1:], chunk=8)
    odd = _scan_inputs(card, 1, 16, 66, 16, 0)  # rows of 264 bytes
    with pytest.raises(ValueError, match="multiple of 4"):
        mamba_scan_call(*odd, chunk=8)
    assert mamba_scan_call.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_decode_q8_on_card_matches_cpu(card, dtype):
    """Two int8-KV decode steps over a quantized prompt cache, on the card
    and on the CPU from the same weights, cache and inputs. The prompt's
    codes stay as they were; the new tokens' codes may differ by one
    where K or V, projected in another summation order, lands on a
    rounding boundary."""
    cfg = smoke_config(load_config("jamba_v0_1_52b"))
    gen = torch.Generator().manual_seed(5)
    p = L.attn_init(gen, cfg, dtype, device="cpu")
    B, S, S_max = 2, 40, 48
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(dtype)
    _, kv = L.attention_prefill(p, x, cfg, torch.arange(S).expand(B, S), S_max)
    cache = {}
    for name in ("k", "v"):
        cache[name], cache[f"{name}_scale"] = L.quantize_kv(kv[name])
    p_card = {k: v.to(card) for k, v in p.items()}
    c_card = {k: v.to(card) for k, v in cache.items()}
    for i in range(2):
        xt = torch.randn((B, 1, cfg.d_model), generator=gen).to(dtype)
        pos = torch.full((B,), S + i)
        want, cache = L.attention_decode_q8(p, xt, cfg, cache, pos)
        got, c_card = L.attention_decode_q8(p_card, xt.to(card), cfg, c_card,
                                            pos.to(card))
        got = got.cpu()
        assert got.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            assert _rel(got, want) <= 1e-5
        else:
            err = ((got.float() - want.float()).norm() / want.float().norm()).item()
            assert err <= 3e-2
    for name in ("k", "v"):
        got = c_card[name].cpu()
        assert got.dtype == torch.int8
        assert torch.equal(got[:, :, :S], cache[name][:, :, :S])
        assert int((got.int() - cache[name].int()).abs().max()) <= 1


# ---------------------------------------------------------------------------
# the traffic gateway on the card, through chip_smoke.py's own gateway
# helpers (the ones its gateway phase drives at full size)
# ---------------------------------------------------------------------------
def _load_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _copilot_with_stablelm_blocks(smoke, n_blocks):
    """copilot_decode with its StableLM-1.6B decode tenant cut to
    ``n_blocks`` of its 24 blocks (5 layers each, plus the head) at full
    width, on the design the port's DSE picks for that cut."""
    from repro_torch.configs import load_config
    from repro_torch.core.rt.task import Task, TaskSet
    from repro_torch.models.extract import arch_workload

    scenario = smoke.get_scenario("copilot_decode")
    platform = smoke.paper_platform()
    workloads, taskset = smoke.resolve_problem(scenario, platform)
    cfg = dataclasses.replace(load_config("stablelm_1_6b"), n_layers=n_blocks)
    i = next(j for j, s in enumerate(scenario.tenants)
             if s.workload.startswith("config:stablelm_1_6b"))
    spec = scenario.tenants[i]
    workloads[i] = arch_workload(cfg, batch=spec.batch, seq=spec.seq, mode="decode")
    tasks = list(taskset.tasks)
    tasks[i] = Task(workload=workloads[i], period=tasks[i].period, name=tasks[i].name)
    taskset = TaskSet(tasks=tuple(tasks))
    res = smoke.explore(workloads, taskset, platform, **smoke.build_search())
    return smoke.materialize(scenario, workloads, taskset, res.best), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rush_hour", "copilot_decode"])
def test_gateway_on_card_equals_cpu_run_with_every_window_a_launch(card, name):
    """The gateway phase's virtual-clock run at a reduced size: rush_hour
    at full width for 20 periods; copilot_decode with StableLM-1.6B cut
    to 2 blocks (11 layers, full width) for 3 decode periods. Inside
    `gateway_run`: the card's report equals the port's CPU run of the
    same bundle, the kernel launches equal the windows plus the
    warm-up, and every tenant has one output checked against float64
    per completed job."""
    smoke = _load_smoke()
    if name == "rush_hour":
        built, _ = smoke.search_design(name)
        periods, lm = 20.0, None
    else:
        built, lm = _copilot_with_stablelm_blocks(smoke, 2)
        periods = 3.0
    run = smoke.gateway_run(built, periods, seed=7)
    sr = run["report"].server_report
    warm = sum(len(t.weights) for t in run["tasks"])
    assert run["launches"] == sr.windows_executed + warm
    assert [len(e) for e in run["errors"]] == [
        len(sr.response_times[t.name]) for t in run["tasks"]
    ]
    assert all(len(e) > 0 for e in run["errors"])
    assert run["err"] <= smoke.CHAIN_REL_TOL
    if lm is not None:
        assert len(run["tasks"][lm].weights) == 11


# ---------------------------------------------------------------------------
# the sharded gateway on the card, through chip_smoke.py's sharded-phase
# helpers (the ones its sharded phase drives)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["provisioned", "migration", "autoscale"])
def test_sharded_on_card_equals_cpu_run_with_every_window_a_launch(card, case):
    """The sharded phase's runs at full width and shorter horizons:
    sharded_city provisioned over 2 shards for 10 periods; the elastic
    fleet migrating its first tenant, 10 periods; the autoscaler's
    grow-and-shrink ramp over two copies of multi_tenant_rush, 2 periods
    a plateau. Inside `sharded_case`: the card's report, trace and
    trace metrics equal the port's CPU run, the kernel launches equal
    the windows plus each shard server's warm-up, and every completed
    job's chained output of every shard is within ``CHAIN_REL_TOL`` of
    float64."""
    smoke = _load_smoke()
    if case == "autoscale":
        population = smoke.replicate(
            smoke.search_design(smoke.AUTOSCALE_SCENARIO)[0], smoke.AUTOSCALE_COPIES)
        phases = smoke.autoscale_phases(population, periods=2.0)
        make = smoke.autoscale_run(population, phases)
    else:
        plan = smoke.provision_sharded()
        make = (smoke.provisioned_run(plan, periods=10.0) if case == "provisioned"
                else smoke.migration_run(plan.built, periods=10.0))
    run = smoke.sharded_case(case, make)
    tally = run["tally"]
    assert run["launches"] == tally["windows"] + tally["warmup"] > 0
    assert tally["outputs"] == tally["completed"] > 0
    assert tally["err"] <= smoke.CHAIN_REL_TOL
    if case == "migration":
        (rec,) = run["extra"]["records"]
        assert rec.committed and rec.target != rec.donor
    if case == "autoscale":
        shards = run["report"].shard_counts()
        assert shards[1] > shards[0] and shards[2] < shards[1]
