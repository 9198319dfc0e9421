"""The port's CUDA kernels (preemptible matmul, flash attention, WKV-6,
the selective scan, and the backward kernels of the last three) against
their plain versions, on the card. Marked ``cuda``; each test skips, with its reason, where no card
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
(2^-7, 1e-3) for bf16, one bf16 ulp of each value. Its log-sum-exp is
fp32 from the same fp32 scores as the plain version's (1e-4 absolute, a
few ulps of values ~10), and the output is the same bits with and
without it. The backward, fed that log-sum-exp, is held the same way to
``BACKWARD_TOL``, and bit for bit across launches.
WKV-6: the kernel's exact step-by-step recurrence against the plain
chunked form, whose ``k / prod(w)`` rescale loses a few more digits
(1e-4 of the max, as the reference's own kernel test); where the
kernel must ignore what lies outside its (batch row, head), or run
twice on the same inputs, the result is held bit for bit. Selective scan:
the kernel's step-by-step recurrence against the plain chunked scan,
which multiplies the same decays in another order (1e-4 of the max, the
reference's tolerance between its kernel and its oracle); held bit for
bit where the kernel must ignore another batch row or run twice. The
backward kernels of WKV-6 and the selective scan against their plain
versions (the plain WKV-6 backward a step-by-step recurrence, the plain
scan backward chunked scans): 1e-4 of the max, the forwards' bound, and
bit for bit across launches and where they must ignore another batch
row or head; smoke RWKV-6 and Jamba train steps on the card against the
CPU's as the StableLM one. int8-KV
decode step: the card's bf16-operand, fp32-result products against the
CPU's fp32 products of the same bf16-rounded operands, which differ only
in summation order (1e-5 of the max in fp32; relative L2 3e-2 in bf16,
where the output's own rounding may flip), with equal codes and scales.
The gateway and the sharded gateway (provisioned, migrating,
autoscaled) on the card run through ``chip_smoke.py``'s gateway and
sharded-phase helpers at a reduced size, with those phases' checks:
report (and for the sharded runs trace) equal to the CPU run's, one
launch per window, every completed job's chained output within
``CHAIN_REL_TOL`` of float64. The conformance harness on the card: the
calibration (host clock through the sync) covers each window's card
time, a `run_case` equals the CPU run's, and the wall-clock case at the
reference's own test settings comes back clean. The pipeline executor:
two stage ranks sharing the card over gloo give `reference_backbone`'s
output bit for bit (the same kernels at the same shapes in each
process), with one flash launch per microbatch per layer. The kernels'
custom ops: each ``repro_torch::`` op routes a card tensor to its
kernel, one launch, the direct call's bits. The SPMD policy:
`layers.moe_capacity` on the card against the CPU's (fp32, 1e-4 of the
max); smoke Granite-MoE through `lowerable` on a one-card mesh (fp32
logits against the NO_POLICY prefill, 1e-4); a `lowerable` train step
on a 2 x 2 mesh of four cards against one card (skips on fewer).
"""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from repro_torch.configs import load_config, smoke_config
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_call,
    flash_attention_call,
)
from repro_torch.kernels.flash_attention.ref import (
    BACKWARD_TOL,
    attention_backward_plain,
    attention_plain,
    tol_ratio,
)
from repro_torch.kernels.mamba_scan.kernel import BWD_CHANNELS as SCAN_BWD_CHANNELS
from repro_torch.kernels.mamba_scan.kernel import BWD_CHUNK as SCAN_BWD_CHUNK
from repro_torch.kernels.mamba_scan.kernel import STAGE_STEPS as SCAN_STAGE_STEPS
from repro_torch.kernels.mamba_scan.kernel import (
    mamba_scan_backward_call,
    mamba_scan_call,
)
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_backward_plain,
    mamba_scan_plain,
)
from repro_torch.kernels.preemptible_matmul import grid_geometry, matmul_resumable
from repro_torch.kernels.preemptible_matmul.kernel import matmul_window_call
from repro_torch.kernels.preemptible_matmul.ref import (
    matmul_ref,
    matmul_window_plain,
)
from repro_torch.kernels.rwkv6_scan.kernel import BWD_CHUNK as WKV_BWD_CHUNK
from repro_torch.kernels.rwkv6_scan.kernel import (
    STAGE_STEPS,
    rwkv6_scan_backward_call,
    rwkv6_scan_call,
)
from repro_torch.kernels.rwkv6_scan.ref import (
    rwkv6_scan_backward_plain,
    rwkv6_scan_plain,
)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,Hkv,hd,causal",
    [(2, 256, 32, 8, 128, True), (1, 1000, 4, 4, 64, True),
     (2, 77, 8, 1, 128, True), (1, 200, 4, 2, 64, False),
     (2, 130, 8, 2, 64, True), (1, 77, 4, 2, 128, False)],
)
def test_flash_backward_kernel_matches_plain(card, dtype, B, S, H, Hkv, hd, causal):
    """dq, dk, dv against the plain gradient formulas, from the forward
    kernel's own output and log-sum-exp; a second launch gives the same
    bits."""
    q, k, v = _qkv(card, B, S, H, Hkv, hd, dtype, S + H + 1)
    do = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(S),
                     device=card).to(dtype)
    o, lse = flash_attention_call(q, k, v, causal=causal, return_lse=True)
    before = flash_attention_backward_call.launches
    got = flash_attention_backward_call(q, k, v, o, do, lse, causal=causal)
    again = flash_attention_backward_call(q, k, v, o, do, lse, causal=causal)
    assert flash_attention_backward_call.launches == before + 2
    want = attention_backward_plain(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    for g, a, w, like in zip(got, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == like.shape
        assert torch.equal(g, a)
        assert tol_ratio(g, w, BACKWARD_TOL) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd", [(77, 64), (1000, 128)])
def test_flash_backward_ragged_tile_never_reads_the_next_batch(card, S, hd):
    """Batch 1 all NaN: batch 0's ragged last tiles must not read it."""
    q, k, v = _qkv(card, 2, S, 8, 2, hd, torch.bfloat16, S + hd + 2)
    do = torch.randn_like(q)
    o, lse = flash_attention_call(q, k, v, return_lse=True)
    for t in (q, k, v, o, do, lse):
        t[1] = float("nan")
    got = flash_attention_backward_call(q, k, v, o, do, lse)
    want = attention_backward_plain(q[:1], k[:1], v[:1], o[:1], do[:1])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g[0]).all())
        assert tol_ratio(g[:1], w, BACKWARD_TOL) <= 1.0


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(card):
    q, k, v = _qkv(card, 1, 64, 2, 2, 96, torch.bfloat16, 0)
    lse = torch.zeros((1, 2, 64), device=card)
    before = flash_attention_backward_call.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_backward_call(q, k, v, q, q, lse)
    q, k, v = _qkv(card, 1, 64, 2, 2, 64, torch.bfloat16, 0)
    strided = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=card)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_backward_call(q, k, v, q, strided, lse)
    with pytest.raises(ValueError, match="must match q"):
        flash_attention_backward_call(q, k, v, q, q.float(), lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_call(q, k, v, q, q, lse[:, :, :32])
    with pytest.raises(ValueError, match="lse"):
        flash_attention_backward_call(q, k, v, q, q, lse.bfloat16())
    shifted = torch.zeros(q.numel() + 2, dtype=torch.bfloat16, device=card)[2:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_backward_call(q, k, v, shifted, q, lse)
    assert flash_attention_backward_call.launches == before


#: the forward's log-sum-exp against the plain version's: fp32 from the
#: same fp32 scores summed in other orders, values ~10 (a few fp32 ulps)
LSE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,H,Hkv,hd,causal",
    [(2, 256, 32, 8, 128, True), (2, 77, 8, 1, 128, True),
     (1, 1000, 4, 4, 64, True), (1, 200, 4, 2, 64, False)],
)
def test_flash_forward_lse_matches_plain(card, dtype, B, S, H, Hkv, hd, causal):
    """The forward kernel's log-sum-exp (base 2) against the plain
    version's, and its output the same bits as without it."""
    q, k, v = _qkv(card, B, S, H, Hkv, hd, dtype, S + H + 3)
    before = flash_attention_call.launches
    o, lse = flash_attention_call(q, k, v, causal=causal, return_lse=True)
    assert flash_attention_call.launches == before + 1
    _, want = attention_plain(q, k, v, causal=causal, return_lse=True)
    plain_o = flash_attention_call(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert (lse - want).abs().max().item() <= LSE_TOL
    assert torch.equal(o, plain_o)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_forward_output_is_the_same_bits_with_and_without_lse(card, hd):
    """Serving runs the forward with no lse buffer, training with one:
    the output must not depend on it, at a prompt length of the LM path."""
    q, k, v = _qkv(card, 2, 2048, 32, 8, hd, torch.bfloat16, hd)
    without = flash_attention_call(q, k, v)
    with_lse, _ = flash_attention_call(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(without, with_lse)


@pytest.mark.cuda
def test_flash_backward_at_nemo_length_and_gqa_is_within_bound_and_deterministic(card):
    """S 2048, hd 128, 32 query heads over 8 KV heads (Mistral-NeMo's
    attention): every gradient within ``BACKWARD_TOL`` and two launches
    the same bits."""
    q, k, v = _qkv(card, 1, 2048, 32, 8, 128, torch.bfloat16, 2048)
    do = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(7),
                     device=card).bfloat16()
    o, lse = flash_attention_call(q, k, v, return_lse=True)
    got = flash_attention_backward_call(q, k, v, o, do, lse)
    again = flash_attention_backward_call(q, k, v, o, do, lse)
    want = attention_backward_plain(q, k, v, o, do)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert tol_ratio(g, w, BACKWARD_TOL) <= 1.0


@pytest.mark.cuda
def test_smoke_train_step_on_card_matches_cpu(card):
    """One AdamW step of smoke StableLM in fp32, head width 64 (the
    kernels' width), on the card and on the CPU from the same weights and
    batch: loss, grad norm and every parameter within 1e-4 (relative L2
    for the parameters), through one forward launch per layer, one more
    under remat and one backward launch per layer."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten, tree_map

    cfg = dataclasses.replace(smoke_config(load_config("stablelm_1_6b")), head_dim=64)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 96), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 96), generator=gen),
             "mask": torch.ones((2, 96))}
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1))
    results = {}
    for device in ("cpu", card):
        p = tree_map(lambda t: t.to(device), params)
        fwd, bwd = flash_attention_call.launches, flash_attention_backward_call.launches
        new, _, m = step(p, adamw_init(p), {k: v.to(device) for k, v in batch.items()})
        if device == card:
            torch.cuda.synchronize()
            assert flash_attention_call.launches - fwd == 2 * cfg.n_layers
            assert flash_attention_backward_call.launches - bwd == cfg.n_layers
        results[str(device)] = (new, m)
    (cpu_p, cpu_m), (card_p, card_m) = results["cpu"], results[str(card)]
    for key in ("loss", "grad_norm"):
        assert abs(card_m[key].item() - cpu_m[key].item()) <= 1e-4 * abs(cpu_m[key].item())
    for a, b in zip(flatten(card_p)[0], flatten(cpu_p)[0]):
        assert ((a.cpu() - b).norm() / b.norm()).item() <= 1e-4


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


# ---------------------------------------------------------------------------
# the conformance harness on the card, and the calibration it rests on
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_calibration_names_the_card_and_covers_the_window_on_it(card):
    """`CostModel.calibrate` times each window on the host clock through
    the sync after it: each per-window WCET is at least the same window's
    time on the card alone (CUDA-graph replay between CUDA events). The
    CUDA-event time around one launch is no lower bound: on an idle card
    the start event fires before the wrapper's host work, so it holds
    host time as well and may read above or below the WCET."""
    from repro_torch.conformance import CostModel
    from repro_torch.pipeline import PharosServer

    smoke = _load_smoke()
    design, _, _, tasks = smoke.steady_city(device="cuda")
    srv = PharosServer(tasks, design.n_stages, policy="edf", device="cuda")
    cm = CostModel.calibrate(srv, reps=3)
    assert cm.source == "calibrated"
    assert cm.device == torch.cuda.get_device_name(card)
    split = smoke.calibration_split(srv, cm, reps=3)
    assert [len(rows) for rows in split] == [len(t.weights) for t in tasks]
    for rows in split:
        for r in rows:
            assert r["wcet_us"] >= r["card_us"] > 0.0
            assert r["event_us"] >= r["card_us"]
            assert 0.0 < r["card_share"] <= 1.0


@pytest.mark.cuda
def test_conformance_case_on_card_equals_cpu_run(card):
    """`run_case` on steady_city under EDF at the harness's defaults:
    every window through the kernel on the card, and the case equal to
    the CPU run's field for field but for ``wall_seconds``."""
    from repro_torch.conformance import run_case

    smoke = _load_smoke()
    built, _ = smoke.search_design("steady_city")
    before = matmul_window_call.launches
    got = run_case(built, "edf", device="cuda")
    assert matmul_window_call.launches > before
    want = run_case(built, "edf", device="cpu")
    assert got.ok, [str(v) for v in got.violations]
    assert smoke.model_fields(got) == smoke.model_fields(want)


@pytest.mark.cuda
def test_wallclock_case_on_card_at_the_reference_test_settings(card):
    """The reference's own wall-clock test on the card: steady_city built
    as that test builds it, horizon 8 periods, 2 calibration reps,
    margin 8, one host-noise retry."""
    from repro_torch.conformance import ConformanceConfig, run_wallclock_case

    smoke = _load_smoke()
    built = smoke.build(smoke.get_scenario("steady_city"), smoke.paper_platform(16),
                        beam_width=4)
    cfg = ConformanceConfig(wall_horizon_periods=8.0, wall_reps=2, wall_margin=8.0)
    case = run_wallclock_case(built, "edf", device="cuda", cfg=cfg)
    if not case.ok:  # host-noise retry, as the reference's test
        case = run_wallclock_case(built, "edf", device="cuda", cfg=cfg)
    assert case.ok, [str(v) for v in case.violations]
    assert case.period_scale > 0 and math.isfinite(case.period_scale)
    for row in case.tasks:
        assert row.jobs > 0
        assert 0.0 < row.measured_median <= row.measured_max
        assert 0.0 < row.predicted_des_max <= row.predicted_bound
        assert row.in_flight <= cfg.backlog_limit


# ---------------------------------------------------------------------------
# the backward kernels of WKV-6 and the selective scan
# ---------------------------------------------------------------------------
def _rel0(x, y):
    """`_rel`, with an all-zero ``y`` (dw at S 1) held exactly."""
    m = y.abs().max().item()
    return (x - y).abs().max().item() / m if m else x.abs().max().item()


def _wkv_cotangents(card, B, S, H, seed, with_ds):
    gen = torch.Generator(device=card).manual_seed(seed)
    dy = torch.randn((B, S, H, 64), generator=gen, device=card)
    ds = torch.randn((B, H, 64, 64), generator=gen, device=card) if with_ds else None
    return dy, ds


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,with_ds",
    [(1, 40, 2, True), (2, 100, 3, True), (1, 1, 2, True),
     # S at and around one stash interval of the kernel, and past 2048
     (1, WKV_BWD_CHUNK - 1, 2, False), (1, WKV_BWD_CHUNK, 2, True),
     (1, WKV_BWD_CHUNK + 1, 2, True), (1, 2049, 2, False),
     (2, 256, 64, False)],  # the main path's B·H
)
def test_wkv6_backward_kernel_matches_plain(card, B, S, H, with_ds):
    """Every gradient within 1e-4 of the max of the plain step-by-step
    backward's (the forward's bound), with and without a cotangent on
    S_final, ragged S; one launch count per call."""
    ops = _wkv_inputs(card, B, S, H, 64, S + 1)
    dy, ds = _wkv_cotangents(card, B, S, H, S + 2, with_ds)
    before = rwkv6_scan_backward_call.launches
    got = rwkv6_scan_backward_call(*ops, dy, ds)
    assert rwkv6_scan_backward_call.launches == before + 1
    want = rwkv6_scan_backward_plain(*ops, dy, ds)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel0(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,with_ds",
    [(1, 3 * WKV_BWD_CHUNK + 7, 5, True),  # ragged last chunk, odd H
     (1, 2 * WKV_BWD_CHUNK + 1, 3, False),  # a last chunk of one step
     (3, WKV_BWD_CHUNK + 5, 1, True), (1, 4 * WKV_BWD_CHUNK, 7, True)],
)
def test_wkv6_backward_kernel_column_groups_at_ragged_edges(card, B, S, H, with_ds):
    """The kernel's column groups and once-a-chunk sums where the chunks
    and the grid are ragged: S not a multiple of the stash interval (the
    reverse starts on the short chunk), B 1 and odd H, with and without a
    cotangent on S_final. Every gradient within 1e-4 of the max of the
    plain backward's, and two launches bit-identical."""
    ops = _wkv_inputs(card, B, S, H, 64, 3 * S + H)
    dy, ds = _wkv_cotangents(card, B, S, H, 3 * S + H + 1, with_ds)
    got = rwkv6_scan_backward_call(*ops, dy, ds)
    again = rwkv6_scan_backward_call(*ops, dy, ds)
    want = rwkv6_scan_backward_plain(*ops, dy, ds)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel0(g, w) <= 1e-4
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.1, 0.01])
def test_wkv6_backward_kernel_at_low_decay(card, decay):
    """Decays far below the model's clamp, where the kernel's dw divides
    a cancelling difference by w: dr, dk, dv and du within 1e-4 of the
    plain backward's max (which sums dw directly), dw within 4e-7 / w
    (the order's emulation in test_torch_rwkv6.py: 1.6e-5 at w 0.01)."""
    B, S, H = 1, 1000, 4
    r, k, v, _, u = _wkv_inputs(card, B, S, H, 64, 11)
    w = torch.full_like(r, decay)
    dy, ds = _wkv_cotangents(card, B, S, H, 12, True)
    got = rwkv6_scan_backward_call(r, k, v, w, u, dy, ds)
    want = rwkv6_scan_backward_plain(r, k, v, w, u, dy, ds)
    torch.cuda.synchronize()
    for i, (g, x) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        assert _rel0(g, x) <= (4e-7 / decay if i == 3 else 1e-4)


@pytest.mark.cuda
def test_wkv6_backward_kernel_reads_only_its_own_batch_row_and_head(card):
    """NaN in batch row 1, in head 1 of batch row 0 and past the end of
    every (B, S, H, hd) operand, S ragged against the stash interval:
    heads 0 and 2 of batch row 0 come out finite and equal to a clean
    run's, bit for bit (du sums over the batch and is not compared)."""
    B, S, H = 2, WKV_BWD_CHUNK + 13, 3
    clean = [*_wkv_inputs(card, B, S, H, 64, 7)]
    dy, ds = _wkv_cotangents(card, B, S, H, 8, True)
    want = rwkv6_scan_backward_call(*clean, dy, ds)
    dirty = []
    for x in (*clean[:4], dy):
        x = x.clone()
        x[1] = float("nan")
        x[0, :, 1] = float("nan")
        dirty.append(_nan_tailed(x))
    u = clean[4].clone()
    u[1] = float("nan")
    ds_dirty = ds.clone()
    ds_dirty[1] = float("nan")
    ds_dirty[0, 1] = float("nan")
    got = rwkv6_scan_backward_call(*dirty[:4], u, dirty[4], ds_dirty)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], want[:4]):
        for h in (0, 2):
            assert bool(torch.isfinite(g[0, :, h]).all())
            assert torch.equal(g[0, :, h], w[0, :, h])


@pytest.mark.cuda
def test_wkv6_backward_kernel_is_deterministic(card):
    """Two launches on the same inputs: bit-identical gradients (no
    atomics; du summed over the batch in order)."""
    ops = _wkv_inputs(card, 3, 300, 8, 64, 3)
    dy, ds = _wkv_cotangents(card, 3, 300, 8, 4, True)
    one = rwkv6_scan_backward_call(*ops, dy, ds)
    two = rwkv6_scan_backward_call(*ops, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_wkv6_backward_kernel_refuses_what_it_does_not_take(card):
    r, k, v, w, u = _wkv_inputs(card, 1, 16, 2, 32, 0)
    before = rwkv6_scan_backward_call.launches
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan_backward_call(r, k, v, w, u, torch.zeros_like(r))
    ops = _wkv_inputs(card, 1, 16, 2, 64, 0)
    dy = torch.zeros_like(ops[0])
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan_backward_call(*ops, dy.bfloat16())
    dy_t = torch.zeros((1, 2, 16, 64), device=card).transpose(1, 2)
    assert not dy_t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan_backward_call(*ops, dy_t)
    shifted = torch.empty(dy.numel() + 1, device=card)[1:].view(dy.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        rwkv6_scan_backward_call(*ops, shifted)
    assert rwkv6_scan_backward_call.launches == before


def _scan_cotangents(card, B, S, di, seed, with_dh):
    gen = torch.Generator(device=card).manual_seed(seed)
    dy = torch.randn((B, S, di), generator=gen, device=card)
    dh = torch.randn((B, di, 16), generator=gen, device=card) if with_dh else None
    return dy, dh


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,di,h0,a",
    [(2, 256, 512, False, "init"), (2, 77, 96, True, "init"),
     # S at and around one stash interval, and past 2048
     (1, 1, 96, True, "random"), (1, SCAN_BWD_CHUNK - 1, 96, True, "random"),
     (1, SCAN_BWD_CHUNK, 96, True, "random"),
     (1, SCAN_BWD_CHUNK + 1, 96, True, "random"), (1, 2049, 96, True, "random"),
     # d_inner not a multiple of the block's channels
     (3, 100, 8200, True, "random"), (3, 40, 100, True, "random"),
     (2, 1000, 8192, False, "init"),  # the main path's width
     (2, 300, 512, True, "underflow")],
)
def test_mamba_scan_backward_kernel_matches_plain(card, B, S, di, h0, a):
    """Every gradient within 1e-4 of the max of the plain chunked
    backward's (the forward's bound), from a normal h0 with a cotangent
    on h_final or from zero without one, ragged S, d_inner not a
    multiple of the block, decays that flush to 0; one launch count per
    call."""
    ops = _scan_inputs(card, B, S, di, 16, S + di + 1, h0, a)
    dy, dh = _scan_cotangents(card, B, S, di, S + 2, h0)
    before = mamba_scan_backward_call.launches
    got = mamba_scan_backward_call(*ops, dy, dh, chunk=64)
    assert mamba_scan_backward_call.launches == before + 1
    want = mamba_scan_backward_plain(*ops, dy, dh, chunk=64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel0(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,di,h0,a",
    [(1, 2 * SCAN_BWD_CHUNK + 3, 3 * SCAN_BWD_CHANNELS + 4, True, "random"),
     (2, 5 * SCAN_BWD_CHUNK + 1, SCAN_BWD_CHANNELS + 4, False, "init"),
     (1, 7, 2 * SCAN_BWD_CHANNELS + 36, True, "underflow")],
)
def test_mamba_scan_backward_kernel_block_edges(card, B, S, di, h0, a):
    """d_inner not a multiple of the block's channels (the last block
    part empty), S ragged against the stash interval (the reverse's short
    chunk runs all its steps on zeros past S), decays that flush to 0:
    every gradient within 1e-4 of the max of the plain backward's, and
    two launches bit-identical."""
    ops = _scan_inputs(card, B, S, di, 16, 5 * S + di, h0, a)
    dy, dh = _scan_cotangents(card, B, S, di, 5 * S + di + 1, h0)
    got = mamba_scan_backward_call(*ops, dy, dh, chunk=64)
    again = mamba_scan_backward_call(*ops, dy, dh, chunk=64)
    want = mamba_scan_backward_plain(*ops, dy, dh, chunk=64)
    torch.cuda.synchronize()
    for g, x, w in zip(got, again, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert _rel0(g, w) <= 1e-4
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dirty", [0, 1])
def test_mamba_scan_backward_kernel_reads_only_its_own_batch_row(card, dirty):
    """NaN in every operand's batch row ``dirty`` and past the end of
    dt, B, C, x and dy, S ragged against the stash interval: the other
    row's ddt, dB, dC, dx and dh0 come out finite and equal to a clean
    run's, bit for bit (dA sums over the batch and is not compared)."""
    B, S, di = 2, SCAN_BWD_CHUNK + 13, 100
    clean = _scan_inputs(card, B, S, di, 16, 7, True, "random")
    dy, dh = _scan_cotangents(card, B, S, di, 8, True)
    want = mamba_scan_backward_call(*clean, dy, dh, chunk=64)
    dt, Bm, Cm, x, A, h0 = (t.clone() for t in clean)
    dy, dh = dy.clone(), dh.clone()
    for t in (dt, Bm, Cm, x, h0, dy, dh):
        t[dirty] = float("nan")
    dt, Bm, Cm, x, dy = (_nan_tailed(t) for t in (dt, Bm, Cm, x, dy))
    got = mamba_scan_backward_call(dt, Bm, Cm, x, A, h0, dy, dh, chunk=64)
    torch.cuda.synchronize()
    keep = 1 - dirty
    for i in (0, 1, 2, 3, 5):
        assert bool(torch.isfinite(got[i][keep]).all())
        assert torch.equal(got[i][keep], want[i][keep])


@pytest.mark.cuda
def test_mamba_scan_backward_kernel_is_deterministic(card):
    """Two launches on the same inputs: bit-identical gradients (no
    atomics; dB, dC over d_inner and dA over the batch in order)."""
    ops = _scan_inputs(card, 3, 300, 8200, 16, 3, True, "random")
    dy, dh = _scan_cotangents(card, 3, 300, 8200, 4, True)
    one = mamba_scan_backward_call(*ops, dy, dh, chunk=64)
    two = mamba_scan_backward_call(*ops, dy, dh, chunk=64)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_mamba_scan_backward_kernel_refuses_what_it_does_not_take(card):
    ops = _scan_inputs(card, 1, 16, 64, 16, 0)
    dy = torch.zeros_like(ops[3])
    before = mamba_scan_backward_call.launches
    with pytest.raises(ValueError, match="float32"):
        mamba_scan_backward_call(*ops, dy.bfloat16(), chunk=8)
    dy_t = torch.zeros((1, 64, 16), device=card).transpose(1, 2)
    assert not dy_t.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_backward_call(*ops, dy_t, chunk=8)
    small = _scan_inputs(card, 1, 16, 64, 8, 0)
    with pytest.raises(ValueError, match="d_state 16"):
        mamba_scan_backward_call(*small, dy, chunk=8)
    shifted = torch.empty(dy.numel() + 1, device=card)[1:].view(dy.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        mamba_scan_backward_call(*ops, shifted, chunk=8)
    odd = _scan_inputs(card, 1, 16, 66, 16, 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        mamba_scan_backward_call(*odd, torch.zeros_like(odd[3]), chunk=8)
    assert mamba_scan_backward_call.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides,param_tol", [
    ("rwkv6_7b", {"rwkv_head_size": 64}, 1e-4),
    ("jamba_v0_1_52b", {"head_dim": 64, "mamba_d_state": 16}, 1e-3)])
def test_smoke_recurrent_train_step_on_card_matches_cpu(card, name, overrides,
                                                       param_tol):
    """One AdamW step of smoke RWKV-6 and smoke Jamba in fp32, at the
    kernels' head width 64 (and Jamba's d_state 16), on the card and on
    the CPU from the same weights and batch: loss and grad norm within
    1e-4, every parameter within ``param_tol`` (relative L2; Jamba's
    16 layers take 1e-3, as tests/test_torch_train.py's Jamba steps),
    through two forward launches per recurrent layer (one more under
    remat) and one backward launch."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten, tree_map

    cfg = dataclasses.replace(smoke_config(load_config(name)), **overrides)
    plan = cfg.layer_plan()
    n_rwkv = sum(m == "rwkv" for m, _ in plan)
    n_mamba = sum(m == "mamba" for m, _ in plan)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 96), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 96), generator=gen),
             "mask": torch.ones((2, 96))}
    step = make_train_step(cfg, AdamWConfig(lr_peak=1e-3, warmup_steps=1))
    calls = (rwkv6_scan_call, rwkv6_scan_backward_call, mamba_scan_call,
             mamba_scan_backward_call)
    results = {}
    for device in ("cpu", card):
        p = tree_map(lambda t: t.to(device), params)
        before = [c.launches for c in calls]
        new, _, m = step(p, adamw_init(p), {k: v.to(device) for k, v in batch.items()})
        if device == card:
            torch.cuda.synchronize()
            got = [c.launches - b for c, b in zip(calls, before)]
            assert got == [2 * n_rwkv, n_rwkv, 2 * n_mamba, n_mamba]
        results[str(device)] = (new, m)
    (cpu_p, cpu_m), (card_p, card_m) = results["cpu"], results[str(card)]
    for key in ("loss", "grad_norm"):
        assert abs(card_m[key].item() - cpu_m[key].item()) <= 1e-4 * abs(cpu_m[key].item())
    for a, b in zip(flatten(card_p)[0], flatten(cpu_p)[0]):
        assert ((a.cpu() - b).norm() / b.norm()).item() <= param_tol


@pytest.mark.cuda
def test_pipeline_executor_on_card_equals_reference_backbone(card):
    """The pipeline executor with 2 stage ranks sharing cuda:0 over gloo
    (each hop staged through pinned host memory), a 4-layer model at
    width 256 and the kernels' head width 64, bf16 and fp32: the
    pipelined output equals rank 0's sequential `reference_backbone` and
    this process's, bit for bit, and each rank launches the flash kernel
    once per microbatch per layer it holds."""
    from repro_torch import _build
    from repro_torch.configs import ArchConfig
    from repro_torch.models import lm
    from repro_torch.pipeline.executor import (
        BackboneCase,
        backbone_job,
        launch,
        reference_backbone,
    )

    cfg = ArchConfig(name="t64", family="dense", n_layers=4, d_model=256, n_heads=4,
                     n_kv_heads=2, head_dim=64, d_ff=512, vocab=128)
    cases = [BackboneCase(cfg, dtype, 4, 2, 128, 3)
             for dtype in (torch.bfloat16, torch.float32)]
    _build.build(["flash_attention"])  # the ranks only load it
    ranks = launch(backbone_job, 2, backend="gloo", device="cuda", timeout=300.0,
                   args=(cases,))
    for i, case in enumerate(cases):
        first, last = ranks[0][i], ranks[1][i]
        params = lm.init_params(torch.Generator(device=card).manual_seed(case.seed),
                                cfg, case.dtype, device=card)
        want = reference_backbone(cfg, params, case.micro(card)).cpu()
        assert torch.equal(last["out"], first["ref"])
        assert torch.equal(last["out"], want)
        assert [r[i]["flash_launches"] for r in ranks] == [case.n_micro * 2] * 2
        assert first["ref_flash_launches"] == case.n_micro * cfg.n_layers
        assert first["backend"] == "gloo" and first["hops"] == case.n_micro
        assert first["peak_bytes"] > 0


@pytest.mark.cuda
def test_pipeline_executor_over_nccl_with_a_card_per_stage(card):
    """The executor's NCCL hops (card tensors sent as they are), one card
    per stage rank: 4 stages where 4 cards are visible, else 2; skips on
    one card. The pipelined output equals rank 0's `reference_backbone`
    and this process's on the first card, bit for bit (every card the
    same model)."""
    from repro_torch import _build
    from repro_torch.configs import ArchConfig
    from repro_torch.models import lm
    from repro_torch.pipeline.executor import (
        BackboneCase,
        backbone_job,
        launch,
        reference_backbone,
    )

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("nccl needs a card per stage rank: 2 or more cards")
    stages = 4 if n_cards >= 4 else 2
    cfg = ArchConfig(name="t64", family="dense", n_layers=4, d_model=256, n_heads=4,
                     n_kv_heads=2, head_dim=64, d_ff=512, vocab=128)
    case = BackboneCase(cfg, torch.bfloat16, 4, 2, 128, 3)
    _build.build(["flash_attention"])
    ranks = [r[0] for r in launch(backbone_job, stages, backend="nccl",
                                  device="cuda", timeout=300.0, args=([case],))]
    params = lm.init_params(torch.Generator(device=card).manual_seed(case.seed), cfg,
                            case.dtype, device=card)
    want = reference_backbone(cfg, params, case.micro(card)).cpu()
    assert torch.equal(ranks[-1]["out"], ranks[0]["ref"])
    assert torch.equal(ranks[-1]["out"], want)
    per = cfg.n_layers // stages
    assert [r["flash_launches"] for r in ranks] == [case.n_micro * per] * stages
    assert all(r["backend"] == "nccl" for r in ranks)


# ---------------------------------------------------------------------------
# the kernels as custom ops; the SPMD policy on the card
# ---------------------------------------------------------------------------
def _op_case(name, card):
    """(op, direct kernel call, launch counter, args) at small shapes the
    kernels take (head width 64, d_state 16)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.rwkv6_scan import kernel as WK

    gen = torch.Generator(device=card).manual_seed(7)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    if name.startswith("flash"):
        q, k, v = (rn(2, 192, h, 64, dtype=torch.bfloat16) for h in (4, 2, 2))
        if name == "flash":
            return (FK.flash_attention_op, FK.forward_cuda,
                    FK.flash_attention_call, (q, k, v, True, True))
        o, lse = FK.forward_cuda(q, k, v, True, True)
        return (FK.flash_attention_backward_op, FK.backward_cuda,
                FK.flash_attention_backward_call,
                (q, k, v, o, torch.randn_like(o), lse, True))
    if name.startswith("wkv"):
        r, k, v = (rn(2, 96, 2, 64) for _ in range(3))
        w = torch.rand((2, 96, 2, 64), generator=gen, device=card) * 0.3 + 0.69
        u = rn(2, 64)
        if name == "wkv":
            return WK.rwkv6_scan_op, WK.forward_cuda, WK.rwkv6_scan_call, (
                r, k, v, w, u, 64)
        return (WK.rwkv6_scan_backward_op, WK.backward_cuda,
                WK.rwkv6_scan_backward_call, (r, k, v, w, u, rn(2, 96, 2, 64), None))
    dt = torch.rand((2, 96, 64), generator=gen, device=card) * 0.1
    B, C, x = rn(2, 96, 16), rn(2, 96, 16), rn(2, 96, 64)
    A, h0 = -torch.rand((64, 16), generator=gen, device=card), rn(2, 64, 16)
    if name == "scan":
        return MK.mamba_scan_op, MK.forward_cuda, MK.mamba_scan_call, (
            dt, B, C, x, A, h0, 64)
    return (MK.mamba_scan_backward_op, MK.backward_cuda, MK.mamba_scan_backward_call,
            (dt, B, C, x, A, h0, rn(2, 96, 64), None, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash", "flash_backward", "wkv", "wkv_backward",
                                  "scan", "scan_backward"])
def test_custom_op_launches_its_kernel_once_with_the_direct_calls_bits(card, name):
    """Each ``repro_torch::`` op routes a CUDA tensor to its kernel: one
    launch (the wrapper's count +1), the same bits as the direct kernel
    call."""
    op, direct, counter, args = _op_case(name, card)
    before = counter.launches
    got = op(*args)
    assert counter.launches == before + 1
    want = direct(*args)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_capacity_on_card_matches_cpu(card, capacity_factor):
    """`layers.moe_capacity` on the card against the same call on the
    CPU, fp32, 2 groups, 8 experts in 48 banks: the same products in
    other summation orders (1e-4 of the max; a routing or capacity
    choice that differed would move outputs by O(1)); no host read."""
    cfg = dataclasses.replace(smoke_config(load_config("granite_moe_3b_a800m")),
                              capacity_factor=capacity_factor)
    p = L.moe_init(torch.Generator().manual_seed(1), cfg, torch.float32, device="cpu")
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(2))
    want = L.moe_capacity(p, x, cfg, groups=2)
    reads = L.moe_dropless.host_reads
    got = L.moe_capacity({k: v.to(card) for k, v in p.items()}, x.to(card), cfg,
                         groups=2)
    assert L.moe_dropless.host_reads == reads
    assert _rel(got.cpu(), want) <= 1e-4


@pytest.mark.cuda
def test_granite_lowerable_prefill_on_a_one_card_mesh(card):
    """Smoke Granite-MoE (head width 64 for the kernel), fp32, through
    `lowerable` on a 1 x 1 mesh of one nccl rank: one flash launch per
    layer, no MoE host read, and at capacity factor E / top_k its
    last-token logits equal the NO_POLICY (dropless) prefill's within
    1e-4 of the max (fp32 products grouped per expert's C rows vs its
    own rows)."""
    import sys

    from repro_torch import _build
    from repro_torch.models import lm
    from repro_torch.pipeline.executor import launch

    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_spmd_job import prefill_job

    cfg = smoke_config(load_config("granite_moe_3b_a800m"))
    cfg = dataclasses.replace(cfg, head_dim=64, capacity_factor=cfg.n_experts / cfg.top_k)
    params = lm.init_params(torch.Generator().manual_seed(3), cfg, torch.float32,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(4))
    _build.build(["flash_attention"])
    (out,) = launch(prefill_job, 1, backend="nccl", device="cuda", timeout=300.0,
                    args=(cfg, params, tokens))
    assert out["flash_launches"] == cfg.n_layers and out["host_reads"] == 0
    assert out["logits"].shape == (2, cfg.vocab)
    assert _rel(out["logits"], out["plain"]) <= 1e-4


@pytest.mark.cuda
def test_lowerable_train_step_on_four_cards_equals_one_card(card):
    """One `lowerable` train step of smoke StableLM (head width 64, one
    KV head, fp32) on a 2 x 2 mesh of four nccl ranks, a card each,
    against the same step on a 1 x 1 mesh of one card: loss at 1e-5,
    every parameter at relative L2 1e-4 (sharded products sum in other
    orders; AdamW's first step divides each gradient element by its own
    size). Skips on fewer than 4 cards."""
    import sys

    import numpy as np

    from repro_torch import _build
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.pipeline.executor import launch
    from repro_torch.tree import flatten

    if torch.cuda.device_count() < 4:
        pytest.skip("a 2 x 2 mesh of nccl ranks needs 4 cards")
    sys.path.insert(0, os.path.dirname(__file__))
    from _torch_spmd_job import spmd_job

    cfg = dataclasses.replace(smoke_config(load_config("stablelm_1_6b")),
                              head_dim=64, n_kv_heads=1)
    params = lm.init_params(torch.Generator().manual_seed(5), cfg, torch.float32,
                            device="cpu")
    gen = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 64), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (4, 64), generator=gen),
             "mask": torch.ones(4, 64)}
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=0, total_steps=10)
    _build.build(["flash_attention", "flash_attention_bwd"])
    runs = {}
    for shape, n in (((2, 2), 4), ((1, 1), 1)):
        ranks = launch(spmd_job, n, backend="nccl", device="cuda", timeout=300.0,
                       args=([(cfg, params, batch)], opt, shape, "cuda"))
        runs[shape] = ranks[0][0]
    four, one = runs[(2, 2)], runs[(1, 1)]
    assert abs(four["step_loss"] - one["step_loss"]) <= 1e-5 * abs(one["step_loss"])
    for g, w in zip(flatten(four["params"])[0], flatten(one["params"])[0]):
        assert np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30) <= 1e-4
