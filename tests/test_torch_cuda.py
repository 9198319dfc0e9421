"""The preemptible-matmul CUDA kernel against its plain version, on the
card. Marked ``cuda``; each test skips, with its reason, where no card
is visible. Imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 differs from the plain version only in summation order
(max rel err 1e-5); bf16 inputs are upcast identically on both sides
(2e-2, as the reference's bf16 tests).
"""
import math

import pytest
import torch

from repro_torch.kernels.preemptible_matmul import grid_geometry, matmul_resumable
from repro_torch.kernels.preemptible_matmul.kernel import matmul_window_call
from repro_torch.kernels.preemptible_matmul.ref import (
    matmul_ref,
    matmul_window_plain,
)

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
     (1024, 512, 1024, 6, 2), (256, 384, 384, 2, 3)],
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
