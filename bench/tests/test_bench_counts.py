"""The frozen operation and byte counts against hand counts."""
import pytest

from bench_support import ROOT
from benchkit import flops, peaks
from benchkit.model import sizes
from benchkit.spec import Spec


def _sizes(name):
    _, cfg = Spec(ROOT).config(name)
    return sizes(name, cfg)


def test_flash_forward_counts_at_one_shape():
    # B 1, S 4, H 2, hd 8: pairs 1+2+3+4 = 10, 4 * 8 flops each, 2 heads
    assert flops.flash_fwd_flops(1, 4, 2, 8) == 10 * 32 * 2
    # q, o: 1*4*2*8 each; k, v: 1*4*1*8 each; bf16
    assert flops.flash_fwd_bytes(1, 4, 2, 1, 8) == (2 * 64 + 2 * 32) * 2
    assert flops.flash_bwd_flops(1, 4, 2, 8) == 10 * 80 * 2
    assert flops.flash_bwd_bytes(1, 4, 2, 1, 8) == (4 * 64 + 4 * 32) * 2


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES == 3.35e12


def test_model_flops_of_the_two_configurations():
    qw = _sizes("qwen1.5-1.8b")
    per_layer = 4 * 2048 * 2048 + 3 * 2048 * 5504  # the q, k, v biases are no products
    assert flops.body_weights(qw) == 24 * per_layer
    n = 24 * per_layer + 2048 * 151936
    attn = 4 * 128 * 8 * 16 * (2048 * 2049 / 2)
    assert flops.train_step_flops(qw, 8, 2048) == 6 * n * 8 * 2048 + 24 * 3 * attn
    assert flops.train_step_flops(qw, 8, 2048) == pytest.approx(1.5985e14, rel=1e-4)
    nemo = _sizes("mistral-nemo-12b")
    per_layer = 5120 * 4096 * 2 + 2 * 5120 * 1024 + 3 * 5120 * 14336
    attn = 4 * 128 * 1 * 32 * (32768 * 32769 / 2)
    want = 2 * 40 * per_layer * 32768 + 40 * attn + 2 * 5120 * 131072
    assert flops.prefill_flops(nemo, 1, 32768) == want


#: the frozen formulas' counts at the cells' shapes, as they read before
#: the harness reached them through the family adapter
PINNED = [
    ("qwen1.5-1.8b", "train_step_flops", 8, 2048, 159854924660736.0),
    ("qwen1.5-1.8b", "train_step_flops", 1, 16384, 229124157210624.0),
    ("mistral-nemo-12b", "prefill_flops", 1, 32768, 1066538358538240.0),
    ("mistral-nemo-12b", "prefill_flops", 8, 128, 22387852574720.0),
    ("mistral-nemo-12b", "prefill_flops", 8, 256, 44850867077120.0),
    ("mistral-nemo-12b", "prefill_flops", 8, 512, 90034594119680.0),
    ("mistral-nemo-12b", "prefill_flops", 8, 1024, 181432840355840.0),
    ("mistral-nemo-12b", "prefill_flops", 8, 2048, 368352501432320.0),
]


@pytest.mark.parametrize("name,count,B,S,want", PINNED)
def test_the_dense_familys_counts_are_the_frozen_values(name, count, B, S, want):
    spec = Spec(ROOT)
    _, cfg = spec.config(name)
    family = spec.module("families", cfg["reference"])
    s = family.sizes(name, cfg)
    assert getattr(family, count)(s, B, S) == want
    assert family.attention_layers(s) == s.layers
    assert family.attention_shape(s) == (s.heads, s.kv_heads, s.head_dim)
