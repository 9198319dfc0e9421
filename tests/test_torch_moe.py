"""Jamba's other layers against the JAX package's, on the CPU: the
dropless MoE ffn and the int8-KV decode step.

Parameters come from the JAX package's initialisers and are carried
across with ``repro_torch.convert``; activations are made with numpy
from a seed. Tolerances, with their reasons:

- float32: 1e-4 of the max (the same arithmetic in another order;
  observed ~1e-7).
- bfloat16: relative L2 3e-2, as the port's other bf16 comparisons
  (PyTorch and XLA round bf16 products and elementwise ops at the same
  places but not always to the same ulp). Routing is decided in fp32 on
  the same normed inputs, so both sides pick the same experts here.
- int8 codes: equal, except ±1 flips where ``k / scale`` lands on a
  rounding boundary and the two libraries' divisions differ in the last
  bit; at most 1e-3 of the codes may flip (none observed). Scales
  (bf16) must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke_config
from repro.configs.jamba_v0_1_52b import CONFIG as REF_JAMBA
from repro.models import layers as RL
from repro_torch import convert
from repro_torch.configs import load_config, smoke_config
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOL = 1e-4
BF16_REL_L2 = 3e-2
MAX_FLIP_SHARE = 1e-3

VARIANTS = {
    "jamba": {},
    "padded": {"expert_pad_to": 12},  # 8 experts stored as 12 banks
    "gelu": {"mlp_type": "gelu", "top_k": 1},
}


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


def _close(got, want, dtype):
    if dtype == "float32":
        assert _rel(got, want) <= TOL
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2


def _t(a):
    return convert._lm_tensor(np.asarray(a), "cpu")


def _configs(**over):
    rcfg = dataclasses.replace(ref_smoke_config(REF_JAMBA), **over)
    cfg = dataclasses.replace(smoke_config(load_config("jamba_v0_1_52b")), **over)
    return rcfg, cfg


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    return jx, _t(jx)


def _params(init, rcfg, dtype, seed):
    p = init(jax.random.PRNGKey(seed), rcfg)
    if dtype == "float32":
        p = {k: v.astype(jnp.float32) for k, v in p.items()}
    return p, {k: _t(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# dropless MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_dropless_matches_reference(dtype, variant):
    rcfg, cfg = _configs(**VARIANTS[variant])
    p, tp = _params(RL.moe_init, rcfg, dtype, seed=3)
    jx, tx = _x((2, 24, cfg.d_model), dtype, seed=4)
    want = RL.moe_dropless(p, jx, rcfg)
    got = L.moe_dropless(tp, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)


def test_moe_one_token_matches_reference():
    """Decode's shape: one token per sequence, most experts empty."""
    rcfg, cfg = _configs()
    p, tp = _params(RL.moe_init, rcfg, "float32", seed=5)
    jx, tx = _x((2, 1, cfg.d_model), "float32", seed=6)
    _close(L.moe_dropless(tp, tx, cfg), RL.moe_dropless(p, jx, rcfg), "float32")


def test_padded_expert_banks_are_never_routed_to():
    """Banks past n_experts are stored (the reference's layout) and never
    read: filling them with NaN changes nothing."""
    rcfg, cfg = _configs(expert_pad_to=12)
    p, tp = _params(RL.moe_init, rcfg, "float32", seed=7)
    assert tp["w_in"].shape[0] == 12 and tp["router"].shape == (cfg.d_model, 8)
    _, tx = _x((2, 24, cfg.d_model), "float32", seed=8)
    clean = L.moe_dropless(tp, tx, cfg)
    for name in ("w_in", "w_gate", "w_out"):
        tp[name][8:] = float("nan")
    assert torch.equal(L.moe_dropless(tp, tx, cfg), clean)


def test_moe_reads_group_sizes_back_once_a_call():
    rcfg, cfg = _configs()
    _, tp = _params(RL.moe_init, rcfg, "float32", seed=9)
    _, tx = _x((1, 5, cfg.d_model), "float32", seed=10)
    before = L.moe_dropless.host_reads
    L.moe_dropless(tp, tx, cfg)
    L.moe_dropless(tp, tx, cfg)
    assert L.moe_dropless.host_reads == before + 2


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_init_has_the_reference_layout(variant):
    rcfg, cfg = _configs(**VARIANTS[variant])
    want = {k: _t(v) for k, v in RL.moe_init(jax.random.PRNGKey(0), rcfg).items()}
    got = L.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()
    }
    w = got["w_in"].float()
    std = 1 / cfg.d_model**0.5
    assert w.abs().max() <= 2 * std * 1.01  # truncated at 2 sigma, then bf16
    assert abs(w.std().item() / std - 0.88) < 0.03  # std of N(0,1) cut at ±2


# ---------------------------------------------------------------------------
# int8 KV decode
# ---------------------------------------------------------------------------
def _codes_close(got, want):
    d = got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() <= MAX_FLIP_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    jk, tk = _x((2, 4, 64, 16), dtype, seed=11)
    jk = jk * 3.0
    tk = _t(jk)
    want_q, want_s = RL.quantize_kv(jk)
    got_q, got_s = L.quantize_kv(tk)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    assert got_q.shape == want_q.shape and got_s.shape == want_s.shape
    _codes_close(got_q, want_q)
    assert torch.equal(got_s, _t(want_s))
    assert int(got_q.abs().max()) == 127
    zero_q, zero_s = L.quantize_kv(torch.zeros(1, 1, 2, 16))
    assert not zero_q.any() and bool((zero_s > 0).all())  # the 1e-8 floor


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_q8_matches_reference(dtype):
    """Three decode steps over an int8 cache quantized by the reference
    from a bf16 prompt cache: outputs, codes and scales."""
    rcfg, cfg = _configs()
    p, tp = _params(RL.attn_init, rcfg, dtype, seed=12)
    B, S, S_max = 2, 12, 16
    jx, _ = _x((B, S, cfg.d_model), dtype, seed=13)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    _, kv = RL.attention_prefill(p, jx, rcfg, pos, S_max)
    r_cache = {}
    for name in ("k", "v"):
        r_cache[name], r_cache[f"{name}_scale"] = RL.quantize_kv(kv[name])
    cache = {k: _t(v) for k, v in r_cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for i in range(3):
        jt, tt = _x((B, 1, cfg.d_model), dtype, seed=20 + i)
        jpos = jnp.full((B,), S + i, jnp.int32)
        want, r_cache = RL.attention_decode_q8(p, jt, rcfg, r_cache, jpos)
        got, cache = L.attention_decode_q8(tp, tt, cfg, cache,
                                           torch.full((B,), S + i))
        assert got.dtype == tt.dtype and got.shape == tt.shape
        _close(got, want, dtype)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs  # in place
    for name in ("k", "v"):
        assert cache[name].dtype == torch.int8
        _codes_close(cache[name], r_cache[name])
        scale = f"{name}_scale"
        assert cache[scale].dtype == torch.bfloat16
        if dtype == "float32":
            assert _rel(cache[scale], r_cache[scale]) <= TOL
        else:
            assert _rel_l2(cache[scale], r_cache[scale]) <= BF16_REL_L2
    assert bool((cache["k"][:, :, S : S + 3] != 0).any())  # the new tokens landed
    assert not cache["k"][:, :, S + 3 :].any()
