"""The port's LM serving path against the JAX package's, on the CPU.

The smoke-size models (`smoke_config` of Mistral-NeMo-12B, RWKV-6-7B,
DBRX-132B, Granite-MoE-3B (tied embeddings), Minitron-4B (gelu),
Qwen1.5-32B (q/k/v biases), StableLM-1.6B, and the stub frontends of
MusicGen-medium and InternVL2-76B (fed normal embeddings of their
frontend width through ``frontend_proj``): 2 layers, narrow widths,
vocab 256, MoE at 8 experts top-2; of Jamba-v0.1-52B: 16 layers, the
7:1 mamba/attention interleave and the MoE cadence kept, d_model 256,
d_inner 512, 8 experts top-2, d_state 8) are built once per module by
the JAX package from a fixed key and carried across with
``repro_torch.convert.lm_params_from``, as float32 (the bf16 parameters
cast up) and as bfloat16. Tokens are made with numpy from a seed. Each
case compares the port's `forward`, `prefill` (logits and cache) and
three `decode_step`s with ``repro.models.lm``; the int8-KV decode step
is compared from the reference's quantized cache; `layers.attention_prefill`
and `rwkv._tmix_impl` are also compared alone.

Tolerances, with their reasons:

- float32: 1e-4 of the max. Both sides do the same fp32 arithmetic in
  another order (observed ~1e-6).
- bfloat16: relative L2 error 3e-2 and top-1 agreement on at least 90%
  of rows. The port's attention keeps the softmax probabilities in fp32
  through the P V product, as the flash kernel does, where the
  reference's ``_attn_full`` rounds them to bf16 first; the RWKV scan
  and elementwise ops round at other places too. Observed 0.9-1.5%
  relative L2. Caches that both sides write without rounding apart
  (attention K/V) must be equal.
- Jamba in bfloat16 is held sublayer by sublayer, each mixer and ffn on
  the reference's own input, at the bf16 bound above. Its whole 16-layer
  stack is not compared in bf16: one-ulp differences compound over 16
  layers to ~4-5% per token, and top-2 routing is discontinuous, so a
  one-ulp difference upstream moves a token to another expert and its
  logits 20-40% (observed). In float32 the whole stack is held at 1e-4.
  DBRX's and Granite-MoE's bf16 stacks are held the same way: their
  routing flips too, and the reference's own bf16 DBRX stack is 4.9%
  (relative L2) from its fp32 stack on this module's tokens.
- Jamba's conv cache is rounded to bf16 from fp32 values that differ by
  ~1e-7, so even in float32 a rounding can flip there: one bf16 ulp
  (2^-7 of the max). The mamba states that decode builds from those
  conv windows (``conv`` and ``ssm`` after the decode steps) carry the
  flips and get the same bound; the decode logits keep 1e-4.
- int8-KV decode: logits as above per dtype. The prompt's codes come
  from the reference and must stay equal. In float32 the new tokens'
  codes may differ by ±1 on at most 1e-3 of the codes, where ``k /
  scale`` lands on a rounding boundary; in bfloat16 the new tokens are
  quantized from K/V a few bf16 ulp apart, so their dequantized values
  are held at the bf16 bound. InternVL2's float32 case is left out: one
  flip on its smoke embeddings moves the logits 2.1e-4 (observed), past
  the float32 bound.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke_config
from repro.models.extract import arch_workload as ref_arch_workload
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import rwkv as RR
from repro.models import ssm as RS
from repro_torch import convert
from repro_torch.configs import CONFIG_NAMES, ArchConfig, load_config, smoke_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M
from repro_torch.models.extract import arch_workload
from repro_torch.models.module import dense_init, param_bytes, param_count

torch.set_num_threads(1)

B, S, CACHE_LEN, N_DECODE = 2, 24, 32, 3
F32_TOL = 1e-4
BF16_REL_L2 = 3e-2
BF16_TOP1 = 0.9
BF16_ULP = 2.0**-7
MAX_FLIP_SHARE = 1e-3


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_max(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _close(got, want, dtype):
    if dtype == "float32":
        assert _rel_max(got, want) <= F32_TOL
    else:
        assert _rel_l2(got, want) <= BF16_REL_L2
        g, w = _np(got), _np(want)
        assert (g.argmax(-1) == w.argmax(-1)).mean() >= BF16_TOP1


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x, tree
    )


#: the configurations fed tokens, and the two stub modality frontends
#: (InternVL2-76B, MusicGen-medium), fed precomputed embeddings
TEXT_CONFIGS = tuple(n for n in CONFIG_NAMES if load_config(n).frontend == "none")
STUB_CONFIGS = tuple(n for n in CONFIG_NAMES if n not in TEXT_CONFIGS)

#: configurations with a top-k routed MoE: their whole bf16 stack is held
#: sublayer by sublayer (module docstring)
MOE_CONFIGS = tuple(n for n in TEXT_CONFIGS if load_config(n).n_experts)

CASES = [
    (n, d) for n in TEXT_CONFIGS + STUB_CONFIGS for d in ("float32", "bfloat16")
    if not (n in MOE_CONFIGS and d == "bfloat16")  # sublayer by sublayer, below
]


def _inputs(case, steps):
    """The model inputs at ``steps`` (a slice: a prompt; an index: one
    decode step) for the reference (jnp) and the port (torch): tokens, or
    a stub frontend's embeddings."""
    key = "tokens" if case["cfg"].frontend == "none" else "embeds"
    a = case["toks"] if key == "tokens" else case["embeds"]
    return {key: jnp.asarray(a[:, steps])}, {key: torch.from_numpy(a[:, steps])}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    """Both packages' smoke model on the same parameters and tokens, and
    the reference's prefill and decode results."""
    name, dtype = request.param
    rcfg = ref_smoke_config(_ref_config(name))
    cfg = smoke_config(load_config(name))
    rp = rlm.init_params(jax.random.PRNGKey(0), rcfg)
    if dtype == "float32":
        rp = _f32(rp)
    tp = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + N_DECODE))
    embeds = np.random.default_rng(8).standard_normal(
        (B, S + N_DECODE, cfg.frontend_dim)).astype(np.float32)
    out = dict(name=name, dtype=dtype, rcfg=rcfg, cfg=cfg, rp=rp, tp=tp,
               toks=toks, embeds=embeds)
    r_logits, r_cache = rlm.prefill(rp, rcfg, _inputs(out, slice(0, S))[0],
                                    CACHE_LEN)
    r_cache0 = jax.tree_util.tree_map(np.asarray, r_cache)
    r_steps = []
    for i in range(N_DECODE):
        pos = jnp.full((B,), S + i, jnp.int32)
        logits, r_cache = rlm.decode_step(rp, rcfg, r_cache,
                                          _inputs(out, S + i)[0], pos)
        r_steps.append(np.asarray(logits))
    return dict(out, r_logits=np.asarray(r_logits), r_cache0=r_cache0,
                r_steps=r_steps, r_cache=jax.tree_util.tree_map(np.asarray, r_cache))


def test_forward_matches_reference(case):
    ref_in, port_in = _inputs(case, slice(0, S))
    want = rlm.forward(case["rp"], case["rcfg"], ref_in, remat=False)
    got = lm.forward(case["tp"], case["cfg"], port_in)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, case["dtype"])


def test_prefill_logits_and_cache_match_reference(case):
    cfg = case["cfg"]
    step = make_prefill_step(cfg, CACHE_LEN)
    logits, cache = step(case["tp"], _inputs(case, slice(0, S))[1])
    _close(logits, case["r_logits"], case["dtype"])
    want = convert.lm_cache_from(case["r_cache0"], cfg, device="cpu")
    assert len(cache) == len(want) == cfg.n_layers
    for got_l, want_l in zip(cache, want):
        assert sorted(got_l) == sorted(want_l)
        for key in got_l:
            assert got_l[key].dtype == want_l[key].dtype, key
            assert got_l[key].shape == want_l[key].shape, key
            if case["dtype"] == "float32":
                tol = BF16_ULP if key == "conv" else F32_TOL
                assert _rel_max(got_l[key], want_l[key]) <= tol, key
            else:
                assert _rel_l2(got_l[key], want_l[key]) <= BF16_REL_L2, key
    if case["name"] == "mistral_nemo_12b" and case["dtype"] == "bfloat16":
        # the first layer's K/V come before any attention: no rounding apart
        assert torch.equal(cache[0]["k"], want[0]["k"])
        assert torch.equal(cache[0]["v"], want[0]["v"])


def test_decode_steps_match_reference(case):
    cfg = case["cfg"]
    _, cache = lm.prefill(case["tp"], cfg, _inputs(case, slice(0, S))[1], CACHE_LEN)
    serve = make_serve_step(cfg)
    for i in range(N_DECODE):
        pos = torch.full((B,), S + i)
        logits, cache = serve(case["tp"], cache, _inputs(case, S + i)[1], pos)
        _close(logits, case["r_steps"][i], case["dtype"])
    want = convert.lm_cache_from(case["r_cache"], cfg, device="cpu")
    for got_l, want_l in zip(cache, want):
        for key in got_l:
            assert got_l[key].shape == want_l[key].shape, key
            tol = F32_TOL if case["dtype"] == "float32" else BF16_REL_L2
            if key in ("conv", "ssm"):  # decode reads the bf16 conv cache
                tol = max(tol, BF16_ULP)
            assert _rel_max(got_l[key], want_l[key]) <= tol, key


def _quantized(cache, rcfg):
    """The reference's cache with its attention layers quantized by the
    reference's `quantize_kv`, as a serving stack would hand it over."""
    out = []
    for (mixer, _), c in zip(rcfg.pattern(), cache):
        if mixer == "attn":
            c = {"k": RL.quantize_kv(c["k"])[0], "v": RL.quantize_kv(c["v"])[0],
                 "k_scale": RL.quantize_kv(c["k"])[1],
                 "v_scale": RL.quantize_kv(c["v"])[1]}
        out.append(c)
    return tuple(out)


@pytest.mark.parametrize(
    "case",
    # RWKV has no KV cache. InternVL2 in float32 is not held here: on its
    # smoke embeddings one new K code lands on a rounding boundary and
    # flips by 1 (allowed below), which moves the fp32 logits 2.1e-4
    # (observed), past the fp32 logits bound
    [c for c in CASES
     if c[0] != "rwkv6_7b" and c != ("internvl2_76b", "float32")],
    indirect=True, ids=lambda c: f"{c[0]}-{c[1]}",
)
def test_kv_quant_decode_matches_reference(case):
    """Two decode steps with ``kv_quant=True`` from the reference's prefill
    cache quantized by the reference; int8 codes and bf16 scales cross
    through `convert.lm_cache_from`."""
    cfg, rcfg = case["cfg"], case["rcfg"]
    r_cache = _quantized(jax.tree_util.tree_map(jnp.asarray, case["r_cache0"]), rcfg)
    cache = convert.lm_cache_from(jax.tree_util.tree_map(np.asarray, r_cache), cfg,
                                  device="cpu")
    attn = [i for i, (m, _) in enumerate(cfg.layer_plan()) if m == "attn"]
    assert cache[attn[0]]["k"].dtype == torch.int8
    assert cache[attn[0]]["k_scale"].dtype == torch.bfloat16
    serve = make_serve_step(cfg, kv_quant=True)
    for i in range(2):
        pos = jnp.full((B,), S + i, jnp.int32)
        ref_in, port_in = _inputs(case, S + i)
        want, r_cache = rlm.decode_step(case["rp"], rcfg, r_cache, ref_in, pos,
                                        kv_quant=True)
        got, cache = serve(case["tp"], cache, port_in, torch.full((B,), S + i))
        _close(got, np.asarray(want), case["dtype"])
    want_cache = convert.lm_cache_from(jax.tree_util.tree_map(np.asarray, r_cache), cfg,
                                       device="cpu")
    for i in attn:
        for key in ("k", "v"):
            got, want = cache[i][key], want_cache[i][key]
            assert got.dtype == torch.int8
            assert torch.equal(got[:, :, :S], want[:, :, :S])  # the prompt's
            if case["dtype"] == "float32":
                d = (got.int() - want.int()).abs()
                assert int(d.max()) <= 1
                assert d.bool().float().mean().item() <= MAX_FLIP_SHARE
            else:  # new tokens quantized from bf16 values a few ulp apart
                scale = f"{key}_scale"
                deq = [c[:, :, S : S + 2].float() * s[:, :, S : S + 2, None].float()
                       for c, s in ((got, cache[i][scale]), (want, want_cache[i][scale]))]
                assert _rel_l2(*deq) <= BF16_REL_L2
        assert bool((cache[i]["k"][:, :, S : S + 2] != 0).any())


def _ref_layer(rp, rcfg, i):
    """Layer i's parameters out of the reference's stacked pytree."""
    rep, j = divmod(i, len(rcfg.pattern()))
    return jax.tree_util.tree_map(lambda a: a[rep], rp["blocks"][j])


def _bf16_model(name):
    rcfg = ref_smoke_config(_ref_config(name))
    cfg = smoke_config(load_config(name))
    rp = rlm.init_params(jax.random.PRNGKey(0), rcfg)
    tp = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + 1))
    return rcfg, cfg, rp, tp, toks


@pytest.fixture(scope="module")
def jamba_bf16():
    return _bf16_model("jamba_v0_1_52b")


def _t(a):
    return convert._lm_tensor(np.asarray(a), "cpu")


def test_jamba_bf16_sublayer_by_sublayer_matches_reference(jamba_bf16):
    """Every mixer and ffn of the bf16 Jamba smoke stack, in prefill and in
    one decode step, on the reference's own input to it: outputs and
    caches at relative L2 3e-2."""
    seen = _bf16_sublayer_by_sublayer(*jamba_bf16)
    assert seen == {("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}


@pytest.mark.parametrize("name", [n for n in MOE_CONFIGS if n != "jamba_v0_1_52b"])
def test_moe_bf16_sublayer_by_sublayer_matches_reference(name):
    """The bf16 smoke stacks of DBRX-132B and Granite-MoE-3B, held as
    Jamba's is: their top-k routing flips on one-ulp differences, and
    the reference's own bf16 stack is as far from its fp32 stack as the
    port's (DBRX: 4.9% and 3.4% relative L2 on this module's tokens)."""
    seen = _bf16_sublayer_by_sublayer(*_bf16_model(name))
    assert seen == {("attn", "moe")}


def _bf16_sublayer_by_sublayer(rcfg, cfg, rp, tp, toks):
    """Each mixer and ffn on the reference's own input to it, in prefill
    and one decode step: outputs and caches at relative L2 3e-2. Returns
    the (mixer, ffn) kinds met."""
    x = rp["embed"][jnp.asarray(toks[:, :S])]
    x1 = rp["embed"][jnp.asarray(toks[:, S])][:, None, :]
    rpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    tpos = torch.arange(S).expand(B, S)
    dpos = torch.full((B,), S)
    seen = set()
    for i, (mixer, ffn) in enumerate(cfg.layer_plan()):
        rb, tb = _ref_layer(rp, rcfg, i), tp["blocks"][i]
        if mixer == "attn":
            want, r_cache = RL.attention_prefill(rb["mixer"], x, rcfg, rpos, S + 1)
            got, cache = L.attention_prefill(tb["mixer"], _t(x), cfg, tpos, S + 1)
            want1, _ = RL.attention_decode(rb["mixer"], x1, rcfg, r_cache,
                                           jnp.full((B,), S, jnp.int32))
            got1, _ = L.attention_decode(
                tb["mixer"], _t(x1), cfg, {k: _t(v) for k, v in r_cache.items()}, dpos)
        else:
            want, r_cache = RS.mamba_prefill(rb["mixer"], x, rcfg)
            got, cache = M.mamba_prefill(tb["mixer"], _t(x), cfg)
            want1, _ = RS.mamba_decode(rb["mixer"], x1, rcfg, r_cache)
            got1, _ = M.mamba_decode(
                tb["mixer"], _t(x1), cfg, {k: _t(v) for k, v in r_cache.items()})
        for g, w in [(got, want), (got1, want1)] + [(cache[k], r_cache[k]) for k in cache]:
            assert g.dtype == _t(w).dtype and g.shape == _t(w).shape, (i, mixer)
            assert _rel_l2(g, w) <= BF16_REL_L2, (i, mixer)
        x, x1 = want, want1
        if ffn == "moe":
            want, want1 = RL.moe_dropless(rb["ffn"], x, rcfg), RL.moe_dropless(rb["ffn"], x1, rcfg)
            got, got1 = L.moe_dropless(tb["ffn"], _t(x), cfg), L.moe_dropless(tb["ffn"], _t(x1), cfg)
        else:
            want, want1 = RL.mlp(rb["ffn"], x, rcfg), RL.mlp(rb["ffn"], x1, rcfg)
            got, got1 = L.mlp(tb["ffn"], _t(x), cfg), L.mlp(tb["ffn"], _t(x1), cfg)
        for g, w in ((got, want), (got1, want1)):
            assert _rel_l2(g, w) <= BF16_REL_L2, (i, ffn)
        x, x1 = want, want1
        seen.add((mixer, ffn))
    return seen


@pytest.mark.parametrize("seq", [40, 1088])
def test_attention_prefill_alone_matches_reference(seq):
    """Both sides of the reference's ATTN_CHUNK = 1024 switch: materialised
    below it, q-chunked above; the port takes flash_attention at every S."""
    rcfg = ref_smoke_config(_ref_config("mistral_nemo_12b"))
    cfg = smoke_config(load_config("mistral_nemo_12b"))
    p = _f32(RL.attn_init(jax.random.PRNGKey(1), rcfg))
    tp = {k: convert._lm_tensor(v, "cpu") for k, v in p.items()}
    x = np.random.default_rng(seq).standard_normal((1, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (1, seq))
    want, want_cache = RL.attention_prefill(p, jnp.asarray(x), rcfg,
                                            jnp.asarray(pos), seq + 4)
    got, got_cache = L.attention_prefill(tp, torch.from_numpy(x), cfg,
                                         torch.from_numpy(pos.copy()), seq + 4)
    assert _rel_max(got, want) <= F32_TOL
    for key in ("k", "v"):
        assert _rel_max(got_cache[key], want_cache[key]) <= F32_TOL
    assert torch.equal(L.attention(tp, torch.from_numpy(x), cfg,
                                   torch.from_numpy(pos.copy())), got)


@pytest.mark.parametrize("variant", [dict(qkv_bias=True), dict(mlp_type="gelu")])
def test_qkv_bias_and_gelu_match_reference(variant):
    """The flavours neither served model uses: biased q/k/v projections
    (given non-zero biases) and the gelu MLP (tanh form, as jax.nn.gelu)."""
    rcfg = dataclasses.replace(ref_smoke_config(_ref_config("mistral_nemo_12b")), **variant)
    cfg = dataclasses.replace(smoke_config(load_config("mistral_nemo_12b")), **variant)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32)[None], (2, 20)).copy()
    if "qkv_bias" in variant:
        p = _f32(RL.attn_init(jax.random.PRNGKey(5), rcfg))
        for name in ("bq", "bk", "bv"):
            p[name] = jnp.asarray(rng.standard_normal(p[name].shape), jnp.float32)
        tp = {k: convert._lm_tensor(v, "cpu") for k, v in p.items()}
        want = RL.attention(p, jnp.asarray(x), rcfg, jnp.asarray(pos))
        got = L.attention(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    else:
        p = _f32(RL.mlp_init(jax.random.PRNGKey(5), rcfg))
        assert "w_gate" not in p
        tp = {k: convert._lm_tensor(v, "cpu") for k, v in p.items()}
        want = RL.mlp(p, jnp.asarray(x), rcfg)
        got = L.mlp(tp, torch.from_numpy(x), cfg)
    assert _rel_max(got, want) <= F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tmix_impl_alone_matches_reference(dtype):
    rcfg = ref_smoke_config(_ref_config("rwkv6_7b"))
    cfg = smoke_config(load_config("rwkv6_7b"))
    p = RR.rwkv_tmix_init(jax.random.PRNGKey(3), rcfg)
    if dtype == "float32":
        p = _f32(p)
    tp = {k: convert._lm_tensor(np.asarray(v), "cpu") for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 100, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = convert._lm_tensor(np.asarray(jx), "cpu")
    want, want_c = RR._tmix_impl(p, jx, rcfg)
    got, got_c = R._tmix_impl(tp, tx, cfg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    assert _rel_max(got_c["S"], want_c["S"]) <= (F32_TOL if dtype == "float32" else BF16_REL_L2)
    assert torch.equal(got_c["tmix_last"], convert._lm_tensor(np.asarray(want_c["tmix_last"]), "cpu"))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_decode_after_prefill_equals_longer_prefill(name):
    """Teacher forcing inside the port (what chip_smoke.py checks on the
    card): decode logits at step S equal the last logits of a prefill
    over S+1 tokens (or embeddings, for a stub frontend). float32
    parameters, but RWKV's token-shift states pass through the cache in
    bf16 (as in the reference), which moves the decode logits by ~3e-3
    relative: relative L2 1e-2, same top-1."""
    cfg = smoke_config(load_config(name))
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(gen, cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    if cfg.frontend == "none":
        key, seq = "tokens", torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    else:
        key, seq = "embeds", torch.from_numpy(
            rng.standard_normal((B, S + 1, cfg.frontend_dim)).astype(np.float32))
    _, cache = lm.prefill(params, cfg, {key: seq[:, :S]}, S + 1)
    got, _ = lm.decode_step(params, cfg, cache, {key: seq[:, S]},
                            torch.full((B,), S))
    want, _ = lm.prefill(params, cfg, {key: seq}, S + 1)
    assert _rel_l2(got, want) <= 1e-2
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_configs_are_copies(name):
    cfg, ref = load_config(name), _ref_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_counts() == ref.param_counts()
    assert dataclasses.asdict(smoke_config(cfg)) == dataclasses.asdict(ref_smoke_config(ref))
    with pytest.raises(ValueError, match="unknown config"):
        load_config("no_such_config")


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_arch_workload_matches_reference(name, mode):
    """The PHAROS layer chain of every configuration, at the batch and
    sequence copilot_decode serves StableLM-1.6B with (8 x 2048), with
    and without the LM head: equal layers."""
    for head in (True, False):
        kw = dict(batch=8, seq=2048, mode=mode, include_head=head)
        got = arch_workload(load_config(name), **kw)
        want = ref_arch_workload(_ref_config(name), **kw)
        assert got == convert.workload_from(want)
    if name == "stablelm_1_6b" and mode == "decode":
        assert len(got.layers) + 1 == 121  # the served chain: 24 x 5 + head


def test_arch_workload_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        arch_workload(load_config("stablelm_1_6b"), batch=1, seq=16, mode="serve")


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_init_params_and_cache_have_the_reference_layout(name):
    """Per layer, the port's parameters and cache have the shapes and
    dtypes of the reference's stacked pytrees with the repeats axis
    taken off."""
    rcfg = ref_smoke_config(_ref_config(name))
    cfg = smoke_config(load_config(name))
    ref = jax.tree_util.tree_map(np.asarray, rlm.init_params(jax.random.PRNGKey(0), rcfg))
    want = convert.lm_params_from(ref, cfg, device="cpu")
    got = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in _flatten(t)}
    assert flat(got) == flat(want)
    assert param_count(got) == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref))
    assert param_bytes(got) == sum(x.nbytes for x in jax.tree_util.tree_leaves(ref))
    spec = rlm.cache_spec(rcfg, B, CACHE_LEN)
    ref_cache = [
        {k: (tuple(shp[1:]), np.dtype(dt).name) for k, (shp, dt) in spec[i % len(spec)].items()}
        for i in range(cfg.n_layers)
    ]
    cache = lm.init_cache(cfg, B, CACHE_LEN, device="cpu")
    assert [
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in c.items()}
        for c in cache
    ] == ref_cache
    assert all(not v.any() for c in cache for v in c.values())
    q8_spec = rlm.cache_spec(rcfg, B, CACHE_LEN, kv_quant=True)
    assert [
        {k: (tuple(shp), str(dt).replace("torch.", "")) for k, (shp, dt) in c.items()}
        for c in lm.cache_spec(cfg, B, CACHE_LEN, kv_quant=True)
    ] == [
        {k: (tuple(shp[1:]), np.dtype(dt).name) for k, (shp, dt) in q8_spec[i % len(q8_spec)].items()}
        for i in range(cfg.n_layers)
    ]
    if name == "rwkv6_7b":
        alone = R.rwkv_cache_init(cfg, B, device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in alone.items()} == {
            k: (v.shape, v.dtype) for k, v in cache[0].items()
        }


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_dense_init_is_a_truncated_fan_in_normal():
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, 400, 300, torch.float32, device="cpu")
    std = 1 / 400**0.5
    assert w.abs().max() <= 2 * std
    assert abs(w.std().item() / std - 0.88) < 0.02  # std of N(0,1) cut at ±2
    assert dense_init(torch.Generator().manual_seed(0), 4, 4, device="cpu").dtype == torch.bfloat16


def test_bf16_arrays_cross_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)), jnp.bfloat16)
    t = convert._lm_tensor(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), np.asarray(x).view(np.int16))


@pytest.mark.parametrize("frontend", ["vision_stub", "audio_stub"])
def test_every_entry_point_builds_both_frontends(frontend):
    """Every layer kind is served, and every entry point builds a stub
    modality frontend: ``frontend_proj`` and an untied ``lm_head`` in
    place of the embedding, embeddings in, logits over the vocabulary
    out, forward, prefill, decode and the train step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    base = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab=64)
    served = ArchConfig(**base, attn_every=2, n_experts=4, top_k=2, moe_every=2)
    assert {m for m, _ in served.layer_plan()} == {"attn", "mamba"}
    assert {f for _, f in served.layer_plan()} == {"dense", "moe"}
    assert len(lm.cache_spec(served, 1, 16)) == 2
    cfg = ArchConfig(**base, frontend=frontend, frontend_dim=16, tie_embeddings=True)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    assert "embed" not in params
    assert params["frontend_proj"].shape == (16, 32)
    assert params["lm_head"].shape == (32, 64)  # untied, whatever the config says
    emb = torch.randn((1, 8, 16), generator=torch.Generator().manual_seed(1))
    assert lm.forward(params, cfg, {"embeds": emb}).shape == (1, 8, 64)
    logits, cache = make_prefill_step(cfg, 16)(params, {"embeds": emb})
    assert logits.shape == (1, 64) and len(cache) == len(lm.cache_spec(cfg, 1, 16))
    logits, _ = make_serve_step(cfg)(params, cache, {"embeds": emb[:, 0]},
                                     torch.full((1,), 8))
    assert logits.shape == (1, 64) and bool(torch.isfinite(logits).all())
    batch = {"embeds": emb, "labels": torch.zeros((1, 8), dtype=torch.long)}
    _, _, metrics = make_train_step(cfg, AdamWConfig())(params, adamw_init(params),
                                                        batch)
    assert np.isfinite(metrics["loss"].item())
