"""The port's training path against the JAX package's, on the CPU.

The attention gradient (`attention_backward_plain`, what the backward
kernel is held against on the card), `models.lm.loss_fn` and its
gradients on all ten configs (WKV-6 and the selective scan through their
plain backwards, the stub frontends on embeddings),
`launch.steps.make_train_step` (with and without micro-batches, and on
the recurrent mixers and a stub frontend), the weight-decay leaf set,
`layers.moe_aux_loss`, and `launch.train.train_loop` (learning, resuming
and taking every config). The same numpy inputs go to both packages; JAX
parameters cross over with ``repro_torch.convert.lm_params_from`` (its
gradients the same way) and AdamW states with ``adamw_state_from``. On
the CPU the attention runs through the plain versions, forward and
backward, inside the port's ``torch.autograd.Function``.

Tolerances, with their reasons (all fp32):

- the attention gradient: 1e-5 of the max against autograd of
  `attention_plain` and against ``jax.grad`` of the reference's oracle;
  the three compute the same fp32 sums in other orders (observed ~3e-7).
- loss: relative 1e-5; each gradient leaf: relative L2 1e-4. The two
  packages run the same fp32 model in other summation orders (the
  gradients sum over B x S tokens; observed ~1e-6).
- train steps: losses relative 1e-4 and parameters relative L2 1e-4
  after 3 AdamW steps, as above plus the optimizer's first steps, where
  a gradient element near 0 whose sign differs moves its parameter by
  2 lr.
- Jamba's train steps (16 smoke layers, its ffns dense): losses and grad
  norms as above, parameters relative L2 1e-3 after 3 steps. Its fp32
  gradients agree to ~3e-5 (observed, step 0), and AdamW's first steps
  divide each gradient element by its own size, so elements of the size
  of that difference move by up to 2 lr apart: the zero-initialised conv
  biases and the embedding come out 2-7e-4 apart (observed).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as ref_smoke_config
from repro.kernels.flash_attention.ref import attention_ref
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import convert
from repro_torch.configs import load_config, smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_plain,
    attention_plain,
)
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.launch.train import train_loop
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.tree import flatten, flatten_with_paths

torch.set_num_threads(1)

GRAD_MAX_TOL = 1e-5
LOSS_REL_TOL = 1e-5
LEAF_REL_L2 = 1e-4
STEP_REL_TOL = 1e-4
JAMBA_PARAM_REL_L2 = 1e-3

#: the smoke configurations held against the reference: dense MHA
#: (StableLM), GQA with gelu (Minitron), GQA (Mistral-NeMo), q/k/v biases
#: (Qwen1.5), MoE (DBRX), MoE with tied embeddings (Granite-MoE), RWKV-6
#: (WKV-6 and channel-mix), Jamba (mamba, attention and MoE), and the
#: stub frontends' embeddings (MusicGen-medium, InternVL2-76B)
LOSS_CONFIGS = ("stablelm_1_6b", "minitron_4b", "mistral_nemo_12b",
                "qwen1_5_32b", "dbrx_132b", "granite_moe_3b_a800m",
                "rwkv6_7b", "jamba_v0_1_52b", "musicgen_medium",
                "internvl2_76b")


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _models(name, dtype=jnp.float32, **overrides):
    """(reference config, port config, reference params, port params) of
    a smoke model, with ``overrides`` replaced in both configs: the
    reference's init, carried across."""
    rcfg = dataclasses.replace(ref_smoke_config(_ref_config(name)), **overrides)
    cfg = dataclasses.replace(smoke_config(load_config(name)), **overrides)
    rp = rlm.init_params(jax.random.PRNGKey(0), rcfg, dtype=dtype)
    tp = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                device="cpu")
    return rcfg, cfg, rp, tp


def _batch(vocab, B, S, seed, frontend_dim=0):
    """Tokens (or, with ``frontend_dim``, a stub frontend's embeddings,
    normal), labels and a mask with a few zeros, as numpy."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    batch = {
        "tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, vocab, (B, S)).astype(np.int32),
        "mask": mask,
    }
    if frontend_dim:
        del batch["tokens"]
        batch["embeds"] = rng.standard_normal((B, S, frontend_dim)).astype(np.float32)
    return batch


def _to_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_close(got_tree, want_tree, tol):
    paths, got, _ = flatten_with_paths(got_tree)
    want_paths, want, _ = flatten_with_paths(want_tree)
    assert paths == want_paths
    for path, g, w in zip(paths, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert _rel_l2(g, w) <= tol, (path, _rel_l2(g, w))


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,hd", [(2, 64, 4, 4, 16), (2, 37, 8, 2, 16),
                                          (1, 130, 4, 1, 32)])
def test_plain_backward_matches_autograd_and_jax(B, S, H, Hkv, hd, causal):
    rng = np.random.default_rng(S + H)
    q, do = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, S, Hkv, hd)).astype(np.float32) for _ in range(2))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attention_plain(qt, kt, vt, causal=causal)
    want_torch = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, causal=causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want_jax = vjp(jnp.asarray(do))
    args = (qt.detach(), kt.detach(), vt.detach(), o.detach(), torch.from_numpy(do))
    # P as a normalised softmax, and rebuilt from the forward's lse as the
    # kernels rebuild it
    _, lse = attention_plain(*args[:3], causal=causal, return_lse=True)
    for got in (attention_backward_plain(*args, causal=causal),
                attention_backward_plain(*args, lse, causal=causal)):
        for g, wt, wj in zip(got, want_torch, want_jax):
            assert g.dtype == torch.float32 and g.shape == wt.shape
            scale = np.abs(_np(wj)).max()
            assert np.abs(_np(g) - _np(wt)).max() <= GRAD_MAX_TOL * scale
            assert np.abs(_np(g) - _np(wj)).max() <= GRAD_MAX_TOL * scale


def test_flash_attention_is_differentiable_through_the_plain_versions():
    """On CPU tensors the autograd function runs `attention_plain` forward
    and `attention_backward_plain` backward; with grad off it is the
    forward alone."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 4, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.square().sum().backward()
    want = torch.autograd.grad(attention_plain(q, k, v).square().sum(), (q, k, v))
    for t, w in zip((q, k, v), want):
        assert torch.allclose(t.grad, w, rtol=0, atol=1e-5)
    with torch.inference_mode():
        assert flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_loss_and_grads_match_reference(name):
    """fp32 smoke model, B 2 x S 640: the CE chunk halves from 512 to 128
    (640 = 5 x 128) in both packages."""
    rcfg, cfg, rp, tp = _models(name)
    batch = _batch(cfg.vocab, 2, 640, seed=11, frontend_dim=cfg.frontend_dim)
    (r_loss, r_metrics), r_grads = jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rcfg, _to_ref(batch)), has_aux=True)(rp)
    (loss, metrics), grads = value_and_grad(tp, cfg, _to_port(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - float(r_loss)) <= LOSS_REL_TOL * abs(float(r_loss))
    assert metrics["tokens"].item() == float(r_metrics["tokens"])
    want = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, r_grads),
                                  cfg, device="cpu")
    _leaves_close(grads, want, LEAF_REL_L2)


def test_remat_on_and_off_give_the_same_loss_and_grads():
    _, cfg, _, tp = _models("mistral_nemo_12b")
    batch = _to_port(_batch(cfg.vocab, 2, 96, seed=2))
    (l_on, _), g_on = value_and_grad(tp, cfg, batch, remat=True)
    (l_off, _), g_off = value_and_grad(tp, cfg, batch, remat=False)
    assert torch.equal(l_on, l_off)
    for a, b in zip(flatten(g_on)[0], flatten(g_off)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_train_steps_match_reference(micro_batches):
    """Three AdamW steps of smoke StableLM (fp32) from the same parameters
    and batches, against the reference's jitted step."""
    rcfg, cfg, rp, tp = _models("stablelm_1_6b")
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    r_step = jax.jit(ref_make_train_step(rcfg, RefAdamWConfig(**kw),
                                         micro_batches=micro_batches))
    step = make_train_step(cfg, AdamWConfig(**kw), micro_batches=micro_batches)
    r_opt = ref_adamw_init(rp)
    opt = convert.adamw_state_from(jax.tree_util.tree_map(np.asarray, r_opt),
                                   cfg, device="cpu")
    for i in range(3):
        batch = _batch(cfg.vocab, 4, 32, seed=20 + i)
        rp, r_opt, r_m = r_step(rp, r_opt, _to_ref(batch))
        tp, opt, m = step(tp, opt, _to_port(batch))
        for key in ("loss", "grad_norm", "lr"):
            assert abs(m[key].item() - float(r_m[key])) <= (
                STEP_REL_TOL * abs(float(r_m[key]))), key
    assert int(opt["step"]) == int(r_opt["step"]) == 3
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    _leaves_close(tp, convert.lm_params_from(host(rp), cfg, device="cpu"),
                  STEP_REL_TOL)
    want_opt = convert.adamw_state_from(host(r_opt), cfg, device="cpu")
    for key in ("m", "v"):
        _leaves_close(opt[key], want_opt[key], STEP_REL_TOL)


@pytest.mark.parametrize("name", LOSS_CONFIGS)
def test_weight_decay_goes_to_the_reference_leaves(name):
    """The reference decays leaves of ndim >= 2 of its stacked tree: every
    block leaf (norm scales and q/k/v biases too, through the repeats
    axis), embed and lm_head, not final_norm. The port's per-layer
    leaves are one dimension lower; `lm.decay_mask` names the same
    set."""
    rcfg, cfg, rp, tp = _models(name)
    mask = lm.decay_mask(tp)
    n_pat = len(rcfg.pattern())
    assert len(mask["blocks"]) == cfg.n_layers
    for i, blk in enumerate(mask["blocks"]):
        want = jax.tree_util.tree_map(lambda p: p.ndim >= 2,
                                      rp["blocks"][i % n_pat])
        assert blk == want, i
    assert sorted(mask) == sorted(rp)
    for key in rp:
        if key != "blocks":
            assert mask[key] == (rp[key].ndim >= 2), key
    assert mask["final_norm"] is False and mask["lm_head" if cfg.frontend != "none"
                                                else "embed"] is True
    if cfg.frontend != "none":
        assert mask["frontend_proj"] is True
    assert all(flatten(mask["blocks"])[0])
    if cfg.qkv_bias:
        assert mask["blocks"][0]["mixer"]["bq"] is True


@pytest.mark.parametrize("name,overrides,param_tol", [
    ("rwkv6_7b", {}, STEP_REL_TOL),
    ("jamba_v0_1_52b", {"n_experts": 0, "top_k": 0}, JAMBA_PARAM_REL_L2),
    ("musicgen_medium", {}, STEP_REL_TOL)])
def test_recurrent_and_stub_train_steps_match_reference(name, overrides, param_tol):
    """Three AdamW steps of a smoke model with recurrent mixers (RWKV-6;
    Jamba's mamba and attention) or a stub frontend (MusicGen), fp32, from
    the same parameters and batches, against the reference's jitted step:
    losses, grad norms and parameters as `test_train_steps_match_
    reference`. Jamba's ffns are dense here: its top-2 routing is
    discontinuous, and after the first AdamW step (which moves a
    parameter whose gradient is near 0 by lr with that gradient's sign)
    a token can change experts between the packages (observed: the MoE
    stack's second-step loss 0.3% apart, the dense one's 4e-6). Its MoE
    gradients are held at one step by `test_loss_and_grads_match_
    reference`. Its parameters are held at JAMBA_PARAM_REL_L2 (module
    docstring)."""
    rcfg, cfg, rp, tp = _models(name, **overrides)
    kw = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    r_step = jax.jit(ref_make_train_step(rcfg, RefAdamWConfig(**kw)))
    step = make_train_step(cfg, AdamWConfig(**kw))
    r_opt = ref_adamw_init(rp)
    opt = convert.adamw_state_from(jax.tree_util.tree_map(np.asarray, r_opt),
                                   cfg, device="cpu")
    for i in range(3):
        batch = _batch(cfg.vocab, 2, 32, seed=40 + i, frontend_dim=cfg.frontend_dim)
        rp, r_opt, r_m = r_step(rp, r_opt, _to_ref(batch))
        tp, opt, m = step(tp, opt, _to_port(batch))
        for key in ("loss", "grad_norm", "lr"):
            assert abs(m[key].item() - float(r_m[key])) <= (
                STEP_REL_TOL * abs(float(r_m[key]))), key
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    _leaves_close(tp, convert.lm_params_from(host(rp), cfg, device="cpu"),
                  param_tol)


def test_moe_aux_loss_matches_reference():
    """The load-balancing loss of a smoke DBRX MoE layer, value and
    gradient (router and norm scale, through the top-1 share and the
    mean probabilities), against ``jax.value_and_grad`` of the
    reference's: loss relative 1e-5, each gradient relative L2 1e-4."""
    rcfg, cfg, rp, tp = _models("dbrx_132b")
    r_layer = jax.tree_util.tree_map(lambda a: a[0], rp["blocks"][0]["ffn"])
    layer = tp["blocks"][0]["ffn"]
    x = np.random.default_rng(8).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    r_val, r_grad = jax.value_and_grad(
        lambda p: RL.moe_aux_loss(p, jnp.asarray(x), rcfg))(r_layer)
    live = {k: v.detach().requires_grad_() for k, v in layer.items()}
    val = L.moe_aux_loss(live, torch.from_numpy(x), cfg)
    grads = torch.autograd.grad(val, [live["router"], live["norm"]])
    assert val.dtype == torch.float32 and val.shape == ()
    assert abs(val.item() - float(r_val)) <= LOSS_REL_TOL * abs(float(r_val))
    for g, key in zip(grads, ("router", "norm")):
        assert _rel_l2(g, r_grad[key]) <= LEAF_REL_L2, key


@pytest.mark.parametrize("name", ["rwkv6_7b", "jamba_v0_1_52b", "musicgen_medium",
                                  "internvl2_76b"])
def test_train_loop_takes_every_config(name):
    """`train_loop` on a smoke model of each configuration with a
    recurrent mixer or a stub frontend: finite losses, the latter fed one-hot
    embeddings of the tokens, as the reference's
    `launch/train.py` feeds them."""
    cfg = smoke_config(load_config(name))
    losses = train_loop(cfg, steps=3, global_batch=2, seq_len=16,
                        log_every=1000, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------
def test_train_loop_learns_smoke_stablelm():
    """The reference's `test_training_loss_decreases_smoke` criterion."""
    cfg = smoke_config(load_config("stablelm_1_6b"))
    losses = train_loop(cfg, steps=150, global_batch=8, seq_len=64, lr=1e-3,
                        log_every=1000, device="cpu")
    assert len(losses) == 150 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.8


def test_train_loop_resumes_to_the_same_losses(tmp_path):
    """The reference's `test_training_checkpoint_resume_identical`: a run
    stopped at step 20 and resumed from its checkpoint ends as the
    uninterrupted one, and calls ``on_step`` for the steps it runs."""
    cfg = smoke_config(load_config("minitron_4b"))
    kw = dict(global_batch=4, seq_len=32, log_every=1000, ckpt_every=10,
              schedule_steps=30, device="cpu")
    full = train_loop(cfg, steps=30, ckpt_dir=str(tmp_path / "a"), **kw)
    train_loop(cfg, steps=20, ckpt_dir=str(tmp_path / "b"), **kw)
    seen = []
    resumed = train_loop(cfg, steps=30, ckpt_dir=str(tmp_path / "b"),
                         on_step=lambda s, l: seen.append(s), **kw)
    assert seen == list(range(20, 30))
    np.testing.assert_allclose(resumed[-10:], full[-10:], rtol=STEP_REL_TOL)
