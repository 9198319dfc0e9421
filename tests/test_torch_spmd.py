"""The port's SPMD sharding policy, GShard capacity MoE and `lowerable`
against the JAX package's, on the CPU.

- `activation_policy` on the production meshes (16x16 and 2x16x16, under
  torch's fake process group) and the 2x2 dev mesh: every field's spec
  equals the reference's ``PartitionSpec`` on a ``jax.sharding.
  AbstractMesh`` of the same axes, for 0, 16 and 40 experts; the pins
  redistribute DTensors and refuse plain tensors.
- `layers.moe_capacity` against the reference's, fp32, groups 1, 2, 4,
  capacity factors 8 and 0.25, padded expert banks, swiglu and gelu: 1e-5
  of the output's max (both run the same fp32 products; they differ in
  summation order, ~1e-7 observed). With a tight capacity ``top_k`` picks
  among zero-score tokens, where the two packages may pick other indices;
  those slots carry zero weight, so outputs are compared, not indices.
  The reference's two capacity tests are repeated on the port.
- On 4 gloo ranks (a 2x2 data x model mesh, spawned by the pipeline
  executor's `launch`): the port's `lm.forward`, `lm.loss_fn` and one
  `lowerable` train step under the policy, against the reference's under
  a one-device policy with the same ``moe_groups``, fp32: logits and the
  loss at relative 1e-5 (the sharded products sum in another order),
  the step's loss at 1e-5 and its parameters at relative L2 1e-4 (AdamW's
  first step divides each gradient element by its own size; as in
  `test_torch_train.py`). Configs: smoke Granite-MoE (capacity MoE,
  padded experts, tied embeddings), smoke StableLM with one KV head on a
  2-wide ``model`` axis, smoke RWKV-6 (WKV-6 on each rank's heads), and
  smoke Jamba's first 2 layers (mamba mixers, the scan on each rank's
  channels; a dense and a capacity-MoE ffn). Jamba's parameters after
  the step are held at relative L2 1e-3, as `test_torch_train.py` holds
  them: its zero-initialised conv biases get gradient elements near 0,
  which AdamW's first step turns into moves of up to 2 lr apart when
  their signs differ (observed 2.6e-4 here; loss and logits at 1e-5).
"""
import dataclasses
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, Mesh, NamedSharding, PartitionSpec
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import smoke_config as ref_smoke_config
from repro.launch import steps as rsteps
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import convert
from repro_torch.configs import load_config, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import make_dev_mesh, make_production_mesh
from repro_torch.launch.steps import activation_policy
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.pipeline.executor import launch
from repro_torch.tree import flatten_with_paths

sys.path.insert(0, os.path.dirname(__file__))
from _torch_spmd_job import spmd_job  # noqa: E402

torch.set_num_threads(1)

MOE_REL_TOL = 1e-5
LOGIT_REL_TOL = LOSS_REL_TOL = 1e-5
PARAM_REL_L2 = 1e-4
JAMBA_PARAM_REL_L2 = 1e-3
#: the global gradient norm: a sum over every gradient element, fp32
GRAD_NORM_REL_TOL = 1e-4

FIELDS = ("act", "logits", "heads", "channels", "gathered", "moe_dispatch")


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


@pytest.fixture(scope="module")
def meshes():
    """The production meshes and a 2x2 dev mesh under the fake process
    group, torn down after the module."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {
            "16x16": (make_production_mesh(device="cpu"), (16, 16),
                      ("data", "model")),
            "2x16x16": (make_production_mesh(multi_pod=True, device="cpu"),
                        (2, 16, 16), ("pod", "data", "model")),
            "2x2": (make_dev_mesh(2, 2, device="cpu"), (2, 2), ("data", "model")),
        }
    finally:
        dist.destroy_process_group()


def _spec(spec):
    """A spec with each one-axis tuple written as the axis alone."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
@pytest.mark.parametrize("n_experts", [0, 16, 40])
@pytest.mark.parametrize("kind", ["train", "decode", "long"])
def test_activation_policy_equals_reference(meshes, mesh_name, n_experts, kind):
    mesh, shape, names = meshes[mesh_name]
    kw = {"train": dict(seq_parallel=True), "decode": {},
          "long": dict(batch_sharded=False)}[kind]
    got = activation_policy(mesh, n_experts=n_experts, **kw)
    want = rsteps.activation_policy(AbstractMesh(shape, names),
                                    n_experts=n_experts, **kw)
    assert got.moe_groups == want.moe_groups
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
            continue
        assert g[0] is mesh
        assert _spec(g[1]) == _spec(tuple(w.spec)) + (None,) * (
            len(g[1]) - len(w.spec)), field


def test_pins_redistribute_dtensors_and_refuse_plain_tensors(meshes):
    mesh = meshes["2x2"][0]
    policy = activation_policy(mesh, seq_parallel=True)
    x = distribute_tensor(torch.zeros(4, 8, 6), mesh, [Replicate(), Replicate()])
    pinned = policy.pin_act(x)
    assert tuple(pinned.placements) == (Shard(0), Shard(1))
    assert tuple(policy.pin_gathered(pinned).placements) == (Shard(0), Replicate())
    assert lm.NO_POLICY.pin_act(torch.zeros(2)) is not None  # unset: passes
    with pytest.raises(TypeError, match="DTensor"):
        policy.pin_act(torch.zeros(4, 8, 6))


# ---------------------------------------------------------------------------
# the capacity MoE
# ---------------------------------------------------------------------------
def _moe_pair(mlp_type, capacity_factor, pad=48):
    """Smoke Granite-MoE's ffn (8 experts, top 2, banks padded to
    ``pad``) in both packages, fp32, from the reference's init."""
    over = dict(mlp_type=mlp_type, capacity_factor=capacity_factor,
                expert_pad_to=pad)
    rcfg = dataclasses.replace(ref_smoke_config(_ref_config("granite_moe_3b_a800m")),
                               **over)
    cfg = dataclasses.replace(smoke_config(load_config("granite_moe_3b_a800m")),
                              **over)
    rp = RL.moe_init(jax.random.PRNGKey(3), rcfg, dtype=jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rcfg, cfg, rp, tp


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_capacity_equals_reference(mlp_type, capacity_factor, groups):
    rcfg, cfg, rp, tp = _moe_pair(mlp_type, capacity_factor)
    x = np.random.default_rng(groups).normal(size=(4, 8, cfg.d_model)).astype(
        np.float32)
    want = RL.moe_capacity(rp, jnp.asarray(x), rcfg, groups=groups)
    got = L.moe_capacity(tp, torch.from_numpy(x), cfg, groups=groups)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel_max(got.numpy(), want) <= MOE_REL_TOL


def test_moe_capacity_rejects_ungrouped_tokens():
    _, cfg, _, tp = _moe_pair("swiglu", 1.25)
    with pytest.raises(ValueError, match="not divisible"):
        L.moe_capacity(tp, torch.zeros(1, 7, cfg.d_model), cfg, groups=2)


def _moe_cfg(**kw):
    return dict(name="t", family="moe", n_layers=2, n_heads=4, n_kv_heads=2,
                n_experts=kw.pop("n_experts"), top_k=2, **kw)


def test_moe_capacity_matches_dropless_when_generous():
    """The reference's test (``tests/test_models.py``) on the port, with
    its inputs: bf16, 8 experts, capacity factor 8."""
    kw = _moe_cfg(d_model=64, d_ff=32, vocab=128, n_experts=8,
                  capacity_factor=8.0)
    rcfg, cfg = RefArchConfig(**kw), ArchConfig(**kw)
    rp = RL.moe_init(jax.random.PRNGKey(0), rcfg)
    p = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16) for k, v in rp.items()}
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 64), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    y_ref = L.moe_dropless(p, xt, cfg).float()
    for groups in (1, 2, 4):
        y = L.moe_capacity(p, xt, cfg, groups=groups).float()
        rel = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert rel < 2e-2, (groups, rel)
    assert L.moe_dropless.host_reads > 0


def test_moe_capacity_drops_under_tight_capacity():
    """The reference's second test on the port: a tight capacity keeps
    the residual path, finite; and the capacity MoE reads nothing back
    to the host."""
    kw = _moe_cfg(d_model=32, d_ff=16, vocab=64, n_experts=4,
                  capacity_factor=0.25)
    rcfg, cfg = RefArchConfig(**kw), ArchConfig(**kw)
    rp = RL.moe_init(jax.random.PRNGKey(0), rcfg)
    p = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" else torch.bfloat16) for k, v in rp.items()}
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    reads = L.moe_dropless.host_reads
    y = L.moe_capacity(p, xt, cfg, groups=1)
    assert bool(torch.isfinite(y.float()).all())
    assert L.moe_dropless.host_reads == reads


# ---------------------------------------------------------------------------
# the model and the train step on 4 gloo ranks
# ---------------------------------------------------------------------------
#: (config, overrides): MoE; one KV head on the 2-wide model axis; RWKV-6
SPMD_CASES = (("granite_moe_3b_a800m", {}),
              ("stablelm_1_6b", {"n_kv_heads": 1}),
              ("rwkv6_7b", {}),
              ("jamba_v0_1_52b", {"n_layers": 2}))
B, S = 4, 16
#: configs whose step also runs in micro-batches (each rank splits its
#: own rows, see `steps._micro_batch`; the all-ones mask gives every
#: micro-batch the same tokens, so the sums are the reference's)
MICRO = {"stablelm_1_6b": 2}
LR = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10)


def _one_device_policy(rcfg):
    """The reference's policy on one device: no pins, the capacity MoE
    with the 2x2 mesh's data groups."""
    if not rcfg.n_experts:
        return rlm.NO_POLICY
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    return rlm.ShardingPolicy(moe_groups=2,
                              moe_dispatch=NamedSharding(mesh, PartitionSpec()))


def _case(name, over, seed):
    rcfg = dataclasses.replace(ref_smoke_config(_ref_config(name)), **over)
    cfg = dataclasses.replace(smoke_config(load_config(name)), **over)
    rp = rlm.init_params(jax.random.PRNGKey(seed), rcfg, dtype=jnp.float32)
    tp = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                device="cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "mask": np.ones((B, S), np.float32)}
    return rcfg, cfg, rp, tp, batch


@pytest.fixture(scope="module")
def spmd_runs():
    """Every case's sharded results (rank 0's; every rank gathers the
    same) from one launch of 4 gloo ranks."""
    cases = [_case(name, over, seed=10 + i)
             for i, (name, over) in enumerate(SPMD_CASES)]
    ranks = launch(spmd_job, 4, backend="gloo", device="cpu", timeout=300.0,
                   args=([(cfg, tp, {k: torch.from_numpy(v) for k, v in b.items()},
                           MICRO.get(name, 1))
                          for (name, _), (_, cfg, _, tp, b) in zip(SPMD_CASES, cases)],
                         AdamWConfig(**LR)))
    return {name: (rcfg, cfg, rp, batch, [r[i] for r in ranks])
            for i, ((name, _), (rcfg, cfg, rp, _, batch))
            in enumerate(zip(SPMD_CASES, cases))}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("name", [n for n, _ in SPMD_CASES])
def test_sharded_forward_and_loss_equal_reference(spmd_runs, name):
    rcfg, cfg, rp, batch, ranks = spmd_runs[name]
    policy = _one_device_policy(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(rlm.forward(rp, rcfg, {"tokens": jb["tokens"]}, policy=policy))
    want_loss = float(rlm.loss_fn(rp, rcfg, jb, policy=policy)[0])
    for r in ranks:  # every rank gathers the same whole tensors
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    got = ranks[0]["logits"]
    assert got.shape == want.shape
    assert _rel_max(got, want) <= LOGIT_REL_TOL
    assert _rel(ranks[0]["step_loss"], want_loss) <= LOSS_REL_TOL


@pytest.mark.parametrize("name", [n for n, _ in SPMD_CASES])
def test_lowerable_train_step_equals_reference(spmd_runs, name):
    rcfg, cfg, rp, batch, ranks = spmd_runs[name]
    step = jax.jit(rsteps.make_train_step(rcfg, RefAdamWConfig(**LR),
                                          policy=_one_device_policy(rcfg)))
    new_p, _, metrics = step(rp, ref_adamw_init(rp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = ranks[0]
    assert _rel(got["step_loss"], float(metrics["loss"])) <= LOSS_REL_TOL
    assert _rel(got["grad_norm"], float(metrics["grad_norm"])) <= GRAD_NORM_REL_TOL
    want = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, new_p), cfg,
                                  device="cpu")
    paths, leaves, _ = flatten_with_paths(want)
    got_leaves = flatten_with_paths(got["params"])[1]
    for path, w, g in zip(paths, leaves, got_leaves):
        w = w.numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        limit = JAMBA_PARAM_REL_L2 if name == "jamba_v0_1_52b" else PARAM_REL_L2
        assert rel <= limit, (path, rel)


def test_micro_batched_sharded_train_step_equals_reference(spmd_runs):
    """`make_train_step` under the policy with 2 micro-batches (fp32
    gradient accumulators as DTensors) against the reference's with 2."""
    rcfg, cfg, rp, batch, ranks = spmd_runs["stablelm_1_6b"]
    step = jax.jit(rsteps.make_train_step(rcfg, RefAdamWConfig(**LR),
                                          micro_batches=2))
    new_p, _, metrics = step(rp, ref_adamw_init(rp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = ranks[0]
    assert _rel(got["micro_loss"], float(metrics["loss"])) <= LOSS_REL_TOL
    want = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, new_p), cfg,
                                  device="cpu")
    for (path, w), g in zip(zip(*flatten_with_paths(want)[:2]),
                            flatten_with_paths(got["micro_params"])[1]):
        w = w.numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= PARAM_REL_L2, (path, rel)
