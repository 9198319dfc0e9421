"""The port's pipeline executor (`repro_torch.pipeline.executor`) on the
CPU: GPipe over gloo, one spawned process per stage.

Cases: the reference's own executor test config (4 layers, d 64, 4/2
heads, d_ff 128, vocab 128) at 4 stages with 6 microbatches of
(2, 16, 64), in float32 and bfloat16; smoke RWKV-6 and smoke Jamba at 2
stages (RWKV-6 in both dtypes, Jamba in float32 only: in bfloat16 its
top-2 MoE routing flips on one-ulp differences, in both packages). Each
rank builds the model from the case's seed; the ranks of one stage count
share one spawn.

- The pipelined output equals, bit for bit, the port's
  `reference_backbone` run in this process on the same parameters and
  microbatches (as the reference's test asserts ``err == 0.0``): each
  microbatch meets the same layers in the same order, with the same
  arithmetic, and the hops copy bits.
- The port's `reference_backbone` against the JAX package's, on the JAX
  package's parameters carried across with ``convert.lm_params_from``
  and the same numpy microbatches: 1e-4 of the max in float32 (the same
  fp32 arithmetic in another order) and relative L2 3e-2 in bfloat16
  (rounding at other places; ``tests/test_torch_lm.py`` gives the
  reasons).
- The reference's ``ValueError`` on stages that do not divide the
  repeats; nccl with fewer cards than stages raises; a rank that raises
  fails the launch at once, and a launch past its timeout fails.

The JAX package's own executor test runs it in a subprocess on four
placeholder CPU devices and fails on this tree, so the port is held to
`reference_backbone` computed here.
"""
import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import ArchConfig as RefArchConfig
from repro.configs.base import smoke_config as ref_smoke_config
from repro.models import lm as rlm
from repro.pipeline import executor as rexec
from repro_torch import convert
from repro_torch.configs import ArchConfig, load_config, smoke_config
from repro_torch.models import lm
from repro_torch.pipeline.executor import (
    BackboneCase,
    backbone_job,
    launch,
    pipeline_backbone,
    reference_backbone,
    split_blocks_for_stages,
)

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_REL_L2 = 3e-2
TIMEOUT = 120.0

#: the reference's executor test config (tests/test_pipeline.py)
EXEC_CFG = dict(name="t", family="dense", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab=128)
CPU = torch.device("cpu")


def _case(name, dtype, n_micro, seed):
    cfg = (ArchConfig(**EXEC_CFG) if name == "exec"
           else smoke_config(load_config(name)))
    return BackboneCase(cfg, dtype, n_micro, 2, 16, seed)


#: (stages, case) of each run
FOUR = [_case("exec", torch.float32, 6, 0), _case("exec", torch.bfloat16, 6, 0)]
TWO = [_case("rwkv6_7b", torch.float32, 3, 1), _case("rwkv6_7b", torch.bfloat16, 3, 1),
       _case("jamba_v0_1_52b", torch.float32, 3, 2)]
RUNS = [(4, i) for i in range(len(FOUR))] + [(2, i) for i in range(len(TWO))]


def _id(run):
    stages, i = run
    case = (FOUR if stages == 4 else TWO)[i]
    return f"{case.cfg.name}-{str(case.dtype)[6:]}-{stages}stages"


@pytest.fixture(scope="module")
def launched():
    """Each stage count's ranks, spawned once for all its cases."""
    return {4: launch(backbone_job, 4, backend="gloo", device="cpu",
                      timeout=TIMEOUT, args=(FOUR,)),
            2: launch(backbone_job, 2, backend="gloo", device="cpu",
                      timeout=TIMEOUT, args=(TWO,))}


@pytest.mark.parametrize("run", RUNS, ids=_id)
def test_pipelined_output_equals_reference_backbone(launched, run):
    stages, i = run
    case = (FOUR if stages == 4 else TWO)[i]
    ranks = [r[i] for r in launched[stages]]
    params = lm.init_params(torch.Generator().manual_seed(case.seed), case.cfg,
                            case.dtype, device="cpu")
    want = reference_backbone(case.cfg, params, case.micro(CPU))
    got = ranks[-1]["out"]
    assert got.dtype == case.dtype
    assert tuple(got.shape) == (case.n_micro, case.batch, case.seq, case.cfg.d_model)
    assert torch.equal(got, want)
    assert torch.equal(ranks[0]["ref"], want)  # rank 0's own sequential run
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("stages", [4, 2])
def test_each_rank_holds_its_segment_and_sends_each_microbatch(launched, stages):
    for i, case in enumerate(FOUR if stages == 4 else TWO):
        for stage, rank in enumerate(r[i] for r in launched[stages]):
            assert rank["stage"] == stage
            assert rank["layers"] == case.cfg.n_layers // stages
            assert rank["backend"] == "gloo"
            assert rank["hops"] == (case.n_micro if stage < stages - 1 else 0)
            es = torch.empty((), dtype=case.dtype).element_size()
            assert rank["hop_bytes"] == case.batch * case.seq * case.cfg.d_model * es
            # the kernel counts only launches on a card; CPU tensors take
            # the plain version
            assert rank["flash_launches"] == 0 and rank["peak_bytes"] is None
            assert ("out" in rank) == (stage == stages - 1)
            assert ("ref" in rank) == (stage == 0)


def _ref_cfg(name):
    if name == "exec":
        return RefArchConfig(**EXEC_CFG)
    return ref_smoke_config(importlib.import_module(f"repro.configs.{name}").CONFIG)


@pytest.mark.parametrize("name,dtype", [
    ("exec", "float32"), ("exec", "bfloat16"), ("rwkv6_7b", "float32"),
    ("rwkv6_7b", "bfloat16"), ("jamba_v0_1_52b", "float32"),
])
def test_reference_backbone_matches_jax_reference(name, dtype):
    rcfg = _ref_cfg(name)
    cfg = ArchConfig(**EXEC_CFG) if name == "exec" else smoke_config(load_config(name))
    rp = rlm.init_params(jax.random.PRNGKey(0), rcfg)
    if dtype == "float32":
        rp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), rp)
    tp = convert.lm_params_from(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                device="cpu")
    n_micro = 6 if name == "exec" else 2
    x = np.random.default_rng(5).standard_normal(
        (n_micro, 2, 16, cfg.d_model)).astype(np.float32)
    want = rexec.reference_backbone(rcfg, rp, jnp.asarray(x).astype(dtype))
    got = reference_backbone(cfg, tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == want.shape
    g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        assert np.abs(g - w).max() / np.abs(w).max() <= F32_TOL
    else:
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= BF16_REL_L2


def test_split_blocks_for_stages_cuts_consecutive_layers():
    cfg = ArchConfig(**EXEC_CFG)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    for stages in (1, 2, 4):
        parts = split_blocks_for_stages(params, stages)
        assert [len(p) for p in parts] == [cfg.n_layers // stages] * stages
        assert [b for p in parts for b in p] == params["blocks"]
    with pytest.raises(ValueError, match="not divisible"):
        split_blocks_for_stages(params, 3)


@pytest.mark.parametrize("name,stages", [("exec", 3), ("jamba_v0_1_52b", 4),
                                         ("rwkv6_7b", 3)])
def test_indivisible_stages_raise_as_the_reference(name, stages):
    """The repeats, not the layers, must divide: smoke Jamba's 16 layers
    are 2 repeats of 8, so 4 stages raise."""
    cfg = ArchConfig(**EXEC_CFG) if name == "exec" else smoke_config(load_config(name))
    with pytest.raises(ValueError) as want:
        rexec.pipeline_backbone(_ref_cfg(name), None, stages)
    with pytest.raises(ValueError) as got:
        pipeline_backbone(cfg, None, stages)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_nccl_with_fewer_cards_than_stages_raises(device):
    stages = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="nccl"):
        launch(backbone_job, stages, backend="nccl", device=device,
               args=([FOUR[0]],))


def _one_rank_fails(mesh):
    """Rank 1 raises; rank 0 waits for a message rank 1 never sends."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    dist.recv(torch.empty(1), 1)


def _sleeps(mesh, seconds):
    time.sleep(seconds)


def test_a_rank_that_raises_fails_the_launch_at_once():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        launch(_one_rank_fails, 2, backend="gloo", device="cpu", timeout=TIMEOUT)
    # rank 0's receive fails after rank 1 does: rank 1's traceback first
    assert str(err.value).startswith("rank 1 of 2 failed:")
    assert "rank one gives up" in str(err.value)
    assert time.perf_counter() - t0 < TIMEOUT / 2  # not by the timeout


def test_a_launch_past_its_timeout_fails():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="still running"):
        launch(_sleeps, 2, backend="gloo", device="cpu", timeout=8.0, args=(600,))
    assert time.perf_counter() - t0 < 60
