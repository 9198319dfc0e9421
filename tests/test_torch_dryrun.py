"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's, on the CPU.

Two subprocesses side by side (the dry run initialises torch's fake
process group of 256 ranks) trace:

- every config x every shape at smoke size (Jamba at one repeat of its
  pattern: 8 layers, attention, mamba and MoE) through `run_cell` on the
  16x16 production mesh: `lowerable` and the policy take all ten
  configs and every applicable shape (a train step, a prefill, a
  decode, the ``long_500k`` sequence-sharded decode), every record OK
  with positive FLOPs and finite roofline terms; inapplicable shapes
  SKIP;
- one production cell at full size, StableLM-1.6B x decode_32k: its
  argument bytes equal the sum of the local shards (rank 0's) of the
  reference's parameter, cache and input specs at the reference's
  shardings; and StableLM-1.6B x train_4k's arguments (parameters,
  AdamW state, batch) laid out as `run_cell` lays them, against the
  reference's the same way;
- the ``long_500k`` SKIP record of a full-attention config, which equals
  the reference's.

``--all``'s cell list equals the reference's. Every comparison is exact:
bytes, names and integers.
"""
import importlib
import json
import math
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.launch import shapes as rshapes
from repro.launch import sharding as rsharding
from repro_torch.configs import CONFIG_NAMES
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: smoke-size shapes of each kind (the batch a multiple of the data axis)
SMOKE_CASES = {"train_4k": (64, 32, "train"), "prefill_32k": (64, 32, "prefill"),
               "decode_32k": (64, 32, "decode"), "long_500k": (128, 1, "decode")}

_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import CONFIG_NAMES, load_config, smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, ShapeCase
    from repro_torch.launch.steps import lowerable

    torch.set_num_threads(1)
    smoke, part = json.loads(sys.argv[1]), int(sys.argv[2])
    out = {"smoke": {}}
    for name in CONFIG_NAMES[part::2]:
        cfg = smoke_config(load_config(name))
        if name == "jamba_v0_1_52b":  # one repeat of its 8-layer pattern
            cfg = dataclasses.replace(cfg, n_layers=8)
        for shape, (S, B, kind) in smoke.items():
            rec = dryrun.run_cell(name, shape, False, cfg=cfg,
                                  case=ShapeCase(shape, S, B, kind))
            out["smoke"][f"{name}/{shape}"] = rec
    if part == 0:
        print(json.dumps(out))
        sys.exit(0)
    out["decode"] = dryrun.run_cell("stablelm_1_6b", "decode_32k", False)
    out["skip"] = dryrun.run_cell("stablelm_1_6b", "long_500k", False)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        fn, specs = lowerable(load_config("stablelm_1_6b"), SHAPES["train_4k"], mesh)
        with FakeTensorMode():
            args = [dryrun.fake_dtensors(mesh, sp, sh)
                    for sp, sh in zip(specs, fn.in_shardings)]
            out["train_arg_bytes"] = [dryrun.local_bytes(a) for a in args]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def traced():
    """The script's two halves (every other config each; the second also
    the production cells), run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, json.dumps(SMOKE_CASES), str(part)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for part in (0, 1)]
    out = {"smoke": {}}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, stderr[-4000:]
        half = json.loads(stdout.strip().splitlines()[-1])
        out["smoke"].update(half.pop("smoke"))
        out.update(half)
    return out


def _ref_module():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    placeholder devices; JAX is initialised first so that the flag
    changes nothing here, and the variable is restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


#: what the reference's spec functions read of the 16x16 mesh
STAND_IN = SimpleNamespace(shape={"data": 16, "model": 16},
                           axis_names=("data", "model"))


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _ref_local_bytes(tree, specs):
    """Rank 0's local bytes of a reference tree of ShapeDtypeStructs at
    its PartitionSpecs: each dim split as ``ceil(n / shards)`` over the
    product of the axes its spec names, as both JAX and DTensor give the
    first shard."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(specs, is_leaf=_is_spec)
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        local = []
        for n, axes in zip(leaf.shape, spec):
            axes = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
            local.append(-(-n // math.prod(STAND_IN.shape[a] for a in axes)))
        total += math.prod(local) * np.dtype(leaf.dtype).itemsize
    return total


def _param_specs(p_spec):
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: rsharding.param_spec(path, leaf, 16), p_spec)


def _batch_specs(batch):
    return jax.tree_util.tree_map(
        lambda leaf: PartitionSpec(("data",), *([None] * (leaf.ndim - 1))), batch)


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("shape", list(SMOKE_CASES))
def test_every_config_and_shape_traces(traced, name, shape):
    rec = traced["smoke"][f"{name}/{shape}"]
    cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    if shape == "long_500k" and not cfg.run_long_context:
        assert rec["status"] == "SKIP"
        return
    assert rec["status"] == "OK", rec
    assert rec["flops"] > 0 and rec["chips"] == 256
    assert rec["memory"]["argument_size_bytes"] > 0
    assert all(math.isfinite(rec["roofline"][k])
               for k in ("compute_s", "memory_s", "collective_s"))
    coll = rec["collective_bytes"]
    assert coll["total"] == sum(coll[k] for k in dryrun.R.COLLECTIVES)


def test_production_decode_cell_argument_bytes_equal_reference(traced):
    rec = traced["decode"]
    assert rec["status"] == "OK" and rec["mesh"] == "16x16"
    rcfg, case = _ref_config("stablelm_1_6b"), rshapes.SHAPES["decode_32k"]
    p_spec = rshapes.params_spec(rcfg)
    specs = rshapes.input_specs(rcfg, case)
    cache_specs = jax.tree_util.tree_map_with_path(
        lambda path, leaf: rsharding._cache_leaf_spec(
            STAND_IN, path[-1].key, leaf, seq_sharded=False), specs["cache"])
    want = (_ref_local_bytes(p_spec, _param_specs(p_spec))
            + _ref_local_bytes(specs["cache"], cache_specs)
            + _ref_local_bytes(specs["inputs"], _batch_specs(specs["inputs"]))
            + _ref_local_bytes(specs["pos"], PartitionSpec(("data",))))
    assert rec["memory"]["argument_size_bytes"] == want
    assert rec["flops"] > 0 and rec["collective_bytes"]["count"] > 0
    assert rec["analytic"]["model_flops"] == (
        2.0 * rcfg.param_counts()["active"] * case.global_batch)


def test_production_train_argument_bytes_equal_reference(traced):
    rcfg, case = _ref_config("stablelm_1_6b"), rshapes.SHAPES["train_4k"]
    p_spec = rshapes.params_spec(rcfg)
    o_spec = rshapes.opt_spec(p_spec)
    batch = rshapes.input_specs(rcfg, case)["batch"]
    o_specs = {"m": _param_specs(p_spec), "v": _param_specs(p_spec),
               "step": PartitionSpec()}
    want = [_ref_local_bytes(p_spec, _param_specs(p_spec)),
            _ref_local_bytes(o_spec, o_specs),
            _ref_local_bytes(batch, _batch_specs(batch))]
    assert traced["train_arg_bytes"] == want


def test_long_context_skip_record_equals_reference(traced):
    got = traced["skip"]
    want = _ref_module().run_cell("stablelm_1_6b", "long_500k", False)
    assert got == want
    assert dryrun.skip_record(
        importlib.import_module("repro_torch.configs.stablelm_1_6b").CONFIG,
        "long_500k", False) == want


def test_all_cells_equal_reference():
    ref = _ref_module()
    assert dryrun.ARCH_MODULES == ref.ARCH_MODULES
    want = [(a, s) for a in ref.ARCH_MODULES
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    assert dryrun.cells() == want and len(want) == 40
    assert set(dryrun.SHAPE_NAMES) == set(SHAPES)


def test_result_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = dryrun.result_path("stablelm_1_6b", "train_4k", True)
    assert path == os.path.join("experiments", "dryrun_torch",
                                "stablelm_1_6b__train_4k__2x16x16.json")
    assert os.path.isdir(os.path.join(tmp_path, "experiments", "dryrun_torch"))
