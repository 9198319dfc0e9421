"""The port's launch vocabulary (`repro_torch.launch` `mesh`, `shapes`,
`sharding` and `steps.auto_micro_batches`) against the JAX package's, on
the CPU, allocating nothing.

- `input_specs`, `params_spec` and `opt_spec` are meta tensors; their
  shapes and dtypes equal the reference's ``ShapeDtypeStruct``s for all
  ten full-size configs, a per-layer leaf equal to the reference's
  stacked leaf without its leading repeats axis.
- The sharding rules equal the reference's ``PartitionSpec``s leaf for
  leaf, the same way without the repeats entry, and their placements on
  the production meshes shard what the specs name.
- The production meshes are ``DeviceMesh``es under torch's fake process
  group (no devices); the reference's functions read only a mesh's
  ``shape`` and ``axis_names``, so they get a stand-in with those (JAX
  here has one CPU device).

Every comparison is exact: these are shapes, names and integers.
"""
import functools
import importlib
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import shapes as rshapes
from repro.launch import sharding as rsharding
from repro.launch import steps as rsteps
from repro_torch.configs import CONFIG_NAMES, load_config
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (
    axis_sizes,
    batch_axes,
    make_dev_mesh,
    make_production_mesh,
    n_chips,
)
from repro_torch.launch.shapes import (
    SHAPES,
    applicable_shapes,
    input_specs,
    opt_spec,
    params_spec,
)
from repro_torch.launch.steps import _STASH_BUDGET_BYTES, auto_micro_batches
from repro_torch.tree import flatten_with_paths

torch.set_num_threads(1)

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


def _stand_in(multi_pod):
    """What the reference's mesh functions read of a production mesh."""
    shape, names = MESHES[multi_pod]
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names)


@pytest.fixture(scope="module")
def meshes():
    """Both production meshes (and a 2x2 dev mesh) under the fake process
    group, which is torn down after the module."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {
            False: make_production_mesh(device="cpu"),
            True: make_production_mesh(multi_pod=True, device="cpu"),
            "dev": make_dev_mesh(2, 2, device="cpu"),
        }
    finally:
        dist.destroy_process_group()


def _keys(path):
    """A `repro_torch.tree` path as dict keys and list indices."""
    out = []
    for part in path.split("/"):
        out.append(part[2:-2] if part.startswith("['") else int(part[1:-1]))
    return tuple(out)


def _ref_leaves(tree):
    """{keys: (jax path, leaf)} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[keys] = (path, leaf)
    return out


def _paired(port_tree, ref_tree, n_pat, top=("blocks",)):
    """(port path, port leaf, ref path, ref leaf, stacked) for every port
    leaf: layer i of a per-layer list under a key in ``top`` is entry
    ``i % n_pat`` of the reference's stack. Every reference leaf is met."""
    ref = _ref_leaves(ref_tree)
    met, out = set(), []
    paths, leaves, _ = flatten_with_paths(port_tree)
    for path, leaf in zip(paths, leaves):
        keys = _keys(path)
        stacked = any(k in top for k in keys[:1])
        if stacked:
            keys = (keys[0], keys[1] % n_pat) + keys[2:]
        met.add(keys)
        out.append((path, leaf, *ref[keys], stacked))
    assert met == set(ref)
    return out


def _axes(spec):
    """A spec with each one-axis tuple written as the axis alone, as
    ``PartitionSpec`` writes it: the same sharding."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in spec)


def _dtype(x):
    return str(x.dtype).removeprefix("torch.")


@functools.cache
def _ref_params(name):
    return rshapes.params_spec(_ref_config(name))


@functools.cache
def _port_params(name):
    return params_spec(load_config(name))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_shape_cases_equal_reference(name):
    assert SHAPES == {k: type(SHAPES[k])(**vars(v)) for k, v in rshapes.SHAPES.items()}
    assert applicable_shapes(load_config(name)) == rshapes.applicable_shapes(
        _ref_config(name))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_params_spec_leaves_equal_reference_without_repeats(name):
    cfg = load_config(name)
    port = _port_params(name)
    rows = _paired(port, _ref_params(name), len(cfg.pattern()))
    assert len(port["blocks"]) == cfg.n_layers
    for path, leaf, _, ref, stacked in rows:
        assert leaf.device.type == "meta", path
        want = tuple(ref.shape[1:] if stacked else ref.shape)
        assert tuple(leaf.shape) == want, path
        assert _dtype(leaf) == _dtype(ref), path


@pytest.mark.parametrize("name", ("stablelm_1_6b", "jamba_v0_1_52b", "dbrx_132b"))
def test_opt_spec_mirrors_params_on_meta(name):
    cfg = load_config(name)
    ref = jax.eval_shape(lambda p: rshapes.opt_spec(p), _ref_params(name))
    port = opt_spec(_port_params(name))
    for key in ("m", "v"):
        for path, leaf, _, want, stacked in _paired(port[key], ref[key],
                                                     len(cfg.pattern())):
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want.shape[1:] if stacked else want.shape)
            assert _dtype(leaf) == _dtype(want) == "float32", path
    assert port["step"].device.type == "meta" and port["step"].shape == ()


def _cases():
    return [(n, s) for n in CONFIG_NAMES for s in applicable_shapes(load_config(n))]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("name,shape", _cases())
def test_input_specs_equal_reference(name, shape, kv_quant):
    cfg = load_config(name)
    port = input_specs(cfg, SHAPES[shape], kv_quant=kv_quant)
    ref = rshapes.input_specs(_ref_config(name), rshapes.SHAPES[shape],
                              kv_quant=kv_quant)
    assert sorted(port) == sorted(ref)
    rows = _paired(port, ref, len(cfg.pattern()), top=("cache",))
    if "cache" in port:
        assert len(port["cache"]) == cfg.n_layers
    for path, leaf, _, want, stacked in rows:
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(want.shape[1:] if stacked else want.shape), path
        assert _dtype(leaf) == _dtype(want), path


@pytest.mark.parametrize("model_size", [16, None])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_param_spec_equals_reference_without_repeats(name, model_size):
    cfg = load_config(name)
    rows = _paired(_port_params(name), _ref_params(name), len(cfg.pattern()))
    for path, leaf, rpath, ref, stacked in rows:
        want = tuple(rsharding.param_spec(rpath, ref, model_size))
        assert _axes(sharding.param_spec(path, leaf, model_size)) == (
            want[1:] if stacked else want), path


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_cache_specs_equal_reference(meshes, name, seq_sharded, multi_pod):
    cfg, mesh = load_config(name), meshes[multi_pod]
    for kv_quant in (False, True):
        port = input_specs(cfg, SHAPES["decode_32k"], kv_quant=kv_quant)["cache"]
        ref = rshapes.input_specs(_ref_config(name), rshapes.SHAPES["decode_32k"],
                                  kv_quant=kv_quant)["cache"]
        got = sharding.cache_shardings(mesh, port, seq_sharded=seq_sharded)
        for i, layer in enumerate(port):
            for key, leaf in layer.items():
                want = tuple(rsharding._cache_leaf_spec(
                    _stand_in(multi_pod), key, ref[i % len(ref)][key],
                    seq_sharded=seq_sharded))
                spec = sharding._cache_leaf_spec(mesh, key, leaf,
                                                 seq_sharded=seq_sharded)
                assert _axes(spec) == want[1:], (i, key)
                assert got[i][key] == sharding.placements(mesh, spec)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_names_shape_and_size(meshes, multi_pod):
    mesh = meshes[multi_pod]
    shape, names = MESHES[multi_pod]
    assert mesh.mesh_dim_names == names and tuple(mesh.shape) == shape
    assert n_chips(mesh) == (512 if multi_pod else 256)
    assert axis_sizes(mesh) == _stand_in(multi_pod).shape
    assert batch_axes(mesh) == (("pod", "data") if multi_pod else ("data",))
    assert batch_axes(mesh) == rsharding.batch_axes(_stand_in(multi_pod))
    dev = meshes["dev"]
    assert dev.mesh_dim_names == ("data", "model") and tuple(dev.shape) == (2, 2)
    assert n_chips(dev) == 4 and batch_axes(dev) == ("data",)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_shard_what_the_specs_name(meshes, multi_pod):
    mesh = meshes[multi_pod]
    pod = (Replicate(),) if multi_pod else ()
    params = _port_params("mistral_nemo_12b")
    got = sharding.shardings_for_tree(mesh, params)
    wq = got["blocks"][0]["mixer"]["wq"]  # (d, H*hd): data x model
    assert wq == pod + (Shard(0), Shard(1))
    assert got["blocks"][5]["mixer"]["wo"] == pod + (Shard(1), Shard(0))
    assert got["embed"] == pod + (Replicate(), Shard(1))
    assert got["final_norm"] == sharding.replicated(mesh) == (Replicate(),) * mesh.ndim
    opt = sharding.opt_state_shardings(mesh, got)
    assert opt["m"] is got and opt["v"] is got
    assert opt["step"] == sharding.replicated(mesh)
    batch = input_specs(load_config("mistral_nemo_12b"), SHAPES["train_4k"])["batch"]
    placed = sharding.batch_shardings(mesh, batch)
    want = ((Shard(0), Shard(0)) if multi_pod else (Shard(0),)) + (Replicate(),)
    assert placed == {"tokens": want, "labels": want, "mask": want}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name,shape", _cases())
def test_auto_micro_batches_equals_reference(meshes, name, shape, multi_pod):
    assert _STASH_BUDGET_BYTES == rsteps._STASH_BUDGET_BYTES
    got = auto_micro_batches(load_config(name), SHAPES[shape], meshes[multi_pod])
    want = rsteps.auto_micro_batches(_ref_config(name), rshapes.SHAPES[shape],
                                     _stand_in(multi_pod))
    assert got == want
