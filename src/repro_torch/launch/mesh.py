"""Production meshes (single pod 16x16, multi-pod 2x16x16) as
``torch.distributed`` device meshes (the counterpart of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group. Each mesh is built over the default process group, which
the caller initialises with at least as many ranks as the mesh has: on
a development box without that many cards, torch's fake process group
(``torch.testing._internal.distributed.fake_pg.FakeStore`` with backend
``"fake"``) builds the meshes and their placements without devices.
"""
from __future__ import annotations

import math

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """One pod (16x16) or two pods (2x16x16).

    Axes: ``data`` carries batch DP + FSDP parameter sharding, ``model``
    carries tensor/expert parallelism, ``pod`` is cross-pod data
    parallelism (gradient all-reduce crosses the inter-pod links).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_dev_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A small (data, model) mesh over the process group's first ranks —
    for tests."""
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_sizes(mesh) -> dict[str, int]:
    """Each axis's name -> its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def n_chips(mesh) -> int:
    return math.prod(mesh.shape)
