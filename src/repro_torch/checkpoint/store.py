"""Sharded npz checkpoints with atomic commit and auto-resume (a copy of
``repro.checkpoint.store`` over tensors).

Layout (one directory per step), the JAX package's own::

    <root>/step_000123/
        shard_00000_of_00004.npz   # this host's param/opt leaves
        meta.json                  # leaf paths, dtypes, shapes
        COMMITTED                  # written last -> atomic visibility

Either package restores what the other wrote: leaves are stored in JAX's
order under JAX's path strings (`repro_torch.tree`), with numpy's dtype
names, and bf16 as its raw uint16 bits.

Fault-tolerance contract (runtime/ft.py builds on this):

- `save_checkpoint` writes into ``step_xxx.tmp_<host>`` and renames after
  the COMMITTED marker is inside — a crash mid-save never corrupts the
  latest checkpoint, and `latest_step` only ever sees committed dirs.
- every host writes only its own shard file (host-sharded state);
  restore reads the shard(s) it owns. On a single host there is exactly
  one shard.
- `CheckpointManager.keep` bounds disk usage (old steps pruned after a
  successful commit).

Tensors are copied to the host before writing. Restore puts each leaf on
the device and in the dtype of the matching leaf of ``like``; bf16 comes
back through torch's own view of the stored bits, so no numpy bf16 type
is needed.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

_COMMITTED = "COMMITTED"


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host array; a bf16 tensor as its uint16 bits."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(x) -> str:
    """numpy's name of a leaf's dtype ("bfloat16" for bf16)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def save_checkpoint(
    root: str,
    step: int,
    state,
    host_id: int = 0,
    num_hosts: int = 1,
) -> str:
    """Atomically write ``state`` (any tree of tensors) for ``step``."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + f".tmp_{host_id}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    paths, leaves, _ = flatten_with_paths(state)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        dtypes.append(_dtype_name(x))
        arrays[f"leaf_{i}"] = _to_numpy(x)
    shard_name = f"shard_{host_id:05d}_of_{num_hosts:05d}.npz"
    np.savez(os.path.join(tmp, shard_name), **arrays)
    meta = {
        "step": step,
        "num_hosts": num_hosts,
        "paths": paths,
        "dtypes": dtypes,
        "shapes": [list(x.shape) for x in arrays.values()],
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _COMMITTED), "w") as f:
        f.write("ok\n")
    # atomic publish: rename tmp -> final (POSIX rename is atomic)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(root: str) -> int | None:
    """Largest committed step under ``root`` (None if no checkpoint)."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        if not name.startswith("step_") or name.endswith((".tmp", ".trash")):
            continue
        path = os.path.join(root, name)
        if not os.path.exists(os.path.join(path, _COMMITTED)):
            continue
        try:
            s = int(name.split("_")[1].split(".")[0])
        except ValueError:
            continue
        best = s if best is None else max(best, s)
    return best


def _from_numpy(a: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    """A stored array as a tensor shaped and placed as ``like``, in
    ``like``'s dtype; bf16 bits are viewed as bf16 first."""
    a = np.array(a, order="C")  # 0-d stays 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t.to(torch.as_tensor(like).dtype)


def restore_checkpoint(root: str, step: int, like, host_id: int = 0):
    """Restore the tree saved at ``step``; ``like`` provides the structure,
    and each leaf's dtype and device.

    Leaf order is matched by path string, so adding/removing state
    fields fails loudly instead of silently mis-assigning arrays.
    """
    path = os.path.join(root, f"step_{step:09d}")
    if not os.path.exists(os.path.join(path, _COMMITTED)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    shard = [n for n in os.listdir(path) if n.startswith(f"shard_{host_id:05d}_")]
    if not shard:
        raise FileNotFoundError(f"host {host_id} shard missing in {path}")
    with np.load(os.path.join(path, shard[0])) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(meta["dtypes"]))]

    like_paths, like_leaves, treedef = flatten_with_paths(like)
    if like_paths != meta["paths"]:
        raise ValueError(
            "checkpoint structure mismatch:\n"
            f"  saved:    {meta['paths'][:5]}...\n"
            f"  expected: {like_paths[:5]}..."
        )
    restored = [
        _from_numpy(a, dt, l)
        for a, dt, l in zip(arrays, meta["dtypes"], like_leaves)
    ]
    return unflatten(treedef, restored)


class CheckpointManager:
    """Periodic save + auto-resume + retention, used by launch/train.py."""

    def __init__(
        self,
        root: str,
        every: int = 100,
        keep: int = 3,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        self.root = root
        self.every = max(1, every)
        self.keep = max(1, keep)
        self.host_id = host_id
        self.num_hosts = num_hosts

    def maybe_save(self, step: int, state) -> str | None:
        if step % self.every:
            return None
        out = save_checkpoint(
            self.root, step, state, self.host_id, self.num_hosts
        )
        self._prune()
        return out

    def restore_latest(self, like):
        """(step, state) of the newest committed checkpoint, or (0, like)."""
        s = latest_step(self.root)
        if s is None:
            return 0, like
        return s, restore_checkpoint(self.root, s, like, self.host_id)

    def _prune(self) -> None:
        steps = sorted(
            s
            for s in (
                latest_step_of(name)
                for name in os.listdir(self.root)
                if name.startswith("step_") and not name.endswith(".tmp")
            )
            if s is not None
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True
            )


def latest_step_of(name: str) -> int | None:
    try:
        return int(name.split("_")[1].split(".")[0])
    except (IndexError, ValueError):
        return None
