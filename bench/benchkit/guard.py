"""The check that a run has loaded neither JAX nor the JAX package.

Names are compared whole by their top-level part (before the first
dot): the port's package, ``repro_torch``, begins with the JAX
package's name, ``repro``, and must pass."""
from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def banned_modules(names=None) -> list[str]:
    """The banned top-level names among ``names`` (default: every module
    this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & BANNED)
