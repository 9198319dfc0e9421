"""Parameter utilities: initialisers and counts (the counterpart of
``repro.models.module``).

Parameters are nested dicts (and lists) of tensors. Initialisers draw
from an explicit ``torch.Generator`` whose device is where the tensor
is made; the JAX package's ``jax.random`` keys give other numbers from
the same seed, so tests carry the JAX package's parameters across with
``repro_torch.convert.lm_params_from`` instead of re-drawing them.
"""
from __future__ import annotations

import math

import torch


def _truncated_normal(gen, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn in float32."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16,
               scale: float | None = None, *, device="cuda") -> torch.Tensor:
    """(d_in, d_out) truncated normal in ±2σ with fan-in std
    ``1/sqrt(d_in)`` (or ``scale``), drawn in float32, then cast."""
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_truncated_normal(gen, (d_in, d_out), device) * std).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.bfloat16, *,
               device="cuda") -> torch.Tensor:
    """(vocab, d) truncated normal in ±2σ with std 0.02."""
    return (_truncated_normal(gen, (vocab, d), device) * 0.02).to(dtype)


def zeros(shape, dtype=torch.bfloat16, *, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.bfloat16, *, device="cuda") -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def param_count(tree) -> int:
    """Number of elements over every tensor in a nested dict/list."""
    return sum(t.numel() for t in _leaves(tree))


def param_bytes(tree) -> int:
    """Bytes over every tensor in a nested dict/list."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))
