"""AdamW + global-norm clipping + cosine schedule (a copy of
``repro.optim.adamw`` over tensors).

Moments are fp32 regardless of parameter dtype (bf16 master-less
training: params stay bf16, the fp32 first/second moments carry the
precision — 2 + 4 + 4 bytes/param for (param, m, v)).

All functions take any nested dict / list / tuple of tensors
(`repro_torch.tree`), and the step counter and schedule stay tensors on
the parameters' device, so a step reads nothing back to the host.

Weight decay goes to the leaves the JAX package decays: ``p.ndim >= 2``
of its parameter tree. A model whose tree holds its leaves with other
shapes than the JAX package's passes ``decay``, a tree of bools
(`repro_torch.models.lm.decay_mask`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import flatten, tree_map, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to lr_min; an fp32 scalar tensor
    (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1.0 + torch.cos(math.pi * prog)
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    leaves, _ = flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to at most ``max_norm`` in global norm, the norm). Each
    leaf is scaled in fp32 and rounded back to its own dtype: bf16 for a
    bf16 gradient, fp32 after accumulation."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw_init(params):
    """State: fp32 (m, v) mirroring the param tree + scalar step."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=flatten(params)[0][0].device),
    }


def _is_matrix(p) -> bool:
    return p.ndim >= 2  # decay weights, not biases/norms/scalars


def adamw_update(params, grads, state, cfg: AdamWConfig, *, decay=None):
    """One AdamW step. Returns (new_params, new_state, metrics).

    ``decay``: a tree of bools like ``params`` naming the leaves that get
    weight decay; by default those with ``ndim >= 2``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v, wd):
        g32 = g.float()
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if wd:
            delta = delta + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    flat_p, treedef = flatten(params)
    flat_g, flat_m, flat_v = (flatten(t)[0] for t in (grads, state["m"], state["v"]))
    flat_d = ([_is_matrix(p) for p in flat_p] if decay is None
              else flatten(decay)[0])
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v) == len(flat_d)):
        raise ValueError("params, grads, moments and decay differ in structure")
    out = [upd(*xs) for xs in zip(flat_p, flat_g, flat_m, flat_v, flat_d)]
    new_p = unflatten(treedef, [o[0] for o in out])
    new_m = unflatten(treedef, [o[1] for o in out])
    new_v = unflatten(treedef, [o[2] for o in out])
    state = {"m": new_m, "v": new_v, "step": step}
    return new_p, state, {"grad_norm": gnorm, "lr": lr}
