"""AdamW + global-norm clipping + cosine schedule (a copy of
``repro.optim.adamw`` over tensors).

Moments are fp32 regardless of parameter dtype (bf16 master-less
training: params stay bf16, the fp32 first/second moments carry the
precision — 2 + 4 + 4 bytes/param for (param, m, v)).

All functions take any nested dict / list / tuple of tensors
(`repro_torch.tree`), and the step counter and schedule stay tensors on
the parameters' device, so a step reads nothing back to the host.

`adamw_update` takes one of two routes, by what its trees hold: plain
tensors with any leaf on a card go to the multi-tensor kernel
(`repro_torch.kernels.adamw.adamw_fused_call`: two launches for the
whole tree, the same arithmetic, which refuses a tree it does not take);
CPU trees, and trees with any DTensor leaf (whose norm needs a
cross-rank reduction), take the per-leaf code below, the kernel's plain
version (`adamw_per_leaf`).

Weight decay goes to the leaves the JAX package decays: ``p.ndim >= 2``
of its parameter tree. A model whose tree holds its leaves with other
shapes than the JAX package's passes ``decay``, a tree of bools
(`repro_torch.models.lm.decay_mask`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.adamw import adamw_fused_call
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


def step_scalars(cfg: AdamWConfig, step):
    """(lr, bc1, bc2) at ``step`` (an int32 tensor, counted from 1):
    fp32 tensors on its device."""
    lr = cosine_schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    return lr, bc1, bc2


def adamw_per_leaf(params, grads, ms, vs, decay, *, lr, bc1, bc2, b1: float,
                   b2: float, eps: float, weight_decay: float, clip_norm: float):
    """The per-leaf code over lists of leaves, `adamw_fused_call`'s plain
    version with its arguments and results: (new params, new m, new v,
    the gradients' global norm). Leaves on a card add to
    ``adamw_per_leaf.card_leaves``."""
    grads, gnorm = clip_by_global_norm(grads, clip_norm)

    def upd(p, g, m, v, wd):
        g32 = g.float()
        m_new = b1 * m + (1.0 - b1) * g32
        v_new = b2 * v + (1.0 - b2) * torch.square(g32)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if wd:
            delta = delta + weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    out = [upd(*xs) for xs in zip(params, grads, ms, vs, decay)]
    adamw_per_leaf.card_leaves += sum(p.device.type == "cuda" for p in params)
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out], gnorm


#: leaves the per-leaf code updated on a card since the count was last
#: set to 0 (a DTensor tree, or a direct call)
adamw_per_leaf.card_leaves = 0


def _takes_kernel(leaves) -> bool:
    """A tree of plain tensors with a leaf on a card goes to the kernel."""
    on_card = False
    for x in leaves:
        if isinstance(x, DTensor):
            return False
        on_card = on_card or x.is_cuda
    return on_card


def adamw_update(params, grads, state, cfg: AdamWConfig, *, decay=None):
    """One AdamW step. Returns (new_params, new_state, metrics).

    ``decay``: a tree of bools like ``params`` naming the leaves that get
    weight decay; by default those with ``ndim >= 2``. A tree of plain
    tensors with a leaf on a card goes to `adamw_fused_call`, any other
    to `adamw_per_leaf`."""
    flat_p, treedef = flatten(params)
    flat_g, flat_m, flat_v = (flatten(t)[0] for t in (grads, state["m"], state["v"]))
    flat_d = ([_is_matrix(p) for p in flat_p] if decay is None
              else flatten(decay)[0])
    if not (len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v) == len(flat_d)):
        raise ValueError("params, grads, moments and decay differ in structure")
    update = (adamw_fused_call if _takes_kernel(flat_p + flat_g + flat_m + flat_v)
              else adamw_per_leaf)
    step = state["step"] + 1
    lr, bc1, bc2 = step_scalars(cfg, step)
    new_p, new_m, new_v, gnorm = update(
        flat_p, flat_g, flat_m, flat_v, flat_d, lr=lr, bc1=bc1, bc2=bc2, b1=cfg.b1,
        b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
    state = {"m": unflatten(treedef, new_m), "v": unflatten(treedef, new_v),
             "step": step}
    return unflatten(treedef, new_p), state, {"grad_norm": gnorm, "lr": lr}
