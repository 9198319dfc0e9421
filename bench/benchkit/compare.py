"""The numbers that decide ``correct``, each from what the program
produced and what the plain reference works out again."""
from __future__ import annotations

import statistics

import torch


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` over the whole tensor, in fp32."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """For each row, how far the served token's logit lies below the
    reference's best (0 where they pick the same token)."""
    ref_logits = ref_logits.float()
    picked = ref_logits.gather(-1, served.long().to(ref_logits.device)[:, None])[:, 0]
    return ref_logits.amax(-1) - picked


def leaf_norm_gap(got: dict, want: dict, names=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf
    and the median leaf's norm; with the leaf's name."""
    names = list(want) if names is None else list(names)
    median = statistics.median(want[n] for n in want)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], median, 1e-30)
        if gap >= worst:
            worst, at = gap, n
    return worst, at


def moving_leaves(ref_grad: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's gradient norm."""
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= share * median]
