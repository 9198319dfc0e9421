"""Gradient compression: int8 quantization with error feedback (a copy of
``repro.runtime.compression`` over tensors).

Cross-pod gradient all-reduce is the collective-term floor for
multi-pod data parallelism. Per-tensor symmetric int8 quantization cuts
those bytes 4x (fp32 moments stay local; only the exchanged gradient is
compressed); the residual is carried to the next step (error feedback,
Seide et al. / EF-SGD), which keeps SGD convergence guarantees.

Tree implementation (`repro_torch.tree`): `compress` returns (int8
payload, scales), `decompress` reconstructs, `ErrorFeedbackState` holds
the residuals. The train driver applies it around the cross-pod reduce
only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import flatten, tree_map, unflatten


@dataclass
class ErrorFeedbackState:
    residual: object  # tree matching grads, fp32

    @staticmethod
    def init(grads):
        return ErrorFeedbackState(
            residual=tree_map(
                lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device),
                grads,
            )
        )


def _quantize(g):
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_gradients(grads, ef: ErrorFeedbackState | None = None):
    """-> (payload {q, scale} tree, new ErrorFeedbackState).

    With error feedback, compresses ``g + residual`` and stores the
    quantization error back into the residual.
    """
    g32 = tree_map(lambda g: g.float(), grads)
    if ef is not None:
        g32 = tree_map(torch.add, g32, ef.residual)
    flat, treedef = flatten(g32)
    qs = [_quantize(g) for g in flat]
    payload = {
        "q": unflatten(treedef, [q for q, _ in qs]),
        "scale": unflatten(treedef, [s for _, s in qs]),
    }
    recon = tree_map(_dequantize, payload["q"], payload["scale"])
    new_ef = ErrorFeedbackState(residual=tree_map(torch.subtract, g32, recon))
    return payload, new_ef


def decompress_gradients(payload):
    return tree_map(_dequantize, payload["q"], payload["scale"])


def compression_ratio(grads) -> float:
    """Bytes(fp32) / bytes(int8 + scale) for this tree."""
    leaves, _ = flatten(grads)
    n = sum(x.numel() for x in leaves)
    return (4.0 * n) / (1.0 * n + 4.0 * len(leaves))
