"""Operations and bytes, counted from shapes (frozen here so that a
change to the program cannot move the yardstick).

Causal attention keeps the S (S + 1) / 2 (query, key <= query) pairs;
each costs 4 * hd operations forward (q kᵀ and p v) and 10 * hd backward
(s, dP, dV, dQ and dK). A kernel's bytes are its inputs read once and its
outputs written once. Model operations count the weights that take part
in products (every projection and the output head, not the embedding
table or the norms) at 2 operations a weight and token forward, 6 with
the backward; recomputation under activation checkpointing is not
counted."""
from __future__ import annotations

from benchkit import peaks
from benchkit.model import Sizes


def attention_pairs(S: int) -> float:
    return S * (S + 1) / 2


def flash_fwd_flops(B, S, H, hd) -> float:
    return 4.0 * hd * B * H * attention_pairs(S)


def flash_fwd_bytes(B, S, H, Hkv, hd, es=2) -> float:
    """q and o (H heads), k and v (Hkv heads), once each."""
    return 2.0 * B * S * (H + Hkv) * hd * es


def flash_bwd_flops(B, S, H, hd) -> float:
    return 2.5 * flash_fwd_flops(B, S, H, hd)


def flash_bwd_bytes(B, S, H, Hkv, hd, es=2) -> float:
    """q, o, dO, dq (H heads) and k, v, dk, dv (Hkv heads), once each."""
    return 4.0 * B * S * (H + Hkv) * hd * es


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time at the bf16 tensor-core peak and the HBM peak."""
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def body_weights(s: Sizes) -> int:
    """Weights of the layers' products: q, k, v, o and the SwiGLU MLP."""
    attn = s.d * s.q_width + 2 * s.d * s.kv_width + s.q_width * s.d
    return s.layers * (attn + 3 * s.d * s.d_ff)


def head_weights(s: Sizes) -> int:
    return s.d * s.vocab


def train_step_flops(s: Sizes, B: int, S: int) -> float:
    """6 N per token (N: body and head) plus forward and backward
    attention (3x the forward's) in every layer."""
    n = body_weights(s) + head_weights(s)
    return 6.0 * n * B * S + s.layers * 3.0 * flash_fwd_flops(B, S, s.heads,
                                                              s.head_dim)


def prefill_flops(s: Sizes, B: int, S: int) -> float:
    """2 N_body per token, the forward attention of every layer, and the
    head for each row's last token."""
    return (2.0 * body_weights(s) * B * S
            + s.layers * flash_fwd_flops(B, S, s.heads, s.head_dim)
            + 2.0 * head_weights(s) * B)
