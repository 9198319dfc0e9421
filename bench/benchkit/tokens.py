"""Training batches: a frozen copy of ``repro_torch.data.pipeline``'s
synthetic token chains, the same numbers bit for bit, every position of
every row computed at once.

Row ``i`` of batch ``step`` draws from ``SeedSequence([seed, step, i])``
``seq_len + 1`` fresh tokens and as many continue-or-restart flags; a
continued token is ``(31 * previous + 7) % vocab``. Tokens are the
chain's first ``seq_len``, labels its last ``seq_len``."""
from __future__ import annotations

import functools

import numpy as np

MULT, ADD = 31, 7


def seed_u63(seed: int) -> int:
    """``seed`` as a non-negative integer (any whole number is taken)."""
    return seed & ((1 << 63) - 1)


@functools.cache
def _affine_powers(vocab: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """For k < n: the k-th iterate of ``t -> (31 t + 7) % vocab`` is
    ``(A[k] t + C[k]) % vocab``."""
    A, C = np.empty(n, np.int64), np.empty(n, np.int64)
    a, c = 1, 0
    for k in range(n):
        A[k], C[k] = a, c
        a, c = (MULT * a) % vocab, (MULT * c + ADD) % vocab
    return A, C


def batch(vocab: int, seq_len: int, rows: int, seed: int, step: int,
          coherence: float = 0.9) -> dict[str, np.ndarray]:
    """{"tokens", "labels"} (rows, seq_len) int32. The chain restarts at
    each fresh token; a continued token is the restart's value taken
    through the affine walk as many times as it lies past the restart,
    which is the loop's result, computed for every position at once."""
    n = seq_len + 1
    fresh = np.empty((rows, n), np.int64)
    cont = np.empty((rows, n), bool)
    for i in range(rows):
        rng = np.random.default_rng(np.random.SeedSequence([seed_u63(seed), step, i]))
        fresh[i] = rng.integers(0, vocab, size=n)
        cont[i] = rng.random(n) < coherence
    cont[:, 0] = False
    pos = np.arange(n)
    start = np.maximum.accumulate(np.where(cont, 0, pos), axis=1)
    A, C = _affine_powers(vocab, n)
    k = pos - start
    toks = (A[k] * np.take_along_axis(fresh, start, axis=1) + C[k]) % vocab
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
