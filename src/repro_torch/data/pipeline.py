"""Deterministic synthetic token pipeline, host-sharded (a copy of
``repro.data.pipeline``: NumPy only, so its batches are the JAX
package's bit for bit).

Design requirements for a 1000-node deployment, all honoured here:

- **Determinism / restart**: batch ``i`` is a pure function of
  ``(seed, i)`` — a restarted job resumes from any step with identical
  data, no iterator state to checkpoint beyond the step counter.
- **Host sharding**: each host materializes only its slice of the
  global batch (``host_id / num_hosts``); the `global` array is never
  built on one host.
- **Structure, not noise**: tokens follow a per-sequence Markov chain
  (shift + mix) so the LM loss actually decreases — examples/train use
  it to show a real training curve, and tests assert learnability.
- Zero I/O: no filesystem or network dependencies; swapping in a real
  corpus only replaces `_sequence`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: structure strength: probability a token continues the chain
    #: (vs fresh uniform draw); higher -> more learnable signal
    coherence: float = 0.9


class SyntheticTokenDataset:
    """Deterministic, host-shardable synthetic LM dataset."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def _sequence(self, rng: np.random.Generator):
        """One (seq_len + 1,) token chain: affine-recurrent vocab walk."""
        cfg = self.cfg
        n = cfg.seq_len + 1
        fresh = rng.integers(0, cfg.vocab, size=n)
        cont = rng.random(n) < cfg.coherence
        toks = np.empty(n, np.int64)
        toks[0] = fresh[0]
        mult, add = 31, 7  # fixed affine walk: next = (31*t + 7) % V
        for t in range(1, n):
            toks[t] = (mult * toks[t - 1] + add) % cfg.vocab if cont[t] else fresh[t]
        return toks

    def batch(self, step: int):
        """Host-local batch for global step ``step``:
        {"tokens","labels","mask"} with shapes (local_batch, seq_len)."""
        cfg = self.cfg
        tokens = np.empty((self.local_batch, cfg.seq_len), np.int32)
        labels = np.empty((self.local_batch, cfg.seq_len), np.int32)
        for i in range(self.local_batch):
            global_row = self.host_id * self.local_batch + i
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, global_row])
            )
            chain = self._sequence(rng)
            tokens[i] = chain[:-1]
            labels[i] = chain[1:]
        return {
            "tokens": tokens,
            "labels": labels,
            "mask": np.ones_like(labels, np.float32),
        }


def make_batch_iterator(cfg: DataConfig, host_id: int = 0, num_hosts: int = 1,
                        start_step: int = 0):
    """Infinite iterator of host-local batches starting at ``start_step``."""
    ds = SyntheticTokenDataset(cfg, host_id, num_hosts)
    step = start_step
    while True:
        yield step, ds.batch(step)
        step += 1
