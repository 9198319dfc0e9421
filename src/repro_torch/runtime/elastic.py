"""Elastic scaling: re-mesh planning after node loss / expansion.

When workers die (heartbeat DEAD) or capacity arrives, the job must
resize without restarting from scratch. The plan:

1. choose the largest valid mesh from the surviving chip count —
   valid = the ``model`` axis is preserved (TP degree is baked into
   weight shapes) and ``data`` shrinks/grows to the largest divisor of
   the global batch;
2. restore the latest checkpoint re-sharded onto the new mesh (our
   checkpoints are layout-agnostic npz + treedef: restore simply
   re-shards under the new jit);
3. keep the *global* batch constant when possible (preferred: gradient
   accumulation rises on the smaller mesh) so the training trajectory
   stays comparable.

Pure planning logic — drivers execute the plan; tests verify the
invariants (never exceeds surviving chips, preserves model axis,
accumulation x data_parallel x microbatch == global batch).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ElasticPlan:
    data_parallel: int
    model_parallel: int
    grad_accumulation: int
    chips_used: int
    chips_idle: int

    @property
    def valid(self) -> bool:
        return self.data_parallel >= 1 and self.model_parallel >= 1


def plan_remesh(
    surviving_chips: int,
    *,
    model_parallel: int,
    global_batch: int,
    old_data_parallel: int,
    old_grad_accumulation: int = 1,
) -> ElasticPlan:
    """Largest data-parallel degree that (a) fits the surviving chips,
    (b) divides the global batch (so per-shard batch stays integral)."""
    if surviving_chips < model_parallel:
        return ElasticPlan(0, model_parallel, 0, 0, surviving_chips)
    max_dp = surviving_chips // model_parallel
    dp = min(max_dp, old_data_parallel)
    while dp > 1 and global_batch % dp:
        dp -= 1
    # keep global batch: effective tokens = dp * micro * accum
    old_capacity = old_data_parallel * old_grad_accumulation
    accum = max(1, -(-old_capacity // dp))
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        grad_accumulation=accum,
        chips_used=dp * model_parallel,
        chips_idle=surviving_chips - dp * model_parallel,
    )
