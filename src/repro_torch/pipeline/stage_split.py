"""DSE design points -> runnable stage segments.

Bridges `core.dse` (which plans over `LayerDesc` chains) to the serving
runtime (which executes GEMM weights).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.dse.space import DesignPoint
from repro_torch.core.rt.task import TaskSet, Workload
from repro_torch.pipeline.serve import ServeTask


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def design_to_segments(
    design: DesignPoint,
    workloads: list[Workload],
    taskset: TaskSet,
    *,
    generator: torch.Generator | None = None,
    block=(128, 128, 128),
    rows: int = 128,
    dtype=torch.float32,
    period_scale: float = 1.0,
    max_dim: int | None = None,
    device="cuda",
) -> list[ServeTask]:
    """Materialize each task's layer chain as chained GEMM weights with
    the design's stage map (block-aligned so the preemptible kernel's
    window grid is exact).

    The chain contract: layer j's K equals layer j-1's N (activations
    flow through). Layer shapes are block-rounded; the *stage map* and
    period come straight from the design point. ``period_scale``
    rescales the analytic periods to the serving timebase — the
    schedule structure (ratios, utilization) is preserved, only the
    unit changes.

    ``max_dim`` caps each layer's K/N at a block-multiple — surrogate
    weights for cost-model-driven virtual serving, where timing comes
    from the model and the executed GEMM only has to preserve the
    window/stage structure. Leave ``None`` whenever the computed
    *values* matter.

    Weights are standard normals scaled by ``1/sqrt(K)``, drawn on the
    CPU from ``generator`` (default: seed 0) and moved to ``device``, so
    the same seed gives the same weights on every device.
    """
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    bm, bk, bn = block
    cap = None if max_dim is None else _round_up(max_dim, max(bk, bn))
    out = []
    for i, (w, t) in enumerate(zip(workloads, taskset.tasks)):
        stage_of_layer = []
        for k in range(design.n_stages):
            stage_of_layer += [k] * design.splits[k][i]
        dims = []  # chained (K, N) per layer
        prev_n = _round_up(w.layers[0].K, bk)
        if cap is not None:
            prev_n = min(prev_n, cap)
        for l in w.layers:
            n = _round_up(l.N, bn)
            if cap is not None:
                n = min(n, cap)
            dims.append((prev_n, n))
            prev_n = n
        weights = []
        for (kd, nd) in dims:
            wt = torch.randn((kd, nd), generator=gen) / math.sqrt(kd)
            weights.append(wt.to(device=device, dtype=dtype))
        out.append(
            ServeTask(
                name=t.name,
                weights=tuple(weights),
                stage_of_layer=tuple(stage_of_layer),
                period=t.period * period_scale,
                input_rows=_round_up(rows, bm),
            )
        )
    return out
