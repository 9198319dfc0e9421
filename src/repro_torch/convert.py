"""Carry objects of the JAX package across into this package.

Each function reads the source object only through plain fields and
``numpy.asarray`` of its arrays, so it works on anything with those
fields and never imports the JAX package. It builds this package's
own objects: workloads and task sets for the exec model, design points
and segment tables for the stage split, the analysis and the cost
model, tenant contracts for admission, serve tasks and server inputs as
tensors on a chosen device, schedule-trace events, and LM parameters
(gradients too), AdamW states and decode caches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dse.space import DesignPoint
from repro_torch.core.perfmodel.exec_model import AccDesign
from repro_torch.core.perfmodel.hardware import TPUChip
from repro_torch.core.rt.task import (
    LayerDesc,
    SegmentTable,
    Task,
    TaskSet,
    Workload,
)
from repro_torch.obs.trace import TraceEvent
from repro_torch.pipeline.serve import ServeTask
from repro_torch.traffic.admission import TaskRequest

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerDesc))
_EVENT_FIELDS = tuple(f.name for f in dataclasses.fields(TraceEvent))
_CHIP_FIELDS = tuple(f.name for f in dataclasses.fields(TPUChip))


def workload_from(src) -> Workload:
    """A `Workload` with the same name and layers."""
    return Workload(
        name=src.name,
        layers=tuple(
            LayerDesc(**{f: getattr(l, f) for f in _LAYER_FIELDS})
            for l in src.layers
        ),
    )


def taskset_from(src) -> TaskSet:
    """A `TaskSet` with the same tasks, workloads, periods and deadlines."""
    return TaskSet(
        tasks=tuple(
            Task(
                workload=workload_from(t.workload),
                period=t.period,
                deadline=t.deadline,
                sporadic=t.sporadic,
                name=t.name,
            )
            for t in src.tasks
        )
    )


def design_from(src) -> DesignPoint:
    """A `DesignPoint` with the same accelerators and layer splits."""
    accs = tuple(
        AccDesign(
            chips=a.chips,
            block=tuple(a.block),
            chip=TPUChip(**{f: getattr(a.chip, f) for f in _CHIP_FIELDS}),
        )
        for a in src.accs
    )
    return DesignPoint(
        accs=accs,
        splits=tuple(tuple(int(n) for n in row) for row in src.splits),
        max_util=float(src.max_util),
    )


def table_from(src) -> SegmentTable:
    """A `SegmentTable` with the same segment lengths, stage overheads
    and layer splits."""
    return SegmentTable(
        base=[[float(b) for b in row] for row in src.base],
        overhead=[float(o) for o in src.overhead],
        layer_split=[[int(n) for n in row] for row in src.layer_split],
    )


def requests_from(srcs) -> tuple[TaskRequest, ...]:
    """`TaskRequest`s (tenant contracts) with the same fields."""
    return tuple(
        TaskRequest(
            name=r.name,
            base=tuple(float(b) for b in r.base),
            period=r.period,
            deadline=r.deadline,
            value=r.value,
            best_effort=r.best_effort,
            criticality=r.criticality,
        )
        for r in srcs
    )


def tensors_from(arrays, *, device="cuda", dtype=None) -> list[torch.Tensor]:
    """Arrays (anything ``numpy.asarray`` takes) as tensors on
    ``device``, in their own dtype unless ``dtype`` is given — the
    server's ``inputs=``."""
    return [
        torch.as_tensor(np.array(x), dtype=dtype, device=device)
        for x in arrays
    ]


def serve_task_from(src, *, device="cuda") -> ServeTask:
    """A `ServeTask` with the same fields and the same weight values as
    float32 tensors on ``device``."""
    return ServeTask(
        name=src.name,
        weights=tuple(
            tensors_from(src.weights, device=device, dtype=torch.float32)
        ),
        stage_of_layer=tuple(src.stage_of_layer),
        period=src.period,
        deadline=src.deadline,
        input_rows=src.input_rows,
    )


def events_from(src) -> list[TraceEvent]:
    """The schedule events of a recorder (anything with ``events``) or
    an event list as this package's `TraceEvent`s, field for field
    (``attrs`` copied)."""
    out = []
    for e in getattr(src, "events", src):
        fields = {f: getattr(e, f) for f in _EVENT_FIELDS}
        if fields["attrs"] is not None:
            fields["attrs"] = dict(fields["attrs"])
        out.append(TraceEvent(**fields))
    return out


def _lm_tensor(arr, device) -> torch.Tensor:
    """One array as a tensor of the same dtype. A bfloat16 array (the
    ``ml_dtypes`` type JAX hands to numpy, which torch does not take) is
    carried bit for bit through uint16."""
    a = np.asarray(arr)  # .copy() below is C-contiguous; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _unstack_layers(stacked, n_layers, device):
    """Per-pattern dicts of (n_repeats, ...) arrays -> one dict per layer
    (layer ``rep * len(pattern) + j`` is repeat ``rep`` of entry ``j``)."""
    n_pat = len(stacked)

    def take(tree, rep):
        if isinstance(tree, dict):
            return {k: take(v, rep) for k, v in tree.items()}
        return _lm_tensor(np.asarray(tree)[rep], device)

    return [take(stacked[i % n_pat], i // n_pat) for i in range(n_layers)]


def lm_params_from(params, cfg, *, device="cuda"):
    """The JAX package's LM parameters (a pytree of arrays with a leading
    repeats axis per pattern entry, as ``repro.models.lm.init_params``
    makes them) as this package's per-layer parameters on ``device``,
    same values and dtypes."""
    out = {
        k: _lm_tensor(v, device) for k, v in params.items() if k != "blocks"
    }
    out["blocks"] = _unstack_layers(params["blocks"], cfg.n_layers, device)
    return out


def adamw_state_from(state, cfg, *, device="cuda"):
    """The JAX package's AdamW state of LM parameters (``{"m", "v",
    "step"}``, ``repro.optim.adamw_init`` over ``repro.models.lm``'s
    parameters) as this package's: fp32 moments per layer like
    `lm_params_from`, and the step counter as an int32 scalar."""
    return {
        "m": lm_params_from(state["m"], cfg, device=device),
        "v": lm_params_from(state["v"], cfg, device=device),
        "step": _lm_tensor(state["step"], device),
    }


def lm_cache_from(cache, cfg, *, device="cuda"):
    """The JAX package's decode cache (per pattern entry, leading repeats
    axis) as this package's per-layer cache list on ``device``, in each
    entry's own dtype (int8 K/V codes and bf16 scales of an int8 cache
    included)."""
    return _unstack_layers(cache, cfg.n_layers, device)
