"""Assigned input-shape sets and `input_specs` (the counterpart of
``repro.launch.shapes``).

Every LM architecture is exercised on:

- ``train_4k``     seq 4,096   x global batch 256   (training)
- ``prefill_32k``  seq 32,768  x global batch 32    (inference prefill)
- ``decode_32k``   seq 32,768  x global batch 128   (decode: 1 new token
                   against a 32k KV cache / state)
- ``long_500k``    seq 524,288 x global batch 1     (long-context decode;
                   sub-quadratic archs only: jamba, rwkv6)

`input_specs`, `params_spec` and `opt_spec` return tensors on the
``meta`` device, the counterpart of JAX's ``ShapeDtypeStruct``: shapes
and dtypes, no storage, so full-size configs are described on any host.
Parameters and decode caches are held per layer, as ``repro_torch.models.lm``
holds them, so each leaf has the JAX package's shape without its
leading repeats axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import adamw_init


@dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """Shape cases this arch runs; long_500k only for sub-quadratic."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.run_long_context:
        names.append("long_500k")
    return names


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, case: ShapeCase, kv_quant: bool = False) -> dict:
    """Meta-tensor stand-ins for every model input of this case."""
    B, S = case.global_batch, case.seq_len
    if case.kind in ("train", "prefill"):
        if cfg.frontend == "none":
            batch = {"tokens": _spec((B, S), torch.int32)}
        else:
            batch = {"embeds": _spec((B, S, cfg.frontend_dim), torch.bfloat16)}
        if case.kind == "train":
            batch["labels"] = _spec((B, S), torch.int32)
            batch["mask"] = _spec((B, S), torch.float32)
        return {"batch": batch}
    # decode: one new token against an S-long cache
    if cfg.frontend == "none":
        inputs = {"tokens": _spec((B,), torch.int32)}
    else:
        inputs = {"embeds": _spec((B, cfg.frontend_dim), torch.bfloat16)}
    cache = [
        {name: _spec(shape, dtype) for name, (shape, dtype) in layer.items()}
        for layer in lm.cache_spec(cfg, B, S, kv_quant=kv_quant)
    ]
    return {"inputs": inputs, "cache": cache, "pos": _spec((B,), torch.int32)}


def params_spec(cfg: ArchConfig):
    """Meta-tensor tree of the parameters: `lm.init_params` on the meta
    device, where nothing is drawn (so no generator) and nothing is
    allocated."""
    return lm.init_params(None, cfg, device="meta")


def opt_spec(params_tree):
    """Meta-tensor tree of the AdamW state of ``params_tree``."""
    return adamw_init(params_tree)
