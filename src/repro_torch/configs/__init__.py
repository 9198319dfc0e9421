"""Architecture configurations of the LM serving path.

One module per configuration, each defining ``CONFIG``; `load_config`
imports one by name, as ``repro.launch.dryrun.load_config`` does.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, smoke_config

#: every configuration of the JAX package (module names); the two stub
#: frontends (internvl2_76b, musicgen_medium) take precomputed embeddings
CONFIG_NAMES = (
    "mistral_nemo_12b", "rwkv6_7b", "jamba_v0_1_52b", "dbrx_132b",
    "granite_moe_3b_a800m", "minitron_4b", "qwen1_5_32b", "stablelm_1_6b",
    "internvl2_76b", "musicgen_medium",
)


def load_config(name: str) -> ArchConfig:
    """``CONFIG`` of ``repro_torch.configs.<name>``."""
    if name not in CONFIG_NAMES:
        raise ValueError(f"unknown config {name!r}; have {CONFIG_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


__all__ = ["ArchConfig", "CONFIG_NAMES", "load_config", "smoke_config"]
