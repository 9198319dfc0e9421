"""Architecture configurations of the LM serving path.

One module per configuration, each defining ``CONFIG``; `load_config`
imports one by name, as ``repro.launch.dryrun.load_config`` does.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, smoke_config

#: the configurations this package serves (module names)
CONFIG_NAMES = ("mistral_nemo_12b", "rwkv6_7b", "jamba_v0_1_52b")


def load_config(name: str) -> ArchConfig:
    """``CONFIG`` of ``repro_torch.configs.<name>``."""
    if name not in CONFIG_NAMES:
        raise ValueError(f"unknown config {name!r}; have {CONFIG_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


__all__ = ["ArchConfig", "CONFIG_NAMES", "load_config", "smoke_config"]
