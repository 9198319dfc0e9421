"""A configuration file's sizes, read once for both sides.

A file under ``configs/`` holds the published ``config.json`` keys of a
model as it is run, plus ``reference`` (the family module under
``reference/``), ``source``, ``reduced``, ``assumed``, ``departures``
and ``qkv_bias`` (biases on the q, k and v projections, which some
architectures carry without a ``config.json`` key for them). `Sizes` is
what the benchmark's own code reads of it; `arch_config` builds the
port's ``ArchConfig`` from the same numbers. A configuration whose block
the dense SwiGLU stack does not compute exactly is refused: another
activation, LayerNorm, partial rotary, more than one expert, a layer
plan with other kinds of layer (Mamba, periods of attention or experts,
``layer_types``), or a sliding window."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Sizes:
    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    qkv_bias: bool = False

    @property
    def q_width(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_width(self) -> int:
        return self.kv_heads * self.head_dim


#: keys of a layer plan with blocks other than attention and one MLP
PLAN_KEYS = ("attn_layer_period", "attn_layer_offset", "expert_layer_period",
             "expert_layer_offset", "layer_types")


def sizes(name: str, cfg: dict) -> Sizes:
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{name}: only the SwiGLU (silu) block is run")
    if "layer_norm_eps" in cfg or cfg.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError(f"{name}: only RMSNorm and rotary on the whole head are run")
    experts = max(cfg.get("num_experts") or 1, cfg.get("num_local_experts") or 1)
    if experts > 1:
        raise ValueError(f"{name}: {experts} experts; only one MLP a layer is run")
    plan = sorted(k for k in cfg if k in PLAN_KEYS or k.startswith("mamba_"))
    if plan:
        raise ValueError(f"{name}: {plan} name layers other than attention; "
                         "only attention in every layer is run")
    if cfg.get("sliding_window") is not None or cfg.get("use_sliding_window"):
        raise ValueError(f"{name}: only full causal attention is run")
    heads = cfg["num_attention_heads"]
    return Sizes(
        name=name,
        layers=cfg["num_hidden_layers"],
        d=cfg["hidden_size"],
        heads=heads,
        kv_heads=cfg.get("num_key_value_heads", heads),
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        qkv_bias=bool(cfg.get("qkv_bias", False)),
    )


def arch_config(s: Sizes):
    """The port's ``ArchConfig`` of these sizes (a dense SwiGLU stack)."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(name=s.name, family="dense", n_layers=s.layers,
                      d_model=s.d, n_heads=s.heads, n_kv_heads=s.kv_heads,
                      head_dim=s.head_dim, d_ff=s.d_ff, vocab=s.vocab,
                      qkv_bias=s.qkv_bias, mlp_type="swiglu", norm_eps=s.norm_eps,
                      rope_theta=s.rope_theta)
