"""Architecture configuration schema (a copy of ``repro.configs.base``).

Every assigned architecture is a decoder-style stack of residual blocks;
a block = (mixer, ffn) where mixer in {attn, mamba, rwkv} and ffn in
{dense, moe, rwkv_cmix}. Heterogeneous stacks (jamba) repeat a fixed
pattern. The JAX package stacks parameters over pattern repeats for
``lax.scan``; this package holds them per layer and loops in Python, so
``pattern`` and ``n_repeats`` matter here only to carry parameters and
caches across from the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # layer i is MoE iff n_experts>0 and i % moe_every == moe_every-1
    capacity_factor: float = 1.25  # advisory (sort-based path is dropless)
    #: storage padding of the expert banks (0 = none). Padding to a
    #: multiple of the TP axis restores expert-parallel sharding when
    #: the true expert count does not divide it (granite: 40 -> 48);
    #: padded experts are never routed to (router stays n_experts wide).
    expert_pad_to: int = 0

    # --- hybrid / SSM ---
    attn_every: int = 0  # jamba: attn layer iff i % attn_every == attn_every // 2
    attn_free: bool = False  # rwkv: no attention anywhere
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 64
    rwkv_head_size: int = 64

    # --- flavour ---
    qkv_bias: bool = False
    mlp_type: str = "swiglu"  # swiglu | gelu
    frontend: str = "none"  # none | vision_stub | audio_stub
    frontend_dim: int = 0  # stub embedding dim (0 -> tokens, no stub)
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    max_seq: int = 131072
    tie_embeddings: bool = False

    # --- shape sets this arch participates in ---
    run_long_context: bool = False  # long_500k only for ssm/hybrid

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # ------------------------------------------------------------------
    # layer plan & repeating pattern
    # ------------------------------------------------------------------
    def layer_plan(self) -> tuple[tuple[str, str], ...]:
        """(mixer, ffn) kind per layer."""
        plan = []
        for i in range(self.n_layers):
            if self.attn_free:
                mixer = "rwkv"
            elif self.attn_every > 0:
                mixer = "attn" if i % self.attn_every == self.attn_every // 2 else "mamba"
            else:
                mixer = "attn"
            if mixer == "rwkv":
                ffn = "rwkv_cmix"
            elif self.n_experts > 0 and i % self.moe_every == self.moe_every - 1:
                ffn = "moe"
            else:
                ffn = "dense"
            plan.append((mixer, ffn))
        return tuple(plan)

    def pattern(self) -> tuple[tuple[str, str], ...]:
        """Shortest repeating block pattern dividing n_layers."""
        plan = self.layer_plan()
        n = len(plan)
        for p in range(1, n + 1):
            if n % p == 0 and all(plan[i] == plan[i % p] for i in range(n)):
                return plan[:p]
        return plan

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.pattern())

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    # ------------------------------------------------------------------
    # parameter counting (roofline MODEL_FLOPS = 6 N D / 6 N_active D)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict[str, float]:
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        total = active = v * d  # embed
        total += d * v  # lm head
        active += d * v
        for mixer, ffn in self.layer_plan():
            if mixer == "attn":
                p = d * h * hd + 2 * d * kv * hd + h * hd * d
            elif mixer == "mamba":
                di, ns = self.d_inner, self.mamba_d_state
                p = d * 2 * di + di * self.mamba_d_conv + di * ns  # in, conv, A
                p += di * (1 + 2 * ns)  # dt, B, C projections (folded x_proj)
                p += di * d  # out
            else:  # rwkv time-mix
                p = 5 * d * d + d * d  # r,k,v,g,o + decay proj (approx lora)
            total += p
            active += p
            if ffn == "dense":
                q = (3 if self.mlp_type == "swiglu" else 2) * d * f
                total += q
                active += q
            elif ffn == "moe":
                per = (3 if self.mlp_type == "swiglu" else 2) * d * f
                total += self.n_experts * per + d * self.n_experts
                active += self.top_k * per + d * self.n_experts
            else:  # rwkv channel-mix
                q = d * int(3.5 * d) + int(3.5 * d) * d
                total += q
                active += q
        return {"total": float(total), "active": float(active)}


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests.

    Preserves the layer *pattern* (hybrid interleave, MoE cadence, GQA
    ratio) while shrinking width/depth/vocab so one step runs on CPU.
    """
    pat = len(cfg.pattern())
    n_layers = pat * min(2, cfg.n_repeats)
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = min(cfg.n_heads, 4 * ratio) if not cfg.attn_free else 4
    n_kv = max(1, n_heads // ratio)
    head_dim = 16
    d_model = n_heads * head_dim if not cfg.attn_free else 64
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=max(32, d_model * 2) if cfg.n_experts == 0 else 32,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        rwkv_head_size=16,
        mamba_d_state=8,
        mamba_chunk=8,
        max_seq=128,
    )
