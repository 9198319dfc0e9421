"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2 on every other layer. One attention
layer per 8-layer block (1:7 attn:mamba); sub-quadratic decode state ->
participates in ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    mamba_chunk=256,
    mlp_type="swiglu",
    rope_theta=1e6,
    max_seq=524288,
    run_long_context=True,
)
