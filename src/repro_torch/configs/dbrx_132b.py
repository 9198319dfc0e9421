"""dbrx-132b — large fine-grained MoE (16 experts, top-4).

[hf:databricks/dbrx-base] 40L, d_model=6144, 48H (GQA kv=8),
d_ff=10752 per expert, vocab=100352, 16 experts top-4 every layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    moe_every=1,
    mlp_type="swiglu",
    rope_theta=5e5,
    max_seq=131072,
)
