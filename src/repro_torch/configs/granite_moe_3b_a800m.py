"""granite-moe-3b-a800m — fine-grained MoE (40 experts, top-8).

[hf:ibm-granite family] 32L, d_model=1536, 24H (GQA kv=8), d_ff=512
(per-expert, fine-grained), vocab=49155, 40 experts top-8 every layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    moe_every=1,
    expert_pad_to=48,  # 40 does not divide the 16-way model axis
    mlp_type="swiglu",
    rope_theta=1e4,
    max_seq=131072,
    tie_embeddings=True,
)
