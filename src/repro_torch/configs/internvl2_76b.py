"""internvl2-76b — VLM: InternViT frontend + InternLM2-style decoder.

[arXiv:2404.16821] Backbone: 80L, d_model=8192, 64H (GQA kv=8),
d_ff=28672, vocab=128256. The InternViT-6B vision tower is a STUB per
the assignment: ``input_specs`` provides precomputed patch embeddings
(dim 3200) which a linear projector maps into the LM space.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="vision_stub",
    frontend_dim=3200,
    mlp_type="swiglu",
    rope_theta=1e6,
    max_seq=131072,
)
