"""stablelm-1.6b — small dense MHA model.

[hf:stabilityai/stablelm-2-1_6b] 24L, d_model=2048, 32H (kv=32, MHA),
d_ff=5632, vocab=100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    mlp_type="swiglu",
    rope_theta=1e4,
    max_seq=16384,
)
