"""minitron-4b — width/depth-pruned Nemotron distillation.

[arXiv:2407.14679] 32L, d_model=3072, 24H (GQA kv=8), d_ff=9216,
vocab=256000. Nemotron lineage: squared-ReLU (non-gated) MLP,
untied huge embedding table.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    mlp_type="gelu",
    rope_theta=1e4,
    max_seq=131072,
)
