"""mistral-nemo-12b — dense 128k-context model.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L, d_model=5120, 32H (GQA kv=8),
d_ff=14336, vocab=131072, head_dim=128 (decoupled from d_model/n_heads).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    mlp_type="swiglu",
    rope_theta=1e6,
    max_seq=131072,
)
