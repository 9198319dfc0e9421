"""qwen1.5-32b — dense with QKV bias and full MHA (kv = heads).

[hf:Qwen family] 64L, d_model=5120, 40H (kv=40, i.e. MHA), d_ff=27392,
vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1e6,
    max_seq=131072,
)
