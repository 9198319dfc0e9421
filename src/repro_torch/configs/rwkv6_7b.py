"""rwkv6-7b "Finch" — attention-free, data-dependent decay.

[arXiv:2404.05892] 32L, d_model=4096, d_ff=14336 (channel-mix),
vocab=65536, head size 64 -> 64 rwkv heads. O(1) decode state ->
participates in ``long_500k``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=32,  # unused (attn-free); kept for schema completeness
    n_kv_heads=32,
    d_ff=14336,
    vocab=65536,
    attn_free=True,
    rwkv_head_size=64,
    max_seq=524288,
    run_long_context=True,
)
