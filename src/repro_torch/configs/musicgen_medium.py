"""musicgen-medium — decoder-only over EnCodec audio tokens.

[arXiv:2306.05284] 48L, d_model=1536, 24H (kv=24, MHA), d_ff=6144,
vocab=2048 (EnCodec codebook). The EnCodec frontend is a STUB per the
assignment: ``input_specs`` provides precomputed frame embeddings
(EnCodec latent dim 128) that a linear projector lifts to d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    frontend="audio_stub",
    frontend_dim=128,
    mlp_type="gelu",
    rope_theta=1e4,
    max_seq=32768,
)
