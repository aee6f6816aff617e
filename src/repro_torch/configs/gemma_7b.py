"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim 256, (1+w) RMSNorm,
sqrt(d) embedding scaling, tied embeddings."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    gemma_style=True,
    tie_embeddings=True,
    max_seq_len=8192,
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    gemma_style=True,
    tie_embeddings=True,
    max_seq_len=128,
    vocab_pad_to=32,
)
