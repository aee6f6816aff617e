"""Granite-20B-Code [arXiv:2405.04324]: llama-arch with MQA (kv=1)."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    max_seq_len=16384,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    max_seq_len=128,
    vocab_pad_to=32,
)
