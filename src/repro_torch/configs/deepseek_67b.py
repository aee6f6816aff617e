"""DeepSeek-67B [arXiv:2401.02954]: deep llama-arch dense model."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=160,
    vocab_size=256,
    max_seq_len=128,
    vocab_pad_to=32,
)
