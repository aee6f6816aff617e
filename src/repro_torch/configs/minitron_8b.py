"""Minitron-8B [arXiv:2407.14679]: pruned Nemotron, llama-arch GQA."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    max_seq_len=128,
    vocab_pad_to=32,
)
