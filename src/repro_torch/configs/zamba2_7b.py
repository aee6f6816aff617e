"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

81 Mamba2 layers, d_model 3584, ssm_state 64; ONE shared transformer
block (32 heads, kv 32, d_ff 14336) applied every 6th layer.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=7,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=16,
    attn_every=3,
    max_seq_len=128,
    vocab_pad_to=32,
)
