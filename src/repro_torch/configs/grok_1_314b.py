"""Grok-1 314B [hf:xai-org/grok-1]: 8-expert top-2 MoE, GQA 48H/kv8."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    router_renorm=False,
    max_seq_len=8192,
)

SMOKE = ModelConfig(
    name="grok-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    moe_d_ff=128,
    vocab_size=256,
    n_experts=4,
    n_shared_experts=0,
    top_k=2,
    router_renorm=False,
    max_seq_len=128,
    vocab_pad_to=32,
)
