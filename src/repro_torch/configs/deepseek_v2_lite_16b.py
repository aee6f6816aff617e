"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA (kv_lora_rank 512) +
MoE (64 routed top-6 + 2 shared, expert d_ff 1408, first layer dense).

The published Lite config has 64 routed experts (160 belongs to the full
V2); both fields match the JAX package's config.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,           # dense first layer
    moe_d_ff=1408,        # routed expert width
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    moe_d_ff=32,
    vocab_size=256,
    n_experts=8,
    n_shared_experts=2,
    top_k=2,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=32,
    q_lora_rank=0,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    max_seq_len=128,
    vocab_pad_to=32,
)
