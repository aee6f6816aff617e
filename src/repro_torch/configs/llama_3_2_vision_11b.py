"""Llama-3.2-Vision 11B [hf:meta-llama/Llama-3.2-11B-Vision]: 40L text
backbone with gated cross-attention image layers every 5th layer.
Vision frontend is a STUB: input_specs() provides patch embeddings."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    n_image_tokens=1601,
    vision_dim=1280,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=2,
    n_image_tokens=12,
    vision_dim=32,
    max_seq_len=128,
    vocab_pad_to=32,
)
