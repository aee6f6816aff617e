"""Whisper-medium [arXiv:2212.04356]: 24L encoder + 24L decoder,
conv/mel frontend stubbed (precomputed frame embeddings)."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    is_encoder_decoder=True,
    n_layers=24,
    n_encoder_layers=24,
    encoder_seq_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    use_rope=False,
    tie_embeddings=True,
    max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    is_encoder_decoder=True,
    n_layers=2,
    n_encoder_layers=2,
    encoder_seq_len=24,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    use_rope=False,
    tie_embeddings=True,
    max_seq_len=128,
    vocab_pad_to=32,
)
