"""xLSTM-125M [arXiv:2405.04517]: mLSTM blocks with sLSTM every 4th."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    xlstm_slstm_every=4,
    xlstm_proj_factor=2.0,
    max_seq_len=524288,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=256,
    xlstm_slstm_every=4,
    xlstm_proj_factor=2.0,
    max_seq_len=128,
    vocab_pad_to=32,
)
