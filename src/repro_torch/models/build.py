"""Model factory: ModelConfig -> model object.

Protocol (see lm.TransformerLM, ssm.HybridLM, xlstm.XLSTMLM,
encdec.EncDecLM): param_defs() / init(seed, device),
init_cache(batch, max_seq, device) / cache_specs(),
prefill_chunk(params, tokens, cache) -> (last_logits, cache),
decode_step(params, token, cache) -> (logits, cache); TransformerLM (the
dense, moe and vlm families) also
has forward(params, tokens) -> logits, loss(params, batch) -> (loss,
metrics) and prefill(params, tokens, cache) -> (last_logits, cache), as
does the xLSTM model. TransformerLM alone has the speculative contract,
verify_chunk(params, window, cache) -> (logits (B, W, V), cache) and
propose_k(params, token, cache, k) -> (drafts (B, k), cache).

Extras: the vlm family's forward / prefill / prefill_chunk take
``extra={"vision": (B, n_image_tokens, vision_dim)}``; EncDecLM's
forward and prefill need ``extra={"frames": (B, encoder_seq_len,
d_model)}`` and its prefill_chunk runs the encoder when a chunk brings
them. The serving engine passes none: the cross blocks then attend the
cache's cross leaves as they are.
"""

from __future__ import annotations

from repro_torch.models.common import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.family == "hybrid":
        from repro_torch.models.ssm import HybridLM
        return HybridLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import XLSTMLM
        return XLSTMLM(cfg)
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}")
    from repro_torch.models.lm import TransformerLM
    return TransformerLM(cfg)
