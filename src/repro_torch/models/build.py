"""Model factory: ModelConfig -> model object.

Protocol (see lm.TransformerLM, ssm.HybridLM, xlstm.XLSTMLM): param_defs() /
init(seed, device),
init_cache(batch, max_seq, device) / cache_specs(),
prefill_chunk(params, tokens, cache) -> (last_logits, cache),
decode_step(params, token, cache) -> (logits, cache); TransformerLM (the
dense and moe families) also
has forward(params, tokens) -> logits, loss(params, batch) -> (loss,
metrics) and prefill(params, tokens, cache) -> (last_logits, cache), as
does the xLSTM model. TransformerLM alone has the speculative contract,
verify_chunk(params, window, cache) -> (logits (B, W, V), cache) and
propose_k(params, token, cache, k) -> (drafts (B, k), cache).
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
    if cfg.is_encoder_decoder or cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense, moe, "
            "hybrid and ssm only)")
    from repro_torch.models.lm import TransformerLM
    return TransformerLM(cfg)
