"""Model factory: ModelConfig -> model object.

Protocol (see lm.TransformerLM): param_defs() / init(seed, device),
init_cache(batch, max_seq, device) / cache_specs(),
prefill_chunk(params, tokens, cache) -> (last_logits, cache),
decode_step(params, token, cache) -> (logits, cache).
"""

from __future__ import annotations

from repro_torch.models.common import ModelConfig


def build_model(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)")
    from repro_torch.models.lm import TransformerLM
    return TransformerLM(cfg)
