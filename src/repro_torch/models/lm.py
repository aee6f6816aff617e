"""TransformerLM, dense path: the serving entry points of the JAX
package's ``models/lm.py`` for the dense GQA family (minitron-8b and
its smoke config).

The JAX package runs the layers under ``lax.scan`` over stacked params;
here a Python loop walks the same ``(L, ...)`` leaves. Each layer's
cache is a view into the ``(L, ...)`` cache or pool buffers and is
written in place, so a decode tick never copies the pool.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, ParamDef, init_params, tree_map


def _stack(defs, L: int):
    return tree_map(lambda d: ParamDef((L,) + d.shape, ("layers",) + d.logical,
                                       init=d.init, scale=d.scale, dtype=d.dtype),
                    defs)


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        unported = [name for name, on in (
            ("MoE", cfg.n_experts), ("MLA", cfg.use_mla),
            ("first_dense_layers", cfg.first_dense_layers),
            ("cross-attention", cfg.cross_attn_every)) if on]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet (dense GQA only)")
        self.cfg = cfg

    # ------------------------------------------------------------------ params
    def _block_def(self):
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
            "ln2": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
            "attn": layers.attention_def(cfg),
            "mlp": layers.mlp_def(cfg),
        }

    def param_defs(self):
        cfg = self.cfg
        defs = {
            "embed": layers.embedding_def(cfg),
            "blocks": _stack(self._block_def(), cfg.n_layers),
            "ln_f": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
        }
        if not cfg.tie_embeddings:
            defs["lm_head"] = {"w": ParamDef((cfg.padded_vocab, cfg.d_model),
                                             ("vocab", "embed"), init="embed")}
        return defs

    def init(self, seed: int = 0, device="cpu"):
        return init_params(self.param_defs(), seed, self.cfg.pdtype(), device)

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch, max_seq, device="cpu"):
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"pos": 0,
                "k": torch.zeros(shape, dtype=cfg.cdtype(), device=device),
                "v": torch.zeros(shape, dtype=cfg.cdtype(), device=device)}

    def cache_specs(self):
        return {"pos": (),
                "k": ("layers", "batch", "kv_heads", "kv_seq", None),
                "v": ("layers", "batch", "kv_heads", "kv_seq", None)}

    # ------------------------------------------------------------------ blocks
    def _block(self, x, bp, *, positions, cache, cache_index, chunked=False,
               block_tables=None, pos_offset=None, paged_step=None, kv_len=None):
        cfg = self.cfg
        h = layers.rmsnorm(x, bp["ln1"], cfg)
        a = layers.attention(h, bp["attn"], cfg, positions=positions,
                             cache=cache, cache_index=cache_index,
                             chunked=chunked, block_tables=block_tables,
                             pos_offset=pos_offset, paged_step=paged_step,
                             kv_len=kv_len)
        x = x + a
        return x + layers.mlp(layers.rmsnorm(x, bp["ln2"], cfg), bp["mlp"], cfg)

    def _run_cached(self, params, x, positions, cache, cache_index, chunked=False):
        """Shared prefill/decode layer loop. x (B, S, D). In paged mode
        ``cache`` also carries ``block_tables`` and ``pos_offset`` (the
        per-slot count of tokens rolled out of a window; always 0 until
        rolling windows are ported)."""
        bt = cache.get("block_tables")
        poff = cache.get("pos_offset")
        paged_step = kv_len = None
        if x.shape[1] == 1:
            if bt is not None:
                paged_step = layers.paged_decode_step(bt, cache_index, poff,
                                                      cache["k"].shape[3])
            else:
                kv_len = torch.full((x.shape[0],), cache_index + 1,
                                    dtype=torch.int32, device=x.device)
        for i in range(self.cfg.n_layers):
            x = self._block(x, _layer(params["blocks"], i), positions=positions,
                            cache=(cache["k"][i], cache["v"][i]),
                            cache_index=cache_index, chunked=chunked,
                            block_tables=bt, pos_offset=poff,
                            paged_step=paged_step, kv_len=kv_len)
        return x

    def _head(self, params, x):
        x = layers.rmsnorm(x, params["ln_f"], self.cfg)
        head = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        return layers.unembed(x, head, self.cfg)

    # ------------------------------------------------------------------ serving
    def prefill_chunk(self, params, tokens, cache):
        """Prefill continuation: process a prompt chunk starting at
        ``cache["pos"]`` (an int), attending against the already-cached
        prefix. Returns the last position's logits (B, V) and the cache
        with ``pos`` advanced (K/V written in place)."""
        B, T = tokens.shape
        start = int(cache["pos"])
        sstart = start - int(cache.get("pos_offset", 0) or 0)
        x = layers.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(sstart, sstart + T, device=tokens.device)
        x = self._run_cached(params, x, positions, cache, cache_index=start,
                             chunked=True)
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, {**cache, "pos": start + T}

    def decode_step(self, params, token, cache):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int
        (contiguous, one shared position) or a (B,) int32 tensor (paged,
        per-slot positions). Returns logits (B, V) and the cache with
        ``pos`` advanced."""
        pos = cache["pos"]
        x = layers.embed(token, params["embed"], self.cfg)
        if isinstance(pos, int):
            positions = torch.tensor([pos], device=token.device)
        else:
            positions = (pos - cache["pos_offset"] if "pos_offset" in cache
                         else pos)[:, None]
        x = self._run_cached(params, x, positions, cache, cache_index=pos)
        logits = self._head(params, x)[:, 0]
        return logits, {**cache, "pos": pos + 1}
