"""TransformerLM, dense path: the serving and training entry points of
the JAX package's ``models/lm.py`` for the dense GQA family (minitron-8b
and its smoke config).

The JAX package runs the layers under ``lax.scan`` over stacked params;
here a Python loop walks the same ``(L, ...)`` leaves. Each layer's
cache is a view into the ``(L, ...)`` cache or pool buffers and is
written in place, so a decode tick never copies the pool. The training
forward recomputes each layer in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

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
    def _block(self, x, bp, *, positions, cache=None, cache_index=None, chunked=False,
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
                kv_len = layers.decode_kv_len(cache_index, x.shape[0], x.device)
        # quantized pools: the (L, P, Hkv, page) scale sidecars ride with
        # their pages as two more entries of each layer's cache
        names = ("k", "v") + (("k_qscale", "v_qscale") if "k_qscale" in cache else ())
        for i in range(self.cfg.n_layers):
            x = self._block(x, _layer(params["blocks"], i), positions=positions,
                            cache=tuple(cache[n][i] for n in names),
                            cache_index=cache_index, chunked=chunked,
                            block_tables=bt, pos_offset=poff,
                            paged_step=paged_step, kv_len=kv_len)
        return x

    def _head(self, params, x):
        x = layers.rmsnorm(x, params["ln_f"], self.cfg)
        head = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        return layers.unembed(x, head, self.cfg)

    # ------------------------------------------------------------------ training
    def forward(self, params, tokens, extra=None):
        """Training forward (no cache): tokens (B, T) -> logits (B, T, V)
        in the compute dtype."""
        if extra:
            raise NotImplementedError("vision/frames extras are not ported yet")
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)

        def block(x, bp):
            return self._block(x, bp, positions=positions)

        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            x = (torch.utils.checkpoint.checkpoint(block, x, bp, use_reentrant=False)
                 if remat else block(x, bp))
        return self._head(params, x)

    def loss(self, params, batch):
        return _lm_loss(self, params, batch)

    # ------------------------------------------------------------------ serving
    def prefill(self, params, tokens, cache, extra=None):
        """Whole-prompt prefill into a fresh contiguous cache: K/V written
        at 0, causal attention through ``ops.flash_attention``. Returns
        the last position's logits (B, V) and the cache with ``pos`` = T."""
        if extra:
            raise NotImplementedError("vision/frames extras are not ported yet")
        T = tokens.shape[1]
        x = layers.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(T, device=tokens.device)
        x = self._run_cached(params, x, positions, cache, cache_index=0)
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, {**cache, "pos": T}

    def prefill_chunk(self, params, tokens, cache):
        """Prefill continuation: process a prompt chunk starting at
        ``cache["pos"]`` (an int), attending against the already-cached
        prefix. Returns the last position's logits (B, V) and the cache
        with ``pos`` advanced (K/V written in place). The head runs over
        every row of the chunk, as ``verify_chunk``'s does, so the two
        give the same bits for the same window (a matmul's summation
        order may depend on its row count); its cost is the head's
        weight read either way."""
        B, T = tokens.shape
        start = int(cache["pos"])
        sstart = start - int(cache.get("pos_offset", 0) or 0)
        x = layers.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(sstart, sstart + T, device=tokens.device)
        x = self._run_cached(params, x, positions, cache, cache_index=start,
                             chunked=True)
        logits = self._head(params, x)[:, -1]
        return logits, {**cache, "pos": start + T}

    def verify_chunk(self, params, tokens, cache, extra=None):
        """Speculative verification (the verifier's side of the
        ``propose_k``/``verify_chunk`` contract): score a (B, W) window --
        each slot's last emitted token followed by its draft -- whose
        first token sits at ``cache["pos"]`` (an int or a (B,) tensor),
        through the chunked-prefill machinery (contiguous, or the paged
        verify window). K/V are written at pos .. pos + W - 1 and logits
        come back for all W positions: (B, W, V).

        ``cache["pos"]`` is NOT advanced: the caller moves it by the
        number of accepted tokens. Rejected positions need no undo: they
        sit beyond the new ``pos``, are masked out by ``kv_len`` and are
        rewritten before ``pos`` reaches them again."""
        T = tokens.shape[1]
        start = cache["pos"]
        sstart = start - cache["pos_offset"] if "pos_offset" in cache else start
        x = layers.embed(tokens, params["embed"], self.cfg)
        ar = torch.arange(T, device=tokens.device)
        positions = sstart[:, None] + ar[None, :] if torch.is_tensor(sstart) else sstart + ar
        x = self._run_cached(params, x, positions, cache, cache_index=start, chunked=True)
        return self._head(params, x), {**cache, "pos": start}

    def propose_k(self, params, token, cache, k: int, extra=None):
        """Speculative drafting (the drafter's side of the contract):
        greedily decode ``k`` tokens from ``token`` (B, 1), writing K/V
        for the input token and all k drafts at pos .. pos + k -- one
        step past the last draft, so a fully accepted window (which
        advances the caller's pos by k + 1) leaves no hole in the
        drafter's history. Returns (drafts (B, k), cache with pos
        advanced by k + 1)."""
        cfg = self.cfg
        valid = torch.arange(cfg.padded_vocab, device=token.device) < cfg.vocab_size
        tok, drafts = token, []
        for _ in range(k + 1):
            logits, cache = self.decode_step(params, tok, cache)
            tok = torch.argmax(torch.where(valid, logits.float(), -1e30), dim=-1)[:, None]
            drafts.append(tok[:, 0])
        return torch.stack(drafts[:k], dim=1), cache

    def decode_step(self, params, token, cache):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int
        (one shared position) or a (B,) int32 tensor of per-slot positions
        (paged, or the contiguous cache of the splice path). Returns
        logits (B, V) and the cache with ``pos`` advanced."""
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


def _lm_loss(model, params, batch):
    """Shared next-token loss (the JAX package's ``models/ssm.py::
    _lm_loss``): batch = {tokens (B, T+1), loss_mask?}. Float32 logits,
    padded vocab columns masked to -1e30. Returns (loss, {"nll": mean})."""
    cfg = model.cfg
    tokens = batch["tokens"]
    logits = model.forward(params, tokens[:, :-1], batch.get("extra")).float()
    labels = tokens[:, 1:].long()
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:]
        return (nll * mask).sum() / mask.sum().clamp(min=1.0), {"nll": nll.mean()}
    return nll.mean(), {"nll": nll.mean()}
