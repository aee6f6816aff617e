"""TransformerLM: the serving and training entry points of the JAX
package's ``models/lm.py`` for the dense GQA family (minitron-8b,
gemma-7b, granite-20b, deepseek-67b), the MoE family, with MLA
(deepseek-v2-lite-16b: unstacked leading dense blocks ``dense{i}``,
then MoE blocks) or GQA (grok-1-314b), and the vision family
(llama-3.2-vision-11b: a stacked side-stack ``cross`` of tanh-gated
cross-attention blocks, one after every ``cross_attn_every``-th layer,
over the stub frontend's patch embeddings).

Vision: ``extra={"vision": (B, n_image_tokens, vision_dim)}`` passed to
``forward``, ``prefill`` or ``prefill_chunk`` is projected (``vis_proj``)
and each cross layer's K/V are computed once; the cached entry points
write them into the cache leaves ``cross_k``/``cross_v`` (n_cross, B,
Hkv, n_image_tokens, D), which later chunks, ``verify_chunk`` and
``decode_step`` attend (non-causal ``ops.flash_attention``) as they find
them. Without extras the cross blocks attend whatever those leaves hold
(zeros in a fresh cache), as in the JAX package, whose serving engine
passes no extras.

The JAX package runs the layers under ``lax.scan`` over stacked params;
here a Python loop walks the same ``(L, ...)`` leaves. Each layer's
cache is a view into the ``(L, ...)`` cache or pool buffers and is
written in place, so a decode tick never copies the pool. The training
forward recomputes each layer in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).

MoE blocks route with ``cfg.capacity_factor`` in the training forward
and with ``cfg.eval_capacity_factor`` whenever a cache is passed
(prefill, chunks, decode, verify), as the reference does.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import layers, mla as mla_mod, moe as moe_mod
from repro_torch.models.common import ModelConfig, ParamDef, init_params, tree_map


def _stack(defs, L: int):
    return tree_map(lambda d: ParamDef((L,) + d.shape, ("layers",) + d.logical,
                                       init=d.init, scale=d.scale, dtype=d.dtype),
                    defs)


def _layer(tree, i: int):
    return tree_map(lambda t: t[i], tree)


class TransformerLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_scan = cfg.n_layers - cfg.first_dense_layers
        self.has_cross = cfg.cross_attn_every > 0
        self.n_cross = cfg.n_layers // cfg.cross_attn_every if self.has_cross else 0
        self.mla_absorbed = cfg.mla_absorbed_decode

    # ------------------------------------------------------------------ params
    def _block_def(self, moe_block: bool = True):
        cfg = self.cfg
        return {
            "ln1": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
            "ln2": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
            "attn": mla_mod.mla_def(cfg) if cfg.use_mla else layers.attention_def(cfg),
            "mlp": (moe_mod.moe_def(cfg) if moe_block and cfg.n_experts
                    else layers.mlp_def(cfg)),
        }

    def param_defs(self):
        cfg = self.cfg
        defs = {
            "embed": layers.embedding_def(cfg),
            "blocks": _stack(self._block_def(moe_block=True), self.n_scan),
            "ln_f": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
        }
        if not cfg.tie_embeddings:
            defs["lm_head"] = {"w": ParamDef((cfg.padded_vocab, cfg.d_model),
                                             ("vocab", "embed"), init="embed")}
        for i in range(cfg.first_dense_layers):
            defs[f"dense{i}"] = self._block_def(moe_block=False)
        if self.has_cross:
            defs["cross"] = _stack({"ln": layers.rmsnorm_def(cfg.d_model),
                                    "attn": layers.attention_def(cfg, cross=True)},
                                   self.n_cross)
            if cfg.vision_dim and cfg.vision_dim != cfg.d_model:
                defs["vis_proj"] = {"w": ParamDef((cfg.vision_dim, cfg.d_model),
                                                  (None, "embed"), init="scaled")}
        return defs

    def init(self, seed: int = 0, device="cpu"):
        return init_params(self.param_defs(), seed, self.cfg.pdtype(), device)

    # ------------------------------------------------------------------ cache
    def _kv_names(self):
        return ("c_kv", "k_rope") if self.cfg.use_mla else ("k", "v")

    def _dense_names(self, i):
        if self.cfg.use_mla:
            return (f"dense{i}_ckv", f"dense{i}_krope")
        return (f"dense{i}_k", f"dense{i}_v")

    def init_cache(self, batch, max_seq, device="cpu"):
        cfg = self.cfg
        if cfg.use_mla:
            one = ((batch, max_seq, cfg.kv_lora_rank),
                   (batch, max_seq, cfg.qk_rope_head_dim))
        else:
            one = ((batch, cfg.n_kv_heads, max_seq, cfg.head_dim),) * 2
        shapes = {n: (self.n_scan,) + s for n, s in zip(self._kv_names(), one)}
        for i in range(cfg.first_dense_layers):
            shapes.update(zip(self._dense_names(i), one))
        if self.has_cross:
            cross = (self.n_cross, batch, cfg.n_kv_heads, cfg.n_image_tokens, cfg.head_dim)
            shapes.update(cross_k=cross, cross_v=cross)
        return {"pos": 0, **{n: torch.zeros(s, dtype=cfg.cdtype(), device=device)
                             for n, s in shapes.items()}}

    def cache_specs(self):
        cfg = self.cfg
        if cfg.use_mla:
            one = ("batch", "kv_seq", None)
        else:
            one = ("batch", "kv_heads", "kv_seq", None)
        specs = {"pos": ()}
        for n in self._kv_names():
            specs[n] = ("layers",) + one
        for i in range(cfg.first_dense_layers):
            for n in self._dense_names(i):
                specs[n] = one
        if self.has_cross:
            # state leaves (a batch axis, no "kv_seq"): the pool snapshots them
            specs["cross_k"] = specs["cross_v"] = (None, "batch", "kv_heads", None, None)
        return specs

    def _entry(self, cache, names, i=None):
        """A layer's cache entry: its two leaves (layer i of the stacked
        ones), plus their scale sidecars in a quantized pool."""
        if f"{names[0]}_qscale" in cache:
            names += tuple(f"{n}_qscale" for n in names)
        return tuple(cache[n] if i is None else cache[n][i] for n in names)

    def _dense_cache(self, cache, i):
        return self._entry(cache, self._dense_names(i))

    def _layer_cache(self, cache, i):
        return self._entry(cache, self._kv_names(), i)

    # ------------------------------------------------------------------ blocks
    def _attn(self, x, bp, **kw):
        if self.cfg.use_mla:
            return mla_mod.mla_attention(x, bp, self.cfg, absorbed=self.mla_absorbed, **kw)
        return layers.attention(x, bp, self.cfg, **kw)

    def _mlp(self, x, bp, moe_block: bool, is_eval: bool):
        cfg = self.cfg
        if moe_block and cfg.n_experts:
            cf = cfg.eval_capacity_factor if is_eval else cfg.capacity_factor
            return moe_mod.moe_mlp(x, bp, cfg, capacity_factor=cf)
        return layers.mlp(x, bp, cfg)

    def _block(self, x, bp, *, positions, cache=None, cache_index=None, chunked=False,
               block_tables=None, pos_offset=None, paged_step=None, kv_len=None,
               moe_block=True):
        cfg = self.cfg
        h = layers.rmsnorm(x, bp["ln1"], cfg)
        a = self._attn(h, bp["attn"], positions=positions,
                       cache=cache, cache_index=cache_index,
                       chunked=chunked, block_tables=block_tables,
                       pos_offset=pos_offset, paged_step=paged_step,
                       kv_len=kv_len)
        x = x + a
        return x + self._mlp(layers.rmsnorm(x, bp["ln2"], cfg), bp["mlp"], moe_block,
                             cache is not None)

    def _cross_block(self, x, cp, k, v):
        """Gated cross-attention over precomputed context K/V, k and v
        (B, Hkv, Sc, D): no rope, no mask, x + tanh(gate) * attn."""
        h = layers.rmsnorm(x, cp["ln"], self.cfg)
        return x + layers.cross_attention(h, cp["attn"], self.cfg, k, v)

    def _vision_context(self, params, vision_embed):
        """Stub-frontend patch embeddings -> model-dim context (or None)."""
        if vision_embed is None:
            return None
        x = vision_embed.to(self.cfg.cdtype())
        if "vis_proj" in params:
            x = x @ params["vis_proj"]["w"].to(x.dtype)
        return x

    def _cross_kv_all(self, params, context):
        """(k, v) of every cross layer over ``context``: (n_cross, B, Hkv,
        Sc, D) each."""
        ks, vs = zip(*(layers.cross_kv(context, _layer(params["cross"]["attn"], i), self.cfg)
                       for i in range(self.n_cross)))
        return torch.stack(ks), torch.stack(vs)

    def _cross_every(self, x, i, params, cross_kv):
        """The cross block after scanned layer ``i``, where one is due."""
        every = self.cfg.cross_attn_every
        idx = self.cfg.first_dense_layers + i
        if cross_kv is None or idx % every != every - 1:
            return x
        inv = idx // every
        return self._cross_block(x, _layer(params["cross"], inv),
                                 cross_kv[0][inv], cross_kv[1][inv])

    def _take_vision(self, params, cache, extra):
        """Write the cross K/V of ``extra["vision"]``, when given, into the
        cache's cross leaves (in place)."""
        context = self._vision_context(params, (extra or {}).get("vision"))
        if self.has_cross and context is not None:
            k, v = self._cross_kv_all(params, context)
            cache["cross_k"].copy_(k)
            cache["cross_v"].copy_(v)

    def _run_cached(self, params, x, positions, cache, cache_index, chunked=False):
        """Shared prefill/decode layer loop. x (B, S, D). In paged mode
        ``cache`` also carries ``block_tables`` and ``pos_offset`` (the
        per-slot count of tokens rolled out of a window)."""
        bt = cache.get("block_tables")
        poff = cache.get("pos_offset")
        paged_step = kv_len = None
        if x.shape[1] == 1:
            if bt is not None and self.cfg.use_mla:
                paged_step = mla_mod._paged_step(bt, cache_index, poff,
                                                 cache["c_kv"].shape[2])
            elif bt is not None:
                paged_step = layers.paged_decode_step(bt, cache_index, poff,
                                                      cache["k"].shape[3])
            else:
                kv_len = layers.decode_kv_len(cache_index, x.shape[0], x.device)
        kw = dict(positions=positions, cache_index=cache_index, chunked=chunked,
                  block_tables=bt, pos_offset=poff, paged_step=paged_step, kv_len=kv_len)
        cross_kv = (cache["cross_k"], cache["cross_v"]) if self.has_cross else None
        for i in range(self.cfg.first_dense_layers):
            x = self._block(x, params[f"dense{i}"], cache=self._dense_cache(cache, i),
                            moe_block=False, **kw)
        for i in range(self.n_scan):
            x = self._block(x, _layer(params["blocks"], i),
                            cache=self._layer_cache(cache, i), **kw)
            x = self._cross_every(x, i, params, cross_kv)
        return x

    def _head(self, params, x):
        x = layers.rmsnorm(x, params["ln_f"], self.cfg)
        head = params["embed"] if self.cfg.tie_embeddings else params["lm_head"]
        return layers.unembed(x, head, self.cfg)

    # ------------------------------------------------------------------ training
    def forward(self, params, tokens, extra=None):
        """Training forward (no cache): tokens (B, T) -> logits (B, T, V)
        in the compute dtype. ``extra`` may carry {"vision": embeddings}."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        context = self._vision_context(params, (extra or {}).get("vision"))
        cross_kv = (self._cross_kv_all(params, context)
                    if self.has_cross and context is not None else None)

        def block(x, bp, moe_block=True):
            return self._block(x, bp, positions=positions, moe_block=moe_block)

        remat = cfg.remat and torch.is_grad_enabled()

        def run(x, bp, moe_block=True):
            if remat:
                return torch.utils.checkpoint.checkpoint(block, x, bp, moe_block,
                                                         use_reentrant=False)
            return block(x, bp, moe_block)

        for i in range(cfg.first_dense_layers):
            x = run(x, params[f"dense{i}"], moe_block=False)
        for i in range(self.n_scan):
            x = run(x, _layer(params["blocks"], i))
            x = self._cross_every(x, i, params, cross_kv)
        return self._head(params, x)

    def loss(self, params, batch):
        return _lm_loss(self, params, batch)

    # ------------------------------------------------------------------ serving
    def prefill(self, params, tokens, cache, extra=None):
        """Whole-prompt prefill into a fresh contiguous cache: K/V written
        at 0, causal attention through ``ops.flash_attention``. Returns
        the last position's logits (B, V) and the cache with ``pos`` = T.
        ``extra["vision"]``, when given, fills the cross leaves first."""
        self._take_vision(params, cache, extra)
        T = tokens.shape[1]
        x = layers.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(T, device=tokens.device)
        x = self._run_cached(params, x, positions, cache, cache_index=0)
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, {**cache, "pos": T}

    def prefill_chunk(self, params, tokens, cache, extra=None):
        """Prefill continuation: process a prompt chunk starting at
        ``cache["pos"]`` (an int), attending against the already-cached
        prefix. Returns the last position's logits (B, V) and the cache
        with ``pos`` advanced (K/V written in place; ``extra["vision"]``,
        when given, fills the cross leaves first). The head runs over
        every row of the chunk, as ``verify_chunk``'s does, so the two
        give the same bits for the same window (a matmul's summation
        order may depend on its row count); its cost is the head's
        weight read either way."""
        B, T = tokens.shape
        start = int(cache["pos"])
        sstart = start - int(cache.get("pos_offset", 0) or 0)
        self._take_vision(params, cache, extra)
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
        rewritten before ``pos`` reaches them again. The cross blocks
        attend the cache's cross leaves; ``extra`` is taken and unused,
        as in the JAX package."""
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

    def decode_step(self, params, token, cache, extra=None):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int
        (one shared position) or a (B,) int32 tensor of per-slot positions
        (paged, or the contiguous cache of the splice path). Returns
        logits (B, V) and the cache with ``pos`` advanced. The cross
        blocks attend the cache's cross leaves; ``extra`` is taken and
        unused, as in the JAX package."""
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
