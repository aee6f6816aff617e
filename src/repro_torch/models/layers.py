"""Core transformer layers: norms, rope, embeddings, GQA self- and
cross-attention, gated MLP -- for serving and training.

Parameters are nested dicts of tensors built from ParamDef trees (see
common.py), with the JAX package's key paths and ``(in, out)`` matmul
layout. Attention writes K/V in place into the cache tensors it is given
-- views into the page pool or the contiguous cache -- where the JAX
package returns updated copies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (gather_grad_unless_divides,
                                              gather_unless_divides, grad_like,
                                              shard_as)
from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamDef

# ---------------------------------------------------------------------------
# defs
# ---------------------------------------------------------------------------


def rmsnorm_def(d_model: int, gemma_style: bool = False):
    return {"w": ParamDef((d_model,), ("embed",), init="zeros" if gemma_style else "ones")}


def attention_def(cfg: ModelConfig, *, cross: bool = False):
    """Standard (non-MLA) GQA attention parameter defs; ``cross`` adds the
    zero-initialised ``gate`` of tanh-gated cross-attention."""
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs = {
        "wq": ParamDef((d, q_dim), ("embed", "qkv"), init="scaled"),
        "wk": ParamDef((d, kv_dim), ("embed", "qkv"), init="scaled"),
        "wv": ParamDef((d, kv_dim), ("embed", "qkv"), init="scaled"),
        "wo": ParamDef((q_dim, d), ("qkv", "embed"), init="scaled",
                       scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cross:
        defs["gate"] = ParamDef((1,), (None,), init="zeros")
    return defs


def mlp_def(cfg: ModelConfig, d_ff: int | None = None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w1": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "w3": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "w2": ParamDef((f, d), ("ffn", "embed"), init="scaled",
                       scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def embedding_def(cfg: ModelConfig):
    return {"w": ParamDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed")}


# ---------------------------------------------------------------------------
# forward fns
# ---------------------------------------------------------------------------


def rmsnorm(x, p, cfg: ModelConfig):
    return ops.rmsnorm(x.contiguous(), p["w"], eps=cfg.norm_eps,
                       gemma_style=cfg.gemma_style)


def _table(p, cfg: ModelConfig):
    """The embedding table; tied, each use's gradient comes back in the
    table's own layout (``grad_like``), so that the two can be added."""
    return grad_like(p["w"]) if cfg.tie_embeddings else p["w"]


def embed(tokens, p, cfg: ModelConfig):
    x = F.embedding(tokens, _table(p, cfg)).to(cfg.cdtype())
    if cfg.gemma_style:
        x = x * math.sqrt(cfg.d_model)
    # "res_seq" is the residual stream's sequence axis: bound to "model"
    # it makes the layers sequence-parallel
    return shard_as(x, "batch", "res_seq", "embed")


def unembed(x, p, cfg: ModelConfig):
    return shard_as(x @ _table(p, cfg).to(x.dtype).t(), "batch", "seq", "vocab")


def rope_freqs(positions, head_dim: int, theta: float):
    """positions (...,) -> cos, sin (..., head_dim // 2), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, H, S, D); cos/sin (S, D/2) or (B, S, D/2). Rotate-half convention."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_shift(x, delta: int, theta: float):
    """Re-rotate already-roped keys by ``delta`` positions (StreamingLLM's
    pos_shift): rope is a rotation per pair, so keys roped at position p
    and rotated by ``delta`` are the keys a fresh rope at p + delta gives,
    up to float rounding. A window roll moves the kept keys toward 0 with
    ``delta = -rolled_tokens`` and never recomputes K. The angles come
    from :func:`rope_freqs`, the table prefill ropes with.

    x: (..., D) roped keys, any leading axes; delta: an int."""
    cos, sin = rope_freqs(torch.tensor(delta, device=x.device), x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _split_heads(x, n_heads, head_dim):
    B, S, _ = x.shape
    x = gather_unless_divides(x, -1, n_heads)
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    B, H, S, D = x.shape
    return gather_grad_unless_divides(x.transpose(1, 2).reshape(B, S, H * D), -1, H)


def paged_decode_step(block_tables, pos, pos_offset, page: int):
    """Where one token of every slot lands in the pool, and the kernel's
    KV length: (page id (B,), in-page offset (B,), kv_len (B,)). ``pos``
    is a (B,) int32 tensor or one int for all slots; ``pos_offset`` a
    (B,) tensor or None. Computed once per step and shared by every
    layer."""
    if not torch.is_tensor(pos):
        pos = torch.full((block_tables.shape[0],), pos, dtype=torch.int32,
                         device=block_tables.device)
    spos = pos if pos_offset is None else pos - pos_offset   # slot space
    pid = torch.gather(block_tables, 1, (spos // page).long()[:, None])[:, 0]
    return pid.long(), (spos % page).long(), pos + 1


def decode_kv_len(pos, batch: int, device):
    """The decode kernel's (B,) int32 KV length for a step at ``pos``
    (an int for every slot, or a (B,) tensor): one past the written
    position. Made once per step and shared by every layer."""
    if torch.is_tensor(pos):
        return (pos + 1).to(torch.int32)
    return torch.full((batch,), pos + 1, dtype=torch.int32, device=device)


def update_cache_at(buf, new, idx, axis: int):
    """Write ``new`` into ``buf`` in place at position ``idx`` along
    ``axis``. ``idx`` is an int (the same position for every row) or a
    (B,) tensor (per-slot positions; ``buf`` and ``new`` lead with the
    batch axis), as the JAX package's ``update_cache_at`` takes it. A
    start past ``size - n`` is clamped to it, as ``dynamic_update_slice``
    clamps (a drafter's steps past the end of its cache)."""
    n, size = new.shape[axis], buf.shape[axis]
    if not torch.is_tensor(idx):
        buf.narrow(axis, min(max(idx, 0), size - n), n).copy_(new)
        return buf
    start = idx.long().clamp(0, size - n)
    pos = start[:, None] + torch.arange(n, device=buf.device)             # (B, n)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf.movedim(axis, 1)[rows, pos] = new.movedim(axis, 1).to(buf.dtype)
    return buf


def attention(x, p, cfg: ModelConfig, *, positions, cache=None, cache_index=None,
              chunked=False, block_tables=None, pos_offset=None,
              paged_step=None, kv_len=None, context=None):
    """GQA attention (the modes of the JAX package's ``layers.attention``):

      * cross (``context`` (B, Sc, d_model) given, no cache): K/V from the
        context, no rope and no causal mask, through
        ``ops.flash_attention(causal=False)`` -- the whisper encoder
        (``context`` is x itself: bidirectional) and the decoder's cross
        attention over the encoder output in the training forward.
      * cache-free (``cache`` None): causal attention over x through
        ``ops.flash_attention`` -- the training forward.
      * whole-prompt prefill (contiguous ``(ck, cv)``, S > 1, not
        ``chunked``): K/V written at 0, causal ``ops.flash_attention``
        over the prompt.
      * paged decode (``block_tables`` given, S == 1): ``cache`` is the
        layer's pool pages (P, Hkv, page, D); the token's K/V is written
        at ``paged_step`` (from :func:`paged_decode_step`) and the slots
        attend through their block tables. Parked slots all write to the
        trash page 0, offset 0 -- duplicate writes in an undefined order,
        harmless because page 0 is never read unmasked.
      * paged chunked prefill (``block_tables`` (1, n_pages), S > 1,
        ``cache_index`` an int): the chunk lies inside one page
        (``chunk_plan``) and is written there; it attends to the gathered
        view of the slot's pages.
      * paged verify window (``block_tables`` (B, n_pages), S > 1,
        ``cache_index`` a (B,) tensor): speculative decoding's window of
        S tokens per slot, which may cross a page. Each (slot, position)
        is scattered to its own (page id, offset); a position past the
        slot's mapped pages goes to the trash page 0. It attends to the
        gathered view of the slot's pages (``chunk_attention``), at
        per-slot offsets.
      * contiguous decode (S == 1): cache (B, Hkv, S_max, D) written at
        ``cache_index`` -- an int, or a (B,) tensor of per-slot positions
        (the continuous batcher's splice path); ``kv_len`` (B,) int32 is
        ``cache_index + 1``, made once per step by the caller
        (:func:`decode_kv_len`).
      * contiguous chunked prefill (S > 1, ``chunked``), at an int or
        per-slot ``cache_index``.

    Params with a ``gate`` (tanh-gated cross-attention) scale the output
    by ``tanh(gate)``.

    A quantized pool arrives as ``(ck, cv, ks, vs)``: int8/fp8 pages and
    their (P, Hkv, page) float32 scales. Both paged modes quantize the
    new K/V (``ops.quantize_kv``, one scale per position) and write codes
    and scales in place; decode attends through the quantized kernel,
    prefill and the verify window over the gathered, dequantized view.

    An unquantized pool or cache must be in the compute dtype: a cast
    here would copy the layer's whole cache on every call.
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    if context is not None:
        if cache is not None:
            raise ValueError("cross-attention takes no cache: pass its K/V instead")
        return cross_attention(x, p, cfg, *cross_kv(context, p, cfg))
    q = _split_heads(_matmul(x, p["wq"], cfg), H, Dh)
    k = _split_heads(_matmul(x, p["wk"], cfg), Hkv, Dh)
    v = _split_heads(_matmul(x, p["wv"], cfg), Hkv, Dh)
    if cfg.use_rope:
        cos, sin = rope_freqs(positions, Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shard_as(q, "batch", "heads", "seq", None)
    k = shard_as(k, "batch", "kv_heads", "kv_seq", None)
    v = shard_as(v, "batch", "kv_heads", "kv_seq", None)

    if cache is None:
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=True)
        return _attn_out(out, p, cfg)

    ck, cv, *qs = cache
    ks, vs = qs or (None, None)
    quant = ks is not None
    if quant:
        if block_tables is None or ops.kv_qmax(ck.dtype) is None:
            raise TypeError(f"scales come with quantized page pools only, got "
                            f"{ck.dtype} {'pages' if block_tables is not None else 'cache'}")
    elif ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"KV cache dtype {ck.dtype} differs from the compute "
                        f"dtype {q.dtype}")
    if block_tables is not None:
        page = ck.shape[2]
        if S == 1:
            pid, off, kl = paged_step
            if quant:
                # one quantization for K and V together: (2, B, Hkv, D)
                kvq, kvs = ops.quantize_kv(torch.stack((k[:, :, 0], v[:, :, 0])),
                                           ck.dtype)
                ck[pid, :, off, :], cv[pid, :, off, :] = kvq[0], kvq[1]
                ks[pid, :, off], vs[pid, :, off] = kvs[0], kvs[1]
            else:
                ck[pid, :, off, :] = k[:, :, 0, :]
                cv[pid, :, off, :] = v[:, :, 0, :]
            out = ops.paged_attention(q.contiguous(), ck, cv,
                                      block_tables=block_tables, kv_len=kl,
                                      pos_offset=pos_offset,
                                      k_scales=ks, v_scales=vs)
        elif isinstance(cache_index, int) and chunked and B == 1:
            si = cache_index - (pos_offset or 0)
            o = si % page
            if o + S > page:
                raise ValueError(f"prefill chunk [{si}, {si + S}) crosses a page")
            pid = block_tables[0, si // page:si // page + 1].long()
            if quant:
                kvq, kvs = ops.quantize_kv(torch.stack((k, v)), ck.dtype)
                ck[pid, :, o:o + S, :], cv[pid, :, o:o + S, :] = kvq[0], kvq[1]
                ks[pid, :, o:o + S], vs[pid, :, o:o + S] = kvs[0], kvs[1]
                gk = ops.gather_dequant_kv_pages(ck, ks, block_tables)
                gv = ops.gather_dequant_kv_pages(cv, vs, block_tables)
            else:
                ck[pid, :, o:o + S, :] = k
                cv[pid, :, o:o + S, :] = v
                gk = ops.gather_kv_pages(ck, block_tables)
                gv = ops.gather_kv_pages(cv, block_tables)
            out = ops.chunk_attention(q, gk, gv, q_offset=si, kv_len=si + S)
        else:
            pos = torch.as_tensor(cache_index, device=q.device).reshape(-1).expand(B)
            spos = pos if pos_offset is None else pos - pos_offset
            pos2d = spos.long()[:, None] + torch.arange(S, device=q.device)   # (B, S)
            npg = block_tables.shape[1]
            valid = (pos2d // page) < npg
            pid = torch.gather(block_tables, 1, (pos2d // page).clamp(max=npg - 1)).long()
            pid = torch.where(valid, pid, 0)
            off = torch.where(valid, pos2d % page, 0)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)               # (B, S, Hkv, D)
            if quant:
                kvq, kvs = ops.quantize_kv(torch.stack((kt, vt)), ck.dtype)
                ck[pid, :, off, :], cv[pid, :, off, :] = kvq[0], kvq[1]
                ks[pid, :, off], vs[pid, :, off] = kvs[0], kvs[1]
                gk = ops.gather_dequant_kv_pages(ck, ks, block_tables)
                gv = ops.gather_dequant_kv_pages(cv, vs, block_tables)
            else:
                ck[pid, :, off, :] = kt
                cv[pid, :, off, :] = vt
                gk = ops.gather_kv_pages(ck, block_tables)
                gv = ops.gather_kv_pages(cv, block_tables)
            out = ops.chunk_attention(q, gk, gv, q_offset=spos, kv_len=spos + S)
    elif S == 1:
        update_cache_at(ck, k, cache_index, axis=2)
        update_cache_at(cv, v, cache_index, axis=2)
        out = ops.decode_attention(q.contiguous(), ck, cv, kv_len=kv_len)
    elif chunked:
        update_cache_at(ck, k, cache_index, axis=2)
        update_cache_at(cv, v, cache_index, axis=2)
        out = ops.chunk_attention(q, ck, cv, q_offset=cache_index,
                                  kv_len=cache_index + S)
    else:
        update_cache_at(ck, k, 0, axis=2)
        update_cache_at(cv, v, 0, axis=2)
        out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=True)

    return _attn_out(out, p, cfg)


def cross_kv(context, p, cfg: ModelConfig):
    """K and V (B, Hkv, Sc, D) of attention params ``p`` over ``context``
    (B, Sc, d_model): no rope."""
    return (_split_heads(_matmul(context, p["wk"], cfg), cfg.n_kv_heads, cfg.head_dim),
            _split_heads(_matmul(context, p["wv"], cfg), cfg.n_kv_heads, cfg.head_dim))


def cross_attention(x, p, cfg: ModelConfig, k, v):
    """x's queries over context K/V (B, Hkv, Sc, D): no rope and no mask
    (non-causal ``ops.flash_attention``), scaled by ``tanh(gate)`` where
    ``p`` has a gate."""
    q = shard_as(_split_heads(_matmul(x, p["wq"], cfg), cfg.n_heads, cfg.head_dim),
                 "batch", "heads", "seq", None)
    k = shard_as(k.to(q.dtype), "batch", "kv_heads", "kv_seq", None)
    v = shard_as(v.to(q.dtype), "batch", "kv_heads", "kv_seq", None)
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    return _attn_out(out, p, cfg)


def _attn_out(out, p, cfg: ModelConfig):
    """The heads merged and projected by ``wo``, scaled by tanh(gate) for
    gated cross-attention params."""
    y = _matmul(_merge_heads(out), p["wo"], cfg)
    if "gate" in p:
        y = torch.tanh(p["gate"].to(y.dtype)) * y
    return shard_as(y, "batch", "res_seq", "embed")


def _matmul(x, w, cfg: ModelConfig):
    """Dense matmul, or W4A16 through ``ops.awq_matmul`` for a quantized
    node ``{"qw", "scales", "zeros"}`` (AWQ layout; the group size is
    K over the scales' rows, as the JAX package infers it)."""
    if isinstance(w, dict) and "qw" in w:
        K = w["qw"].shape[-2] * 8                      # 8 nibbles per int32
        out = ops.awq_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["qw"],
                             w["scales"], w["zeros"], bits=4,
                             group_size=K // w["scales"].shape[-2])
        return out.reshape(*x.shape[:-1], -1)
    return x @ w.to(x.dtype)


def mlp(x, p, cfg: ModelConfig, act: str | None = None):
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    a = act or cfg.act
    h1 = shard_as(_matmul(x, p["w1"], cfg), "batch", "seq", "ffn")
    h3 = shard_as(_matmul(x, p["w3"], cfg), "batch", "seq", "ffn")
    if a == "silu":
        h = F.silu(h1) * h3
    elif a == "gelu":
        h = F.gelu(h1, approximate="tanh") * h3
    else:
        raise ValueError(a)
    return shard_as(_matmul(h, p["w2"], cfg), "batch", "res_seq", "embed")
