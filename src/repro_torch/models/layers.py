"""Core transformer layers of the dense path: norms, rope, embeddings,
GQA attention, gated MLP.

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

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamDef

# ---------------------------------------------------------------------------
# defs
# ---------------------------------------------------------------------------


def rmsnorm_def(d_model: int, gemma_style: bool = False):
    return {"w": ParamDef((d_model,), ("embed",), init="zeros" if gemma_style else "ones")}


def attention_def(cfg: ModelConfig):
    """Standard (non-MLA) GQA attention parameter defs."""
    d, q_dim, kv_dim = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": ParamDef((d, q_dim), ("embed", "qkv"), init="scaled"),
        "wk": ParamDef((d, kv_dim), ("embed", "qkv"), init="scaled"),
        "wv": ParamDef((d, kv_dim), ("embed", "qkv"), init="scaled"),
        "wo": ParamDef((q_dim, d), ("qkv", "embed"), init="scaled",
                       scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


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


def embed(tokens, p, cfg: ModelConfig):
    x = p["w"][tokens].to(cfg.cdtype())
    if cfg.gemma_style:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(x, p, cfg: ModelConfig):
    return x @ p["w"].to(x.dtype).t()


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


def _split_heads(x, n_heads, head_dim):
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


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


def attention(x, p, cfg: ModelConfig, *, positions, cache, cache_index,
              chunked=False, block_tables=None, pos_offset=None,
              paged_step=None, kv_len=None):
    """GQA attention against a KV cache (the serving modes of the JAX
    package's ``layers.attention``):

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
      * contiguous decode (S == 1, int ``cache_index``): cache (B, Hkv,
        S_max, D) written at ``cache_index``; ``kv_len`` (B,) int32 is
        ``cache_index + 1``, made once per step by the caller.
      * contiguous chunked prefill (S > 1, ``chunked``).

    The pool or cache must be in the compute dtype: a cast here would
    copy the layer's whole cache on every call.
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = _split_heads(_matmul(x, p["wq"], cfg), H, Dh)
    k = _split_heads(_matmul(x, p["wk"], cfg), Hkv, Dh)
    v = _split_heads(_matmul(x, p["wv"], cfg), Hkv, Dh)
    if cfg.use_rope:
        cos, sin = rope_freqs(positions, Dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    ck, cv = cache
    if ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"KV cache dtype {ck.dtype} differs from the compute "
                        f"dtype {q.dtype}")
    if block_tables is not None:
        page = ck.shape[2]
        if S == 1:
            pid, off, kl = paged_step
            ck[pid, :, off, :] = k[:, :, 0, :]
            cv[pid, :, off, :] = v[:, :, 0, :]
            out = ops.paged_attention(q.contiguous(), ck, cv,
                                      block_tables=block_tables, kv_len=kl,
                                      pos_offset=pos_offset)
        elif isinstance(cache_index, int) and chunked and B == 1:
            si = cache_index - (pos_offset or 0)
            o = si % page
            if o + S > page:
                raise ValueError(f"prefill chunk [{si}, {si + S}) crosses a page")
            pid = block_tables[0, si // page:si // page + 1].long()
            ck[pid, :, o:o + S, :] = k
            cv[pid, :, o:o + S, :] = v
            gk = ops.gather_kv_pages(ck, block_tables)
            gv = ops.gather_kv_pages(cv, block_tables)
            out = ops.chunk_attention(q, gk, gv, q_offset=si, kv_len=si + S)
        else:
            raise NotImplementedError(
                "paged multi-token windows (speculative verify) are not ported yet")
    elif not isinstance(cache_index, int):
        raise NotImplementedError("per-slot contiguous positions are not ported yet")
    elif S == 1:
        ck[:, :, cache_index, :] = k[:, :, 0, :]
        cv[:, :, cache_index, :] = v[:, :, 0, :]
        out = ops.decode_attention(q.contiguous(), ck, cv, kv_len=kv_len)
    elif chunked:
        ck[:, :, cache_index:cache_index + S, :] = k
        cv[:, :, cache_index:cache_index + S, :] = v
        out = ops.chunk_attention(q, ck, cv, q_offset=cache_index,
                                  kv_len=cache_index + S)
    else:
        raise NotImplementedError("whole-prompt prefill (flash_attention) is "
                                  "not ported yet; serving prefills in chunks")

    return _matmul(_merge_heads(out), p["wo"], cfg)


def _matmul(x, w, cfg: ModelConfig):
    """Dense matmul; the W4A16 AWQ dict form is not ported yet."""
    if isinstance(w, dict):
        raise NotImplementedError("W4A16 (awq_matmul) weights are not ported yet")
    return x @ w.to(x.dtype)


def mlp(x, p, cfg: ModelConfig, act: str | None = None):
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    a = act or cfg.act
    h1 = _matmul(x, p["w1"], cfg)
    h3 = _matmul(x, p["w3"], cfg)
    if a == "silu":
        h = F.silu(h1) * h3
    elif a == "gelu":
        h = F.gelu(h1, approximate="tanh") * h3
    else:
        raise ValueError(a)
    return _matmul(h, p["w2"], cfg)
