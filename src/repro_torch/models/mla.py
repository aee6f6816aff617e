"""Multi-head Latent Attention (DeepSeek-V2): the JAX package's
``models/mla.py``.

The KV cache stores only the compressed latent c_kv (kv_lora_rank) plus
the shared rope key (qk_rope_head_dim) per position. Two decode paths:

  * naive: expand K_nope and V from the latent every step; K =
    [K_nope, K_rope] and V zero-padded to the same width D = qk_nope +
    qk_rope run through ``ops.decode_attention`` (decode),
    ``ops.chunk_attention`` (chunks) or ``ops.flash_attention`` (whole
    prompts and training), with scale 1 / sqrt(D) passed explicitly. On
    a CUDA tensor those are the hand-written kernels, built for MLA's
    D = 192 (and the smoke configs' D = 24);
  * absorbed (``mla_absorbed_decode``): fold W_uk into the query and
    W_uv into the output, so decode attends against the latent directly
    (plain einsum in float32, as the reference).

Caches are written in place, as in ``layers.attention``: ``cache`` is
the layer's ``(c_kv, k_rope)`` -- views into the contiguous cache or the
page pool -- plus, for an int8 / fp8 pool, their float32 scale sidecars
``(cc, cr, cs, rs)``. The function returns y only.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.local_shards import einsum
from repro_torch.distributed.sharding import (gather_grad_unless_divides,
                                              gather_unless_divides, shard_as)
from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamDef
from repro_torch.models.layers import _matmul, apply_rope, rope_freqs, update_cache_at


def mla_def(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale_o = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": ParamDef((d, H * (dn + dr)), ("embed", "qkv"), init="scaled"),
        "wdkv": ParamDef((d, r), ("embed", None), init="scaled"),
        "wkr": ParamDef((d, dr), ("embed", None), init="scaled"),
        "kv_norm": ParamDef((r,), (None,), init="ones"),
        "wuk": ParamDef((r, H * dn), (None, "qkv"), init="scaled"),
        "wuv": ParamDef((r, H * dv), (None, "qkv"), init="scaled"),
        "wo": ParamDef((H * dv, d), ("qkv", "embed"), init="scaled", scale=scale_o),
    }


def _norm(x, w, eps):
    """The latent's own RMS norm, in float32 (not the rmsnorm kernel, as
    in the reference)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _paged_step(block_tables, pos, pos_offset, page: int):
    """Where one token of every slot lands in a latent pool, and the
    slot-space KV length of the gathered view: (page id (B,), in-page
    offset (B,), kv_len (B,)). Made once per step and shared by every
    layer."""
    if not torch.is_tensor(pos):
        pos = torch.full((block_tables.shape[0],), pos, dtype=torch.int32,
                         device=block_tables.device)
    spos = pos if pos_offset is None else pos - pos_offset
    pid = torch.gather(block_tables, 1, (spos // page).long()[:, None])[:, 0]
    return pid.long(), (spos % page).long(), (spos + 1).to(torch.int32)


def mla_attention(x, p, cfg: ModelConfig, *, positions, cache=None, cache_index=None,
                  absorbed: bool = False, chunked: bool = False,
                  block_tables=None, pos_offset=None, paged_step=None, kv_len=None):
    """x (B, S, D) -> y (B, S, D). The reference's modes:

      * no cache: causal attention over x (training forward);
      * contiguous ``(c_kv (B, Smax, r), k_rope (B, Smax, dr))``: decode
        (S == 1) at ``cache_index`` (an int or per-slot (B,) tensor;
        ``kv_len`` (B,) int32 is cache_index + 1, made once per step by
        the caller), a chunk (``chunked``) at ``cache_index``, or a whole
        prompt written at 0 that attends only to itself;
      * paged pools ``(P, page, r)`` / ``(P, page, dr)`` through
        ``block_tables``: decode (S == 1; ``paged_step`` from
        :func:`_paged_step`, computed here when None), a prefill
        chunk (B == 1, an int ``cache_index``, inside one page) and the
        speculative verify window (per-(slot, position) scatter, stray
        positions past the table to the trash page 0). Writes and masks
        run in slot space, ``cache_index - pos_offset``.

    A quantized pool quantizes each new latent and rope key over its
    feature axis (``ops.quantize_kv``) and reads the gathered view back
    dequantized, cast to the compute dtype.
    """
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    q = gather_unless_divides(x @ p["wq"].to(x.dtype), -1, H)
    q = q.reshape(B, S, H, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    c_kv = _norm(x @ p["wdkv"].to(x.dtype), p["kv_norm"], cfg.norm_eps)         # (B, S, r)
    k_rope = apply_rope((x @ p["wkr"].to(x.dtype))[:, None], cos, sin)[:, 0]     # (B, S, dr)

    q_off = cache_index
    if cache is not None and block_tables is not None:
        cc, cr, *qs = cache
        cs, rs = qs or (None, None)
        quant = cs is not None
        page = cc.shape[1]

        def write(pid, off, ckv, krope):
            if quant:
                cq, csc = ops.quantize_kv(ckv, cc.dtype)
                rq, rsc = ops.quantize_kv(krope, cr.dtype)
                cc[pid, off], cr[pid, off] = cq, rq
                cs[pid, off], rs[pid, off] = csc, rsc
            else:
                cc[pid, off] = ckv.to(cc.dtype)
                cr[pid, off] = krope.to(cr.dtype)

        if S == 1:
            pid, off, kv_len = (paged_step if paged_step is not None else
                                _paged_step(block_tables, cache_index, pos_offset, page))
            write(pid, off, c_kv[:, 0], k_rope[:, 0])
        elif not torch.is_tensor(cache_index):
            # a prefill chunk: chunk_plan keeps it inside one page
            assert chunked and B == 1
            si = cache_index - int(pos_offset or 0)
            o = si % page
            if o + S > page:
                raise ValueError(f"prefill chunk [{si}, {si + S}) crosses a page")
            pid = block_tables[0, si // page].long()
            write(pid, slice(o, o + S), c_kv[0], k_rope[0])
            kv_len, q_off = si + S, si
        else:
            # the verify window: per-token scatter at per-slot positions
            pos = cache_index.reshape(-1).expand(B)
            spos = pos if pos_offset is None else pos - pos_offset
            pos2d = spos.long()[:, None] + torch.arange(S, device=x.device)      # (B, S)
            npg = block_tables.shape[1]
            valid = (pos2d // page) < npg
            pid = torch.gather(block_tables, 1, (pos2d // page).clamp(max=npg - 1)).long()
            pid = torch.where(valid, pid, 0)
            off = torch.where(valid, pos2d % page, 0)
            write(pid, off, c_kv, k_rope)
            kv_len, q_off = spos + S, spos
        if quant:
            kv_latent = ops.gather_dequant_kv_pages(cc, cs, block_tables).to(x.dtype)
            k_rope_all = ops.gather_dequant_kv_pages(cr, rs, block_tables).to(x.dtype)
        else:
            kv_latent = ops.gather_kv_pages(cc, block_tables).to(x.dtype)
            k_rope_all = ops.gather_kv_pages(cr, block_tables).to(x.dtype)
    elif cache is not None:
        cc, cr = cache
        at = cache_index if (S == 1 or chunked) else 0
        update_cache_at(cc, c_kv, at, axis=1)
        update_cache_at(cr, k_rope, at, axis=1)
        if S == 1:
            kv_latent, k_rope_all = cc.to(x.dtype), cr.to(x.dtype)
            if kv_len is None:
                kv_len = cache_index + 1
        elif chunked:
            kv_latent, k_rope_all = cc.to(x.dtype), cr.to(x.dtype)
            kv_len = cache_index + S
        else:   # whole prompt: attend the fresh latents (the cache tail is junk)
            kv_latent, k_rope_all = c_kv, k_rope
            kv_len = None
    else:
        kv_latent, k_rope_all = c_kv, k_rope
        kv_len = None
    kv_latent = shard_as(kv_latent, "batch", "kv_seq", None)
    Skv = kv_latent.shape[1]

    if absorbed and S == 1:
        wuk = p["wuk"].to(x.dtype).reshape(r, H, dn)
        q_lat = einsum("bhsd,rhd->bhsr", q_nope, wuk)                   # (B, H, 1, r)
        lat_k = kv_latent[:, None].float()                                     # (B, 1, Skv, r)
        rope_k = k_rope_all[:, None].float()
        logits = (einsum("bhsr,bokr->bhsk", q_lat.float(), lat_k)
                  + einsum("bhsd,bokd->bhsk", q_rope.float(), rope_k)) * scale
        if kv_len is not None:
            kl = torch.as_tensor(kv_len, device=x.device)
            if kl.dim():
                kl = kl.reshape(-1, 1, 1, 1)
            mask = torch.arange(Skv, device=x.device)[None, None, None, :] < kl
            logits = torch.where(mask, logits, -1e30)
        pr = torch.softmax(logits, dim=-1)
        ctx = einsum("bhsk,bokr->bhsr", pr, lat_k)                         # (B, H, 1, r)
        wuv = p["wuv"].float().reshape(r, H, dv)
        out = einsum("bhsr,rhd->bhsd", ctx, wuv).to(x.dtype)
    else:
        k_nope = gather_unless_divides(_latent_up(kv_latent, p["wuk"].to(x.dtype)), -1, H)
        k_nope = k_nope.reshape(B, Skv, H, dn).transpose(1, 2)
        vv = gather_unless_divides(_latent_up(kv_latent, p["wuv"].to(x.dtype)), -1, H)
        vv = vv.reshape(B, Skv, H, dv).transpose(1, 2)
        k_full = torch.cat([k_nope, k_rope_all[:, None].expand(B, H, Skv, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        v_full = _pad_v(vv, dn + dr)
        if cache is not None and S == 1:
            out = ops.decode_attention(q_full, k_full, v_full, kv_len=kv_len, scale=scale)
        elif cache is not None and chunked:
            out = ops.chunk_attention(q_full, k_full, v_full, q_offset=q_off,
                                      kv_len=kv_len, scale=scale)
        else:
            out = ops.flash_attention(q_full, k_full, v_full, causal=True, scale=scale)
        out = out[..., :dv]

    out = gather_grad_unless_divides(out.transpose(1, 2).reshape(B, S, H * dv), -1, H)
    y = _matmul(out, p["wo"], cfg)
    return shard_as(y, "batch", "seq", "embed")


def _latent_up(kv_latent, w):
    """kv_latent (B, S, r) @ w (r, n); on DTensors each device multiplies
    its own batch and sequence shards (``local_shards.einsum``: torch
    2.11 cannot fold two split dims into one matmul row dim)."""
    if isinstance(kv_latent, DTensor):
        return einsum("bsr,rn->bsn", kv_latent, w)
    return kv_latent @ w


def _pad_v(v, d_target):
    """V (B, H, S, dv) zero-padded on its last axis to ``d_target``
    (contiguous): the caller slices the output back to dv."""
    pad = d_target - v.shape[-1]
    if pad <= 0:
        return v.contiguous()
    # a concatenation, not F.pad: DTensor's padding strategy in torch 2.11
    # drops a mesh dim from the placements
    return torch.cat([v, v.new_zeros(*v.shape[:-1], pad)], dim=-1)
