"""Plain PyTorch versions of the kernels on the serving path.

These are the port's semantic ground truth, one for one with the JAX
package's ``kernels/ref.py``: the CPU path runs them, the CPU tests hold
them against the reference, and ``chip_smoke.py`` holds every hand
kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rmsnorm(x, w, *, eps: float = 1e-5, gemma_style: bool = False):
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma_style else w.float()
    return (y * scale).to(dt)


def mha(q, k, v, *, causal: bool = True, kv_len=None, q_offset=None,
        scale=None, logit_soft_cap: float = 0.0):
    """Grouped-query attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0.
    kv_len: optional int or (B,) tensor; key positions >= kv_len are masked.
    q_offset: optional int; absolute position of q[0] for the causal mask
    (default Skv - Sq).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Hkv, G, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if logit_soft_cap > 0.0:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)

    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((1, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        off = q_offset if q_offset is not None else Skv - Sq
        qpos = torch.arange(Sq, device=q.device) + off
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1, 1)
        mask = mask & (kpos.reshape(1, 1, 1, 1, Skv) < kl)

    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def decode_attention(q, k, v, *, kv_len, scale=None, logit_soft_cap: float = 0.0):
    """Single-token decode attention: q (B, Hq, 1, D) against a cache."""
    return mha(q, k, v, causal=False, kv_len=kv_len, scale=scale,
               logit_soft_cap=logit_soft_cap)


def gather_kv_pages(pages, block_tables):
    """Pool pages (P, Hkv, page, D) + tables (B, n_pages) -> the slot's
    contiguous view (B, Hkv, n_pages * page, D), in token order (garbage
    beyond the slot's kv_len; the caller masks)."""
    page = pages.shape[-2]
    B, n = block_tables.shape
    g = pages[block_tables.long()]              # (B, n, *mid, page, last)
    g = torch.movedim(g, 1, -3)                 # (B, *mid, n, page, last)
    return g.reshape(*g.shape[:-3], n * page, g.shape[-1])


def paged_attention(q, k_pages, v_pages, *, block_tables, kv_len, scale=None,
                    logit_soft_cap: float = 0.0, pos_offset=None):
    """Paged decode attention: gather the block-table rows into the
    contiguous (B, Hkv, S, D) view, then run decode attention. The
    slot-space KV length is ``kv_len - pos_offset``."""
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if pos_offset is not None:
        kv_len = kv_len - torch.as_tensor(pos_offset, device=q.device)
    k = gather_kv_pages(k_pages, block_tables).to(q.dtype)
    v = gather_kv_pages(v_pages, block_tables).to(q.dtype)
    return decode_attention(q, k, v, kv_len=kv_len, scale=scale,
                            logit_soft_cap=logit_soft_cap)
