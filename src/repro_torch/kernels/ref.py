"""Plain PyTorch versions of the port's kernels.

These are the port's semantic ground truth, one for one with the JAX
package's ``kernels/ref.py``: the CPU path runs them, the CPU tests hold
them against the reference, and ``chip_smoke.py`` holds every hand
kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed.local_shards import einsum

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
    q_offset: optional int or (B,) tensor; absolute position of q[0] for
    the causal mask (default Skv - Sq).
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    qf = q.float().reshape(B, Hkv, G, Sq, D)
    logits = einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if logit_soft_cap > 0.0:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)

    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((1, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        off = q_offset if q_offset is not None else Skv - Sq
        if torch.is_tensor(off):            # per-slot offsets (B,)
            qpos = (off.reshape(-1, 1, 1, 1, 1)
                    + torch.arange(Sq, device=q.device).reshape(1, 1, 1, Sq, 1))
            mask = mask & (kpos.reshape(1, 1, 1, 1, Skv) <= qpos)
        else:
            qpos = torch.arange(Sq, device=q.device) + off
            mask = mask & (kpos[None, :] <= qpos[:, None])
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1, 1, 1)
        mask = mask & (kpos.reshape(1, 1, 1, 1, Skv) < kl)

    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def mha_chunked(q, k, v, *, causal: bool = True, scale=None,
                logit_soft_cap: float = 0.0, chunk_q: int = 512):
    """Exact attention in query chunks: the (Sq, Skv) score matrix never
    exists beyond (chunk_q, Skv). Chunk i's causal offset is
    ``i * chunk_q + (Skv - Sq)``."""
    Sq, Skv = q.shape[2], k.shape[2]
    if Sq <= chunk_q:
        return mha(q, k, v, causal=causal, scale=scale, logit_soft_cap=logit_soft_cap)
    return torch.cat([
        mha(q[:, :, s:s + chunk_q], k, v, causal=causal,
            q_offset=s + Skv - Sq if causal else None, scale=scale,
            logit_soft_cap=logit_soft_cap)
        for s in range(0, Sq, chunk_q)], dim=2)


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


# ---------------------------------------------------------------------------
# KV quantization (int8 / fp8 paged pools)
# ---------------------------------------------------------------------------


def kv_qmax(dtype):
    """Max representable magnitude for a quantized-KV storage dtype, or
    ``None`` if ``dtype`` is not a quantized KV format."""
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return 448.0
    return None


def quantize_kv(x, dtype):
    """Symmetric per-vector amax quantization over the last axis.

    x (..., D) any float dtype -> (q, scale): ``q`` is ``x`` stored in
    ``dtype`` (int8 or float8_e4m3fn), ``scale`` (...,) float32 with
    ``dequantize_kv(q, scale) ~= x``. All-zero vectors get scale 0 and
    quantize to exact zeros. Divides by the safe scale (never multiplies
    by its reciprocal), so the codes are the JAX package's bit for bit.
    """
    qmax = kv_qmax(dtype)
    if qmax is None:
        raise TypeError(f"not a quantized KV dtype: {dtype}")
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = xf / safe[..., None]
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8), scale
    return y.to(dtype), scale


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv`: (..., D) codes + (...,) scales
    -> float32 (..., D)."""
    return q.float() * scale[..., None].float()


def gather_dequant_kv_pages(pages, scales, block_tables):
    """Gather quantized pool pages (P, Hkv, page, D) and their f32 scale
    sidecar (P, Hkv, page) into the contiguous per-slot view
    (B, Hkv, n_pages * page, D), dequantized to float32."""
    g = gather_kv_pages(pages, block_tables)
    s = gather_kv_pages(scales[..., None], block_tables)
    return g.float() * s.float()


def paged_attention(q, k_pages, v_pages, *, block_tables, kv_len, scale=None,
                    logit_soft_cap: float = 0.0, pos_offset=None,
                    k_scales=None, v_scales=None):
    """Paged decode attention: gather the block-table rows into the
    contiguous (B, Hkv, S, D) view, then run decode attention. The
    slot-space KV length is ``kv_len - pos_offset``. With ``k_scales``/
    ``v_scales`` ((P, Hkv, page) float32) the pages are int8/fp8 codes,
    dequantized as ``code * scale`` with the math in float32."""
    kv_len = torch.as_tensor(kv_len, device=q.device)
    if pos_offset is not None:
        kv_len = kv_len - torch.as_tensor(pos_offset, device=q.device)
    if k_scales is not None:
        k = gather_dequant_kv_pages(k_pages, k_scales, block_tables)
        v = gather_dequant_kv_pages(v_pages, v_scales, block_tables)
    else:
        k = gather_kv_pages(k_pages, block_tables).to(q.dtype)
        v = gather_kv_pages(v_pages, block_tables).to(q.dtype)
    return decode_attention(q, k, v, kv_len=kv_len, scale=scale,
                            logit_soft_cap=logit_soft_cap)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (chunked scan)
# ---------------------------------------------------------------------------


def _segsum(logd):
    """Log-space segment sums: out[..., t, s] = sum_{r=s+1..t} logd[..., r].
    logd (..., L) -> (..., L, L), -inf above the diagonal."""
    L = logd.shape[-1]
    c = torch.cumsum(logd, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=logd.device))
    return torch.where(mask, diff, float("-inf"))


def ssd(x, dt, A, B, C, D, *, chunk: int = 64, h0=None):
    """Mamba-2 state-space duality (chunked) forward, float32 inside.

    x (b, T, H, P); dt (b, T, H) positive step sizes; A (H,) negative
    decay rates; B, C (b, T, N) shared across heads; D (H,) skip; h0
    optional (b, H, P, N) initial state. T must be a multiple of
    ``chunk``. Returns y (b, T, H, P) in x's dtype and the final state
    (b, H, P, N) float32. The chunk-to-chunk recurrence runs in order
    (the JAX package uses an associative scan: equal up to rounding).
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    nc = T // chunk
    dtf = dt.float()
    logd = dtf * A.float()[None, None, :]                        # (b, T, H)
    xc = x.float().reshape(b, nc, chunk, H, P)
    dtc = dtf.reshape(b, nc, chunk, H)
    Bc = B.float().reshape(b, nc, chunk, N)
    Cc = C.float().reshape(b, nc, chunk, N)

    # intra-chunk (quadratic, attention-like)
    ld_t = logd.reshape(b, nc, chunk, H).movedim(-1, -2)        # (b, nc, H, L)
    G = torch.exp(_segsum(ld_t))                                # (b, nc, H, L, L)
    CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)                # (b, nc, L, L)
    dts = dtc.movedim(-1, -2)                                   # (b, nc, H, L)
    M = CB[:, :, None] * G * dts[..., None, :]
    y_intra = torch.einsum("bchts,bcshp->bcthp", M, xc)

    # chunk states and the recurrence H_c = a_c * H_{c-1} + S_c
    cum = torch.cumsum(ld_t, dim=-1)                            # (b, nc, H, L)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    S = torch.einsum("bchs,bcsh,bcsn,bcshp->bchpn", decay_to_end, dtc, Bc, xc)
    a = torch.exp(cum[..., -1])                                 # (b, nc, H)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = a[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                         # (b, nc, H, P, N)

    # inter-chunk contribution: decay from the chunk start, own step included
    y_inter = torch.einsum("bctn,bcht,bchpn->bcthp", Cc, torch.exp(cum), h_prev)
    y = y_intra + y_inter + D.float()[None, None, None, :, None] * xc
    return y.reshape(b, T, H, P).to(x.dtype), h


def ssd_step(x, dt, A, B, C, D, h):
    """Single-token SSD recurrence (decode): x (b, H, P), dt (b, H), B, C
    (b, N), h (b, H, P, N) float32 -> y (b, H, P) in x's dtype, new h."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])                    # (b, H)
    xB = torch.einsum("bhp,bn->bhpn", x.float() * dtf[..., None], B.float())
    h_new = dA[..., None, None] * h + xB
    y = torch.einsum("bn,bhpn->bhp", C.float(), h_new)
    y = y + D.float()[None, :, None] * x.float()
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# AWQ-style W4A16 grouped-dequant matmul
# ---------------------------------------------------------------------------


def awq_pack(w_int, bits: int = 4):
    """Pack int weights (K, N), values in [0, 2^bits), into int32
    (K // pack, N), nibble i of a word holding row ``pack * r + i``."""
    pack = 32 // bits
    K, N = w_int.shape
    if K % pack:
        raise ValueError(f"K={K} is not a multiple of {pack}")
    w = w_int.to(torch.int64).reshape(K // pack, pack, N)
    out = torch.zeros((K // pack, N), dtype=torch.int64, device=w_int.device)
    for i in range(pack):
        out |= w[:, i, :] << (bits * i)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def awq_unpack(qw, bits: int = 4):
    """Unpack int32 (K // pack, N) -> int32 (K, N) in [0, 2^bits)."""
    pack = 32 // bits
    Kp, N = qw.shape
    u = qw.to(torch.int64) & 0xFFFFFFFF
    parts = [(u >> (bits * i)) & ((1 << bits) - 1) for i in range(pack)]
    return torch.stack(parts, dim=1).reshape(Kp * pack, N).to(torch.int32)


def awq_matmul(x, qw, scales, zeros, *, bits: int = 4, group_size: int = 128):
    """x (M, K) @ dequant(qw) -> (M, N) in x's dtype; qw packed int32
    (K // (32 / bits), N), scales and zeros (K // group_size, N):
    w = (q - z) * s per group, accumulated in float32."""
    K = x.shape[-1]
    w_int = awq_unpack(qw, bits)
    g = torch.arange(K, device=x.device) // group_size
    w = (w_int.float() - zeros.float()[g]) * scales.float()[g]
    return (x.float() @ w).to(x.dtype)
