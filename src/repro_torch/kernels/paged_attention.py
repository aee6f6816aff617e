"""Paged decode attention over a shared KV page pool: the hand-written
Hopper kernel (``csrc/attention.cu``, paged addressing) and its plain
PyTorch version.

Replaces the JAX package's Pallas ``kernels/paged_attention.py::
paged_attention``: the unquantized body ``_paged_kernel`` for pages in
q's dtype, and the quantized body ``_paged_kernel_quant`` for int8 or
float8_e4m3fn pages with float32 per-position scales, dequantized in
registers. One block per (slot, kv head) walks only the slot's live
pages through its block-table row; see the source for the design. A CPU
tensor takes the plain version; ``launches`` counts launches of the
unquantized body and ``launches_quant`` those of the quantized body.
It has no gradient: where autograd would record it, it raises
(``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention as plain

launches = 0
launches_quant = 0

KV_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}

_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_SMEM_LIMIT = 48 * 1024      # static limit without a dynamic-smem opt-in


@functools.cache
def check_smem(G: int, D: int, tile: int):
    """The kernel stages every tile as float32, whatever the page type,
    so one layout covers unquantized and quantized pools."""
    smem = _build.bind("attention", "attention_smem_bytes",
                       (ctypes.c_int,) * 3, ctypes.c_size_t)(G, D, tile)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention kernel needs {smem} B of shared memory "
                         f"for G={G}, D={D}, tile={tile}; limit {_SMEM_LIMIT}")


def as_lengths(x, B: int, device) -> torch.Tensor:
    """int or (B,) -> a contiguous (B,) int32 tensor on ``device``."""
    if (torch.is_tensor(x) and x.dtype == torch.int32 and x.shape == (B,)
            and x.device == device and x.is_contiguous()):
        return x                            # the serving path's case: no op
    t = torch.as_tensor(x, device=device)
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t.reshape(-1).expand(B).contiguous()


def paged_attention(q, k_pages, v_pages, *, block_tables, kv_len, scale=None,
                    logit_soft_cap: float = 0.0, pos_offset=None,
                    k_scales=None, v_scales=None):
    """q (B, Hq, 1, D); k_pages, v_pages (P, Hkv, page, D) of q's dtype,
    or int8 / float8_e4m3fn codes with ``k_scales``, ``v_scales``
    (P, Hkv, page) float32; block_tables (B, n_pages) int32; kv_len,
    pos_offset int or (B,) -> (B, Hq, 1, D)."""
    global launches, launches_quant
    _build.refuse_grad("paged_attention", q, k_pages, v_pages, k_scales, v_scales)
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables=block_tables, kv_len=kv_len,
                     scale=scale, logit_soft_cap=logit_soft_cap, pos_offset=pos_offset,
                     k_scales=k_scales, v_scales=v_scales)
    B, Hq, Sq, D = q.shape
    P, Hkv, page, Dk = k_pages.shape
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    quant = k_scales is not None or v_scales is not None
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"k pages {k_pages.dtype} and v pages {v_pages.dtype} differ")
    if not quant and k_pages.dtype != q.dtype:
        raise TypeError(f"pages of {k_pages.dtype} need q's dtype {q.dtype}, or "
                        "k_scales and v_scales for int8/fp8 codes")
    if quant:
        if k_pages.dtype not in KV_CODES:
            raise TypeError(f"scales given for {k_pages.dtype} pages; quantized "
                            "pages are int8 or float8_e4m3fn")
        for s in (k_scales, v_scales):
            if s is None or s.dtype != torch.float32 or s.shape != (P, Hkv, page):
                raise TypeError(f"k_scales and v_scales must both be ({P}, {Hkv}, "
                                f"{page}) float32")
    if block_tables.dtype != torch.int32 or block_tables.shape[0] != B:
        raise TypeError("block_tables must be (B, n_pages) int32")
    for t in (q, k_pages, v_pages, block_tables) + ((k_scales, v_scales) if quant else ()):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("paged_attention kernel needs contiguous tensors "
                             "on one device")
    check_smem(Hq // Hkv, D, page)
    kv_len = as_lengths(kv_len, B, dev)
    pos_offset = as_lengths(0 if pos_offset is None else pos_offset, B, dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    err = _build.bind("attention", "paged_attention_launch", _ARGS)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
        block_tables.data_ptr(), kv_len.data_ptr(), pos_offset.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, page, block_tables.shape[1], float(scale),
        float(logit_soft_cap), _build.dtype_code(q),
        KV_CODES[k_pages.dtype] if quant else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention")
    if quant:
        launches_quant += 1
    else:
        launches += 1
    return out
