"""Paged decode attention over a shared KV page pool: the hand-written
Hopper kernel (``csrc/attention.cu``, paged addressing) and its plain
PyTorch version.

Replaces the JAX package's Pallas ``kernels/paged_attention.py::
paged_attention`` (unquantized body ``_paged_kernel``). One block per
(slot, kv head) walks only the slot's live pages through its block-table
row; see the source for the design. A CPU tensor takes the plain
version; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention as plain

launches = 0

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_SMEM_LIMIT = 48 * 1024      # static limit without a dynamic-smem opt-in


@functools.cache
def check_smem(G: int, D: int, tile: int):
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
                    logit_soft_cap: float = 0.0, pos_offset=None):
    """q (B, Hq, 1, D); k_pages, v_pages (P, Hkv, page, D) of q's dtype;
    block_tables (B, n_pages) int32; kv_len, pos_offset int or (B,)
    -> (B, Hq, 1, D)."""
    global launches
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables=block_tables, kv_len=kv_len,
                     scale=scale, logit_soft_cap=logit_soft_cap, pos_offset=pos_offset)
    B, Hq, Sq, D = q.shape
    P, Hkv, page, Dk = k_pages.shape
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or Dk != D or v_pages.shape != k_pages.shape or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("pool pages must be in q's dtype (quantized pages are "
                        "not ported yet)")
    if block_tables.dtype != torch.int32 or block_tables.shape[0] != B:
        raise TypeError("block_tables must be (B, n_pages) int32")
    for t in (q, k_pages, v_pages, block_tables):
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
        block_tables.data_ptr(), kv_len.data_ptr(), pos_offset.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, D, page, block_tables.shape[1],
        float(scale), float(logit_soft_cap), _build.dtype_code(q),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention")
    launches += 1
    return out
