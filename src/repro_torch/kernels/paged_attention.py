"""Paged decode attention over a shared KV page pool: the hand-written
Hopper kernel (``csrc/paged_attention.cuh``, instantiated by
``csrc/attention.cu`` over pages in q's type and by
``csrc/attention_quant.cu`` over int8/fp8 codes) and its plain PyTorch
version.

Replaces the JAX package's Pallas ``kernels/paged_attention.py::
paged_attention``: the unquantized body ``_paged_kernel`` for pages in
q's dtype, and the quantized body ``_paged_kernel_quant`` for int8 or
float8_e4m3fn pages with float32 per-position scales, dequantized in
registers. The kernel splits the keys of each (slot, kv head) into
ranges of whole pages by the plan of ``splits``, made from the pool's
addressable length (the table width), one thread block cluster a (slot,
kv head, head group), and merges the splits' float32 partials through
the cluster's distributed shared memory; only live pages are read. See
the source for the design. A CPU tensor takes the plain version;
``launches`` counts launches over unquantized pages and
``launches_quant`` those over int8/fp8 codes. It has no gradient: where
autograd would record it, it raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from repro_torch.distributed import local_shards
from repro_torch.distributed.sharding import gather_unless_divides
from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention as plain

launches = 0
launches_quant = 0

KV_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}
HEAD_DIMS = (8, 16, 112, 128, 256)
GROUPS = (1, 2, 4, 6, 8, 48)   # query heads per kv head the kernel takes
MAX_SPLITS = 8                 # splits of one (slot, kv head): one cluster, 8 blocks at most
BLOCKS_PER_SM = 2              # the plan aims at least at this many blocks per SM

# csrc/paged_attention.cuh's PagedArgs, passed as one block (a ctypes call costs
# per argument): 9 pointers, 11 ints, 2 floats, padding, the stream
_PACK = struct.Struct("<9Q11i2f4xQ")


def heads_per_block(G: int, quant: bool) -> int:
    """Query heads one block takes: all G up to 8 (6 and 8 only over
    pages in q's dtype), else the largest of 8, 4, 2 that divides G. Over
    int8/fp8 codes a lane holds 16 values of q and of its sum per head, so
    a block takes at most 4 heads."""
    for gb in ((4, 2, 1) if quant else (8, 6, 4, 2, 1)):
        if G % gb == 0:
            return gb
    return 1


@functools.cache
def splits(B: int, blocks: int, n_pages: int, page: int, n_sm: int) -> tuple[int, int]:
    """The split plan: (n_split, chunk). The addressable keys [0, n_pages *
    page) of each of the B * ``blocks`` (slot, kv head, head group) rows
    are cut into n_split <= MAX_SPLITS ranges of ``chunk`` positions, a
    whole number of pages each (the last range is what is left, never
    empty), so that the B * blocks * n_split blocks come to about
    BLOCKS_PER_SM a SM where the pages allow. Made from the table's width,
    never from kv_len: a split whose range starts at or past a slot's live
    length computes nothing and weighs zero in the merge."""
    want = -(-BLOCKS_PER_SM * n_sm // (B * blocks))
    n = min(want, MAX_SPLITS, n_pages)
    per = -(-n_pages // n)
    return -(-n_pages // per), per * page


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    local_shards.refuse_dtensor("paged_attention", q, k_pages, v_pages, k_scales, v_scales)
    _build.refuse_grad("paged_attention", q, k_pages, v_pages, k_scales, v_scales)
    dev = q.device
    if _build.runs_plain(q):
        # on DTensors (the dry-run) the plain version runs as DTensor ops:
        # q's heads are gathered where their split cannot group them by kv head
        q = gather_unless_divides(q, 1, k_pages.shape[1])
        return plain(q, k_pages, v_pages, block_tables=block_tables, kv_len=kv_len,
                     scale=scale, logit_soft_cap=logit_soft_cap, pos_offset=pos_offset,
                     k_scales=k_scales, v_scales=v_scales)
    B, Hq, Sq, D = q.shape
    P, Hkv, page, Dk = k_pages.shape
    if dev.type != "cuda":
        raise ValueError(f"paged_attention kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or Dk != D or v_pages.shape != k_pages.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if D not in HEAD_DIMS or Hq // Hkv not in GROUPS:
        raise ValueError(f"paged_attention kernel is built for D in {HEAD_DIMS} and "
                         f"Hq / Hkv in {GROUPS}, got D={D}, Hq={Hq}, Hkv={Hkv}")
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
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise TypeError("block_tables must be (B, n_pages) int32")
    for t in (q, k_pages, v_pages, block_tables) + ((k_scales, v_scales) if quant else ()):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_attention kernel needs contiguous, 16-byte aligned "
                             "tensors on one device")
    kv_len = as_lengths(kv_len, B, dev)
    pos_offset = as_lengths(0 if pos_offset is None else pos_offset, B, dev)
    out = torch.empty_like(q)
    n_pages = block_tables.shape[1]
    if B == 0 or n_pages == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    gb = heads_per_block(Hq // Hkv, quant)
    n_split, chunk = splits(B, Hq // gb, n_pages, page, _sm_count(dev.index))
    args = _PACK.pack(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      k_scales.data_ptr() if quant else 0,
                      v_scales.data_ptr() if quant else 0, block_tables.data_ptr(),
                      kv_len.data_ptr(), pos_offset.data_ptr(), out.data_ptr(), B, Hq, Hkv,
                      D, page, n_pages, n_split, chunk, gb, _build.dtype_code(q),
                      KV_CODES[k_pages.dtype] if quant else 0, scale, logit_soft_cap,
                      _build.raw_stream(dev))
    lib, fn = (("attention_quant", "paged_attention_quant_launch") if quant
               else ("attention", "paged_attention_launch"))
    err = _build.bind(lib, fn, (ctypes.c_char_p,))(args)
    _build.check(err, f"paged_attention ({n_split} splits of {chunk} keys, {gb} query "
                      "heads a block)")
    if quant:
        launches_quant += 1
    else:
        launches += 1
    return out
