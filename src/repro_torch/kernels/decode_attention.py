"""Single-token decode attention against a contiguous per-slot cache:
the hand-written Hopper kernel (``csrc/decode_attention.cu``) and its
plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/decode_attention.py::
decode_attention`` (``_dec_kernel``). A block takes
``heads_per_block(G)`` query heads of one kv head; the kernel splits the
keys of each (slot, kv head, head group) over the card's SMs by the plan
of ``splits``, one thread block cluster a (slot, kv head, head group),
and merges the splits' float32 partials through the cluster's
distributed shared memory; see the source for the design. A CPU tensor takes the plain version; ``launches`` counts kernel
launches. It has no gradient: where autograd would record it, it raises
(``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import as_lengths
from repro_torch.kernels.ref import decode_attention as plain

launches = 0
MIN_KEYS = 16                # keys a split holds at least, where S has them
MAX_SPLITS = 8               # splits of one (slot, kv head): one cluster, 8 blocks at most
BLOCKS_PER_SM = 2            # the plan aims at least at this many blocks per SM
HEAD_DIMS = (8, 16, 24, 64, 112, 128, 192, 256)

# csrc/decode_attention.cu's DecodeArgs, passed as one block (a ctypes
# call costs per argument): 5 pointers, 8 ints, 2 floats, an int, padding,
# the stream
_PACK = struct.Struct("<5Q8i2fi4xQ")


def heads_per_block(G: int) -> int:
    """Query heads one block takes (the kernel is built for 1, 2, 4, 8):
    all G up to 8 where it is one of those, else the largest of 8, 4, 2
    that divides G (granite-20b's G = 48: six blocks of 8). A lane keeps
    heads x (its 4 to 8 values of D) accumulators and as many query
    values in registers, so a block takes at most 8."""
    for gb in (8, 4, 2):
        if G % gb == 0:
            return gb
    return 1


@functools.cache
def splits(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """The split plan: (n_split, chunk). The keys [0, S) of each of the
    B * Hkv rows -- (slot, kv head, head group) rows, Hkv standing for the
    kv heads times their head groups -- are cut into n_split <= MAX_SPLITS
    ranges of ``chunk`` positions (the last range is what is left), each
    of at least MIN_KEYS keys where S has them, so that the B * Hkv *
    n_split blocks come to about
    BLOCKS_PER_SM a SM, and to at least ``n_sm`` where those caps allow.
    ``chunk = ceil(S / n)`` cuts S into exactly n ranges: the shortfall
    n * chunk - S is below n <= MAX_SPLITS < MIN_KEYS <= chunk. (More,
    shorter splits cost more in the cluster's merge than they save at
    B * Hkv of 64 and more: measured on the H100, PERF.md.)"""
    want = -(-BLOCKS_PER_SM * n_sm // (B * Hkv))
    n = min(want, MAX_SPLITS, max(1, S // MIN_KEYS))
    return n, -(-S // n)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, *, kv_len, scale=None, logit_soft_cap: float = 0.0):
    """q (B, Hq, 1, D); k, v (B, Hkv, S, D) of q's dtype; kv_len int or
    (B,) -> (B, Hq, 1, D)."""
    global launches
    _build.refuse_grad("decode_attention", q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, kv_len=kv_len, scale=scale, logit_soft_cap=logit_soft_cap)
    B, Hq, Sq, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or Bk != B or Dk != D or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel is built for D in {HEAD_DIMS}, "
                         f"got D={D}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must be in q's dtype")
    for t in (q, k, v):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention kernel needs contiguous, 16-byte aligned "
                             "tensors on one device")
    dtype = _build.dtype_code(q)
    kv_len = as_lengths(kv_len, B, dev)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    gb = heads_per_block(Hq // Hkv)
    n_split, chunk = splits(B, Hq // gb, S, _sm_count(dev.index))
    args = _PACK.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                      out.data_ptr(), B, Hq, Hkv, S, D, n_split, chunk, gb, scale,
                      logit_soft_cap, dtype, _build.raw_stream(dev))
    err = _build.bind("decode_attention", "decode_attention_launch", (ctypes.c_char_p,))(
        args)
    _build.check(err, f"decode_attention ({n_split} splits of {chunk} keys, {gb} query "
                      "heads a block)")
    launches += 1
    return out
