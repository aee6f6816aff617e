"""W4A16 grouped-dequant matmul (AWQ layout): the hand-written Hopper
kernel (``csrc/awq_matmul.cu``) and its plain PyTorch versions.

Replaces the JAX package's Pallas ``kernels/awq_matmul.py::awq_matmul``
(``_awq_kernel``). The int4 codes stay packed in device memory. The
kernel factors the dequantization out of the product, per group,
``s * (x @ q - z * sum(x))`` (``plain_grouped`` is that formulation in
plain float32): the bf16 body multiplies raw codes on tensor cores, in
the K order of ``k_order``; the float32 body on CUDA cores. Its plan
(``splits``) cuts K into at most 8 ranges of whole groups, one thread
block cluster a column tile, merged in one launch. Groups are multiples
of 64 up to 512. A CPU tensor takes the plain version (``plain``, the
reference's formula); ``launches`` counts kernel launches. It has no
gradient: where autograd would record it, it raises
(``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import torch

from repro_torch.distributed import local_shards
from repro_torch.kernels import _build
from repro_torch.kernels.ref import awq_matmul as plain
from repro_torch.kernels.ref import awq_unpack

launches = 0
SLAB = 64                    # K rows a pipeline stage holds; groups are whole slabs
MAX_GROUP = 512
MAX_SPLITS = 8               # K ranges of one column tile: one cluster, 8 blocks at most
BLOCKS_PER_SM = 4            # the plan aims at this many blocks a SM
COL_TILES = (128, 64)        # columns a block, widest first

# csrc/awq_matmul.cu's AwqArgs, passed as one block (a ctypes call costs
# per argument): 5 pointers, 9 ints, 4 bytes of padding, the stream
_PACK = struct.Struct("<5Q9i4xQ")


class Plan(NamedTuple):
    bn: int                  # columns a block
    mt: int                  # rows a tile (the mma's 16, or 8 when M <= 8)
    n_split: int             # K ranges a column tile: the cluster's size
    groups_per_split: int    # groups a range (the last takes what is left)


@functools.cache
def splits(M: int, K: int, N: int, group: int, n_sm: int) -> Plan:
    """The launch plan. Rows go in tiles of ``mt``; columns in tiles of
    ``bn``; the groups of K in ``n_split`` ranges of ``groups_per_split``
    (every range non-empty). The split count is the largest, up to
    MAX_SPLITS and the group count, that keeps the grid within
    BLOCKS_PER_SM blocks a SM; the tile width is the one whose grid comes
    closest to that aim, the wider on a tie. Raises where the kernel does
    not take the group."""
    if group <= 0 or group % SLAB or group > MAX_GROUP or K <= 0 or K % group:
        raise ValueError(f"awq_matmul kernel does not take group_size={group} at K={K}: "
                         f"a multiple of {SLAB} up to {MAX_GROUP} that divides K")
    mt = 8 if M <= 8 else 16
    row_tiles = -(-M // mt)
    groups = K // group
    aim = BLOCKS_PER_SM * n_sm
    best = None
    for bn in COL_TILES:
        tiles = -(-N // bn) * row_tiles
        want = min(MAX_SPLITS, groups, max(1, aim // tiles))
        per = -(-groups // want)
        plan = Plan(bn, mt, -(-groups // per), per)
        score = min(aim, tiles * plan.n_split)
        if best is None or score > best[0]:
            best = (score, plan)
    return best[1]


def k_order(group: int) -> list[int]:
    """The K row each tensor-core slot takes, in the bf16 body's order,
    within one group: per 64-row slab, per 32-row block b, per k16 step s,
    slot j of the mma's 16. Lane t of a quad holds slots 2t, 2t + 1, 2t + 8
    and 2t + 9, fed from one packed word (rows 8t .. 8t + 7 of the block)
    unpacked in nibble pairs (0, 4), (1, 5), (2, 6), (3, 7): so slot j of
    step s is row 8 (j % 8 // 2) + 2 s + j // 8 + 4 (j % 2). The A
    fragments take x's columns in the same order."""
    return [slab + 32 * b + 8 * (j % 8 // 2) + 2 * s + j // 8 + 4 * (j % 2)
            for slab in range(0, group, SLAB) for b in (0, 1) for s in (0, 1)
            for j in range(16)]


def plain_grouped(x, qw, scales, zeros, *, group_size: int = 128):
    """The kernel's formulation in plain float32: per group,
    ``s * (x @ q - z * sum(x))``, summed over the groups, cast once to x's
    dtype. The same function as ``plain``, with the dequantization
    factored out of the product."""
    M, K = x.shape
    G = K // group_size
    q = awq_unpack(qw).float().reshape(G, group_size, -1)
    xg = x.float().reshape(M, G, group_size)
    xq = torch.einsum("mgk,gkn->mgn", xg, q)
    sx = xg.sum(-1)[..., None]
    return ((xq - zeros.float() * sx) * scales.float()).sum(1).to(x.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_launch = None               # the bound C function, once the library is loaded


def awq_matmul(x, qw, scales, zeros, *, bits: int = 4, group_size: int = 128):
    """x (M, K) float32/bfloat16; qw (K/8, N) int32; scales, zeros
    (K/group_size, N) float32 -> (M, N) in x's dtype."""
    global launches, _launch
    local_shards.refuse_dtensor("awq_matmul", x, qw, scales, zeros)
    _build.refuse_grad("awq_matmul", x, scales, zeros)
    if _build.runs_plain(x):
        return plain(x, qw, scales, zeros, bits=bits, group_size=group_size)
    if not x.is_cuda:
        raise ValueError(f"awq_matmul kernel needs CUDA tensors, got {x.device}")
    if bits != 4:
        raise ValueError(f"awq_matmul kernel takes 4-bit codes, got bits={bits}")
    M, K = x.shape
    N = qw.shape[1]
    if K % group_size:
        raise ValueError(f"K={K} is not a multiple of group_size={group_size}")
    if qw.shape != (K // 8, N) or qw.dtype != torch.int32:
        raise TypeError(f"qw must be ({K // 8}, {N}) int32, got "
                        f"{tuple(qw.shape)} {qw.dtype}")
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t.shape != (K // group_size, N) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be ({K // group_size}, {N}) float32, got "
                            f"{tuple(t.shape)} {t.dtype}")
    dev = x.get_device()
    for t in (x, qw, scales, zeros):
        if t.get_device() != dev or not t.is_contiguous():
            raise ValueError("awq_matmul kernel needs contiguous tensors on one device")
    dtype = _build.dtype_code(x)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    p = splits(M, K, N, group_size, _sm_count(dev))
    if x.data_ptr() % 16:                      # the kernel reads x in 16-byte vectors
        x = x.clone()
    if _launch is None:
        _launch = _build.bind("awq_matmul", "awq_matmul_launch", (ctypes.c_char_p,))
    err = _launch(_PACK.pack(x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                             zeros.data_ptr(), out.data_ptr(), M, K, N, group_size, p.mt,
                             p.bn, p.n_split, p.groups_per_split, dtype,
                             _build.raw_stream(x.device)))
    if err:
        _build.check(err, f"awq_matmul ({M}, {K}, {N}) group {group_size}, plan {p}")
    launches += 1
    return out
