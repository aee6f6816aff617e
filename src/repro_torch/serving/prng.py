"""Threefry-2x32 keys and draws, bit for bit as the JAX package's
``jax.random`` computes them (default ``threefry2x32`` implementation,
``jax_threefry_partitionable`` on, 32-bit seeds).

A key is a pair ``(k1, k2)`` of uint32 values. The functions take Python
ints, numpy int64 arrays or torch int64 tensors alike: uint32 arithmetic
is carried in 64-bit integers and masked to 32 bits after every add and
shift (``torch.uint32`` has thin op coverage), so the same code derives
keys on the host and draws the random bits of a whole batch on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of counts (x1, x2)
    under key (k1, k2), elementwise with broadcasting."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed) -> tuple:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    return 0, seed & MASK


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the cipher of counts (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (partitionable): key i is the
    cipher of counts (0, i)."""
    b1, b2 = threefry2x32(np.int64(key[0]), np.int64(key[1]), 0,
                          np.arange(num, dtype=np.int64))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def random_bits(k1, k2, n: int):
    """32-bit ``jax.random.bits`` of shape (n,) for each key: k1, k2 are
    (B,) int64 tensors -> (B, n) int64 tensor of uint32 values."""
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], 0, counts)
    return b1 ^ b2


def gumbel(k1, k2, n: int):
    """``jax.random.gumbel`` (mode "low", float32) of shape (n,) per key:
    uniform in [tiny, 1) from the top 23 bits, then -log(-log(u))."""
    bits = random_bits(k1, k2, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def categorical(k1, k2, logits):
    """``vmap(jax.random.categorical)(keys, logits)`` for (B, V) float32
    logits and (B,) keys: the Gumbel-max draw, (B,) int64."""
    return torch.argmax(gumbel(k1, k2, logits.shape[-1]) + logits, dim=-1)
