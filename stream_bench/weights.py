"""The benchmark's weights: every value is a function of (seed, parameter
name, block index), so the program's copy and the reference's copy are
made apart and never read from each other.

A parameter of shape ``(*lead, m, n)`` is made in blocks, one per index
of ``lead`` (a layer, or a layer and an expert); a vector is one block.
Each block is drawn by ``normal_`` on the device, in the served dtype,
from a generator seeded by a hash of (seed, name, index): the reference
remakes any block by itself, in the same dtype on the same device, and
casts it to float32.
"""

from __future__ import annotations

import hashlib
import itertools

import torch


def block_seed(seed: int, name: str, idx: tuple) -> int:
    h = hashlib.sha256(f"{int(seed)}/{name}/{','.join(map(str, idx))}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def block_indices(shape: tuple):
    """The block indices of a parameter: every index of its leading axes."""
    lead = shape[:-2] if len(shape) >= 2 else ()
    return itertools.product(*(range(n) for n in lead))


class Weights:
    """``layout``: name -> (shape, mean, std), as the reference's
    ``layout(model)`` gives it."""

    def __init__(self, layout: dict, seed: int, dtype, device):
        self.layout = layout
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)

    def block(self, name: str, idx: tuple = ()) -> torch.Tensor:
        """One block in the served dtype."""
        shape, mean, std = self.layout[name]
        tail = shape[len(idx):]
        g = torch.Generator(device=self.device)
        g.manual_seed(block_seed(self.seed, name, idx))
        return torch.empty(tail, dtype=self.dtype, device=self.device).normal_(
            mean, std, generator=g)

    def get(self, name: str, idx: tuple = ()) -> torch.Tensor:
        """The reference's float32 copy of a block (``idx`` may index
        into it further than the block's own leading axes)."""
        shape = self.layout[name][0]
        nlead = len(shape) - 2 if len(shape) >= 2 else 0
        t = self.block(name, tuple(idx[:nlead])).float()
        return t[tuple(idx[nlead:])] if len(idx) > nlead else t

    @torch.no_grad()
    def write_into(self, named: dict):
        """Overwrite the program's parameters (name -> tensor, the names
        and shapes of ``layout``) in place, block by block."""
        names, want = set(named), set(self.layout)
        if names != want:
            raise ValueError(f"parameter names differ from the reference's layout: "
                             f"program only {sorted(names - want)}, "
                             f"reference only {sorted(want - names)}")
        for name, t in named.items():
            shape = tuple(self.layout[name][0])
            if tuple(t.shape) != shape or t.dtype != self.dtype:
                raise ValueError(f"{name}: program {tuple(t.shape)} {t.dtype}, "
                                 f"reference {shape} {self.dtype}")
            for idx in block_indices(shape):
                t[idx].copy_(self.block(name, idx))
