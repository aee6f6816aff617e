"""PagePool -- shared device-resident KV page memory, paged part.

A fixed budget of fixed-size pages resident on the device, which the
radix-tree prefix cache (:mod:`repro_torch.serving.prefix_cache`) maps to
token-id page keys, and which the continuous batcher's decode reads
directly through per-slot block tables.

Layout comes from the model's ``cache_specs()``
(:meth:`repro_torch.models.common.LeafLayout.pool_shape`): k
``(L, B, Hkv, S, D)`` pools as ``(L, P, Hkv, page, D)``. The buffers are
allocated once and written in place by the model's paged attention: in
the model's compute dtype (``kv_dtype="fp32"``), or as int8 / fp8 e4m3
codes (``KV_DTYPES``) with a float32 scale per (layer, page, kv head,
position) in a sidecar of the pool's shape minus its last axis, handed
out as the cache key ``"<leaf>_qscale"``.

**Page id 0 is the reserved trash page.** Finished slots are parked at
position 0 with an all-zero block-table row, so their dead (masked,
never read) decode writes land on page 0. ``alloc`` never hands out
page 0 and ``free`` rejects it.

The copying movement of the JAX package (``store_pages``/``load`` and
``SlotSplicer``, the splice path of stateful models) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.models.common import cache_layout, has_state_leaves

TRASH_PAGE = 0

# kv_dtype axis: how "kv_seq" pool leaves are stored. "fp32" keeps the
# model's compute dtype; the quantized modes store the narrow dtype plus
# the float32 scale sidecar.
KV_DTYPES = {
    "fp32": None,
    "int8": torch.int8,
    "fp8_e4m3": torch.float8_e4m3fn,
}


def kv_storage(kv_dtype: str):
    """The narrow dtype of ``kv_dtype``'s pages (None: the compute
    dtype); an unknown ``kv_dtype`` is refused."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {sorted(KV_DTYPES)}, "
                         f"got {kv_dtype!r}")
    return KV_DTYPES[kv_dtype]


@dataclass
class PoolStats:
    """Point-in-time pool pressure counters (host side)."""
    capacity: int        # allocatable pages
    occupancy: int       # pages currently allocated
    high_water: int      # max pages ever simultaneously allocated

    @property
    def occupancy_frac(self) -> float:
        return self.occupancy / max(self.capacity, 1)

    @property
    def high_water_frac(self) -> float:
        return self.high_water / max(self.capacity, 1)


def chunk_plan(n_cached: int, n_total: int, page: int) -> list[int]:
    """Deterministic page-aligned prefill decomposition of the token
    range ``[n_cached, n_total)``: one chunk per page up to the last full
    page, then the sub-page tail in descending powers of two. Chunk
    boundaries depend only on absolute position, so cold prefill and a
    prefix-hit resume compute every shared position over identical
    extents, and every chunk lies inside one page."""
    if n_cached % page:
        raise ValueError(f"n_cached={n_cached} is not page-aligned (page={page})")
    pieces = []
    pos = n_cached
    last_page = (n_total // page) * page
    while pos < last_page:
        pieces.append(page)
        pos += page
    rem = n_total - max(pos, n_cached)
    while rem > 0:
        p = 1 << (rem.bit_length() - 1)      # largest power of two <= rem
        pieces.append(p)
        rem -= p
    return pieces


class PagePool:
    """Fixed budget of device-resident KV pages for one model.

    ``capacity`` allocatable pages of ``page`` tokens each (the buffers
    hold ``capacity + 1`` entries; index 0 is the reserved trash page).
    """

    def __init__(self, model, *, page: int = 16, capacity: int = 256,
                 kv_dtype: str = "fp32", device="cpu"):
        qdt = kv_storage(kv_dtype)
        self.page = page
        self.capacity = capacity
        self.kv_dtype = kv_dtype
        self.layout = cache_layout(model.cache_specs())
        self.stateful = has_state_leaves(self.layout)
        template = model.init_cache(1, page, device="meta")
        self._paged: dict[str, torch.Tensor] = {}
        for name, lay in self.layout.items():
            if lay.paged:
                leaf = template[name]
                shape = lay.pool_shape(leaf.shape, page, capacity + 1)
                self._paged[name] = torch.zeros(
                    shape, dtype=qdt or leaf.dtype, device=device)
                if qdt is not None:
                    self._paged[f"{name}_qscale"] = torch.zeros(
                        shape[:-1], dtype=torch.float32, device=device)
        # device bytes held, sidecars included
        self.pool_bytes = sum(t.numel() * t.element_size()
                              for t in self._paged.values())
        self._free = list(range(capacity, 0, -1))   # never hands out page 0
        self._free_set = set(self._free)
        self.high_water = 0
        self._detached = False
        # Release-ordering guard: the prefix cache registers "does the tree
        # still reference this page"; free() asserts it is False.
        self.free_guard: Optional[Callable[[int], bool]] = None
        # device bytes moved by copies; the paged path moves none
        self.bytes_copied = 0

    # ------------------------------------------------------------ allocator
    def occupancy(self) -> int:
        """Pages currently allocated (capacity minus the free list)."""
        return self.capacity - len(self._free)

    def stats(self) -> PoolStats:
        return PoolStats(capacity=self.capacity, occupancy=self.occupancy(),
                         high_water=self.high_water)

    def alloc(self) -> Optional[int]:
        """One free page id, or None when the pool is exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._free_set.discard(pid)
        occ = self.capacity - len(self._free)
        if occ > self.high_water:
            self.high_water = occ
        return pid

    def free(self, pid: int):
        assert pid != TRASH_PAGE, "page 0 is the reserved trash page"
        assert pid not in self._free_set, f"double free of page {pid}"
        assert self.free_guard is None or not self.free_guard(pid), (
            f"release-ordering violation: freeing page {pid} while the "
            "prefix tree still references it")
        self._free_set.add(pid)
        self._free.append(pid)

    # ------------------------------------------------------------ paged view
    def paged_cache(self, batch: int, max_pages: int) -> dict:
        """Zero-copy decode cache over the pool buffers for a ``batch``-
        slot batcher: every "kv_seq" leaf is its pool buffer (with its
        ``"<leaf>_qscale"`` sidecar in a quantized pool), plus per-slot
        ``block_tables`` (batch, max_pages) int32, ``pos`` and
        ``pos_offset`` (batch,) int32. Hands the buffers to the caller."""
        if self.stateful:
            raise NotImplementedError("paged decode requires a stateless cache")
        if self._detached:
            raise RuntimeError("pool buffers already handed out")
        some = next(iter(self._paged.values()))
        dev = some.device
        cache = dict(self._paged)
        cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        cache["pos_offset"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        cache["block_tables"] = torch.zeros((batch, max_pages), dtype=torch.int32,
                                            device=dev)
        self._detached = True
        return cache
