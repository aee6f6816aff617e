"""PagePool -- shared device-resident KV page memory.

A fixed budget of fixed-size pages resident on the device, which the
radix-tree prefix cache (:mod:`repro_torch.serving.prefix_cache`) maps to
token-id page keys, and which the continuous batcher's decode reads
directly through per-slot block tables (the native paged path) or copies
into and out of contiguous slot caches (the splice path of stateful
models).

Layout comes from the model's ``cache_specs()``
(:meth:`repro_torch.models.common.LeafLayout.pool_shape`): k
``(L, B, Hkv, S, D)`` pools as ``(L, P, Hkv, page, D)``. The buffers are
allocated once and written in place by the model's paged attention: in
the model's compute dtype (``kv_dtype="fp32"``), or as int8 / fp8 e4m3
codes (``KV_DTYPES``) with a float32 scale per (layer, page, kv head,
position) in a sidecar of the pool's shape minus its last axis, handed
out as the cache key ``"<leaf>_qscale"``.

For every *state* leaf (batch axis but no "kv_seq": the SSM and conv
states of a hybrid model) the pool holds a per-page snapshot of the
whole leaf, valid only at the exact token position it was taken: a
zamba2-7b page carries ~152 MB of state beside its 3 MB of K/V.

**Page id 0 is the reserved trash page.** Finished slots are parked at
position 0 with an all-zero block-table row, so their dead (masked,
never read) decode writes land on page 0. ``alloc`` never hands out
page 0 and ``free`` rejects it.

The copying movement (``store_pages``/``store_state``/``load``, and
``SlotSplicer`` for batch=1 -> slot splices) writes in place and counts
its bytes in ``bytes_copied``: the admission cost the paged path avoids.
It runs on compute-dtype pools only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.models.common import (LeafLayout, cache_layout, cache_leaf,
                                       has_state_leaves)

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SlotSplicer:
    """Batch=1 -> slot cache splice, shared by the contiguous admission
    path (stateful models, or a pool that cannot page) and
    ``ServingEngine.generate_batch``. Leaves with a "kv_seq" axis copy
    only their first ``used`` positions; batch-only leaves copy the whole
    slot slice; ``pos`` is set from the source's scalar. Writes the slot
    cache in place; ``bytes_copied`` accumulates the splice traffic."""

    def __init__(self, layout: dict[str, LeafLayout]):
        self.layout = layout
        self.bytes_copied = 0

    def __call__(self, cache: dict, one: dict, slot: int, used: int) -> dict:
        for name, lay in self.layout.items():
            if lay.batch_axis < 0:
                continue
            src = cache_leaf(one, name)
            dst = cache_leaf(cache, name).narrow(lay.batch_axis, slot, 1)
            sa = lay.seq_axis
            if sa >= 0 and used < src.shape[sa]:
                src, dst = src.narrow(sa, 0, used), dst.narrow(sa, 0, used)
            dst.copy_(src)
            self.bytes_copied += _nbytes(src)
        cache["pos"][slot] = int(one["pos"])
        return cache


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
        # per-page snapshots of each state leaf: (capacity + 1, *leaf
        # without its batch axis)
        self._state: dict[str, torch.Tensor] = {}
        self._page_bytes = 0         # device bytes one page spans (paged leaves)
        self._state_bytes = 0        # device bytes one state snapshot spans
        for name, lay in self.layout.items():
            leaf = cache_leaf(template, name) if lay.batch_axis >= 0 else None
            if lay.paged:
                shape = lay.pool_shape(leaf.shape, page, capacity + 1)
                self._paged[name] = torch.zeros(
                    shape, dtype=qdt or leaf.dtype, device=device)
                if qdt is not None:
                    self._paged[f"{name}_qscale"] = torch.zeros(
                        shape[:-1], dtype=torch.float32, device=device)
                self._page_bytes += _nbytes(leaf)
            elif lay.state:
                block = [n for d, n in enumerate(leaf.shape) if d != lay.batch_axis]
                self._state[name] = torch.zeros((capacity + 1, *block), dtype=leaf.dtype,
                                                device=device)
                self._state_bytes += _nbytes(leaf)
        # device bytes held, sidecars and state snapshots included
        self.pool_bytes = sum(_nbytes(t) for t in (*self._paged.values(),
                                                   *self._state.values()))
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
    def n_free(self) -> int:
        return len(self._free)

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

    # ------------------------------------------------------------ movement
    def _movable(self):
        if self._detached:
            raise RuntimeError("pool buffers are owned by the paged batcher")
        if self.kv_dtype != "fp32":
            raise RuntimeError("the copying splice path runs on compute-dtype pools "
                               "only; quantized pools are written in place by the "
                               "paged decode path")

    def store_pages(self, cache: dict, batch_idx: int, first_page: int, pids: list):
        """Copy ``len(pids)`` consecutive pages starting at page
        ``first_page`` (token positions ``[first_page * page, ...)``) of
        slot ``batch_idx`` of a contiguous ``cache`` into the pool pages
        ``pids`` -- paged leaves only."""
        self._movable()
        n = len(pids)
        self.bytes_copied += n * self._page_bytes
        idx = torch.tensor(pids, dtype=torch.long, device=self._device())
        for name, pool in self._paged.items():
            lay = self.layout[name]
            ba, sa = lay.batch_axis, lay.seq_axis - 1     # seq axis once batch is gone
            run = cache_leaf(cache, name).select(ba, batch_idx).narrow(
                sa, first_page * self.page, n * self.page)
            shape = list(run.shape)
            shape[sa:sa + 1] = [n, self.page]
            pool.movedim(ba, 0)[idx] = run.reshape(shape).movedim(sa, 0).to(pool.dtype)

    def store_state(self, cache: dict, batch_idx: int, pid: int):
        """Snapshot every state leaf of slot ``batch_idx`` into pool page
        ``pid``. Only meaningful when the slot sits exactly at that page's
        end position -- the prefix cache enforces that (``state_ok``)."""
        if not self._state:
            return
        self._movable()
        self.bytes_copied += self._state_bytes
        for name, snap in self._state.items():
            snap[pid].copy_(cache_leaf(cache, name).select(self.layout[name].batch_axis,
                                                           batch_idx))

    def load(self, cache: dict, batch_idx: int, page_ids: list, state_pid=None) -> dict:
        """Splice the cached pages ``page_ids`` into slot ``batch_idx`` of a
        contiguous ``cache`` as its token prefix ``[0, n * page)`` and (for
        stateful models) restore the state snapshot of page ``state_pid``.
        Writes ``cache`` in place and returns it with ``pos`` set to the
        cached length."""
        self._movable()
        n = len(page_ids)
        self.bytes_copied += n * self._page_bytes
        idx = torch.tensor(page_ids, dtype=torch.long, device=self._device())
        for name, pool in self._paged.items():
            lay = self.layout[name]
            ba, sa = lay.batch_axis, lay.seq_axis - 1
            blocks = pool.movedim(ba, 0)[idx].movedim(0, sa)        # n beside the page axis
            shape = list(blocks.shape)
            shape[sa:sa + 2] = [n * self.page]
            cache_leaf(cache, name).select(ba, batch_idx).narrow(sa, 0, n * self.page).copy_(
                blocks.reshape(shape))
        if state_pid is not None:
            self.bytes_copied += self._state_bytes
            for name, snap in self._state.items():
                cache_leaf(cache, name).select(self.layout[name].batch_axis,
                                               batch_idx).copy_(snap[state_pid])
        if torch.is_tensor(cache["pos"]):
            cache["pos"][batch_idx] = n * self.page
        else:
            cache["pos"] = n * self.page
        return cache

    def _device(self):
        # a recurrent model's pool holds state snapshots and no pages
        return next(iter((*self._paged.values(), *self._state.values()))).device
