"""Radix-tree prefix cache over the shared KV page pool.

Maps token-id page keys to :class:`~repro_torch.serving.pagepool.PagePool`
pages so the continuous batcher can skip prefilling any prefix some
earlier session (or an earlier turn of the same conversation) already
computed. One tree per **cache salt**: the gateway derives the salt from
the authenticated principal, so tenants never share prefixes — not even
bitwise-identical system prompts.

Structure: each node covers exactly one page (``page`` tokens); its key
is the tuple of token ids the page covers, hashed by the child dict.
A path root→node therefore spells out a page-aligned token prefix, and
the node's pool page holds that page's KV (plus, for stateful models, a
snapshot of the recurrent state at the page's end position when the
page was published at an aligned boundary — ``state_ok``).

Lifecycle:

* ``begin(salt, ids)`` — longest-prefix match, **pinning** every matched
  node for the session's lifetime. Pins are the live-slot refcounts:
  a pinned node (and hence its pool page) is never evicted, so a page a
  live slot maps — matched for splicing, or the chain tail a session
  will extend at finish — cannot be freed under it.
* ``publish(lease, tokens, cache, batch_idx, kv_n, state_at)`` — extend
  the lease's chain with every full page of ``tokens[:kv_n]`` not yet
  in the tree, copying page blocks out of the session's cache (during
  chunked prefill, and again at finish for the decoded extension).
  Already-present pages are pinned and deduplicated, not re-stored.
* ``release(lease)`` — unpin (session finished or cancelled). The pages
  stay in the tree for the next session; this is the "published back
  instead of discarded" half of the contract.

Eviction is LRU over unpinned leaf nodes, triggered only when the pool
runs out of pages for a new publish; an unevictable full pool makes the
publish a silent no-op (``stats.dropped_pages``) — correctness never
depends on a publish landing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class _Node:
    __slots__ = ("key", "page", "state_ok", "children", "pins", "last_used",
                 "parent")

    def __init__(self, key, page: int, parent: "_Node | None"):
        self.key = key                    # tuple of token ids (one page)
        self.page = page                  # pool page id
        self.state_ok = False             # state snapshot valid at page end
        self.children: dict = {}
        self.pins = 0
        self.last_used = 0
        self.parent = parent


class _Root(_Node):
    def __init__(self):
        super().__init__((), -1, None)
        self.state_ok = True              # empty prefix needs no state


@dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0                 # lookups that matched >= 1 page
    hit_tokens: int = 0           # prefill tokens skipped, cumulative
    published_pages: int = 0
    deduped_pages: int = 0        # publish found the page already present
    evicted_pages: int = 0
    dropped_pages: int = 0        # pool full and nothing evictable


@dataclass
class PrefixLease:
    """One session's hold on the tree: the matched/extended node chain
    (root excluded), all pinned until :meth:`PrefixCache.release`."""
    salt: str
    chain: list = field(default_factory=list)
    n_cached: int = 0             # tokens the session skipped prefilling
    released: bool = False

    @property
    def tail(self) -> Optional[_Node]:
        return self.chain[-1] if self.chain else None


class PrefixCache:
    """Host-side index over the device page pool. Single-threaded by
    design: only the broker's scheduler thread touches it, like the
    batcher it serves."""

    def __init__(self, pool):
        self.pool = pool
        self.page = pool.page
        self.stateful = pool.stateful
        self.roots: dict[str, _Root] = {}
        self.stats = CacheStats()
        self._clock = 0
        # every pool page the tree currently references, registered as the
        # pool's release-ordering guard: pool.free() asserts the page is
        # not in here, so "evict then free" is the only legal order and a
        # cancelled publish can never reclaim a page it already handed to
        # the tree
        self._pids: set[int] = set()
        pool.free_guard = self.owns

    def owns(self, pid: int) -> bool:
        """True while a tree node references pool page ``pid``."""
        return pid in self._pids

    # ------------------------------------------------------------ internals
    def _touch(self, node: _Node):
        self._clock += 1
        node.last_used = self._clock

    def _root(self, salt: str) -> _Root:
        root = self.roots.get(salt)
        if root is None:
            root = self.roots[salt] = _Root()
        return root

    def n_nodes(self) -> int:
        def count(n):
            return 1 + sum(count(c) for c in n.children.values())
        return sum(count(r) - 1 for r in self.roots.values())

    # ------------------------------------------------------------ lookup
    def begin(self, salt: str, ids: list) -> PrefixLease:
        """Longest cached page-aligned prefix of ``ids``, pinned.

        The match is capped at ``len(ids) - 1`` tokens so at least the
        final prompt token is always prefilled (its logits produce the
        first sampled token), and — for stateful models — trimmed back
        to the deepest ``state_ok`` node, because resuming a recurrent
        model needs the state snapshot at exactly the resume position.
        """
        self.stats.lookups += 1
        lease = PrefixLease(salt=salt)
        root = self._root(salt)
        max_pages = max(len(ids) - 1, 0) // self.page
        node, chain = root, []
        while len(chain) < max_pages:
            i = len(chain) * self.page
            child = node.children.get(tuple(ids[i:i + self.page]))
            if child is None:
                break
            chain.append(child)
            node = child
        if self.stateful:
            while chain and not chain[-1].state_ok:
                chain.pop()
        for n in chain:
            n.pins += 1
            self._touch(n)
        lease.chain = chain
        lease.n_cached = len(chain) * self.page
        if lease.n_cached:
            self.stats.hits += 1
            self.stats.hit_tokens += lease.n_cached
        return lease

    def match_len(self, salt: str, ids: list) -> int:
        """Read-only peek: how many tokens of ``ids`` the tree could
        serve, WITHOUT pinning, stats, or LRU touches. Same walk and cap
        as :meth:`begin`. Safe to call from any thread while the
        scheduler mutates the tree — it only reads dicts (GIL-atomic)
        and tolerates staleness, which is fine for its one consumer: the
        fleet router using it as a placement hint."""
        root = self.roots.get(salt)
        if root is None:
            return 0
        max_pages = max(len(ids) - 1, 0) // self.page
        node, depth = root, 0
        while depth < max_pages:
            i = depth * self.page
            child = node.children.get(tuple(ids[i:i + self.page]))
            if child is None:
                break
            depth += 1
            node = child
        return depth * self.page

    def load_into(self, lease: PrefixLease, cache: dict, batch_idx: int = 0):
        """Splice the lease's matched pages into ``cache`` as the slot's
        token prefix (pos advances to the cached length)."""
        if not lease.chain:
            return cache
        return self.pool.load(
            cache, batch_idx, [n.page for n in lease.chain],
            state_pid=lease.tail.page if self.stateful else None)

    # ------------------------------------------------------------ publish
    def publish(self, lease: PrefixLease, tokens: list, cache: dict,
                batch_idx: int, kv_n: int, state_at: int = -1):
        """Extend the lease's chain with every full page of
        ``tokens[:kv_n]`` beyond what the chain already covers. ``cache``
        (slot ``batch_idx``) must hold valid KV for positions
        ``[0, kv_n)``; ``state_at`` is the position the cache's state
        leaves currently reflect (-1: don't snapshot state)."""
        if lease.released:
            return
        root = self._root(lease.salt)
        node = lease.tail or root
        n_pages = min(kv_n, len(tokens)) // self.page
        start = len(lease.chain)
        # walk the already-present (dedupe) prefix of the publish range;
        # once a child is missing, every deeper page is missing too (we
        # walk a single root->leaf path), so the remainder stores as ONE
        # contiguous batched device dispatch
        first_new = n_pages
        for p in range(start, n_pages):
            key = tuple(tokens[p * self.page:(p + 1) * self.page])
            child = node.children.get(key)
            if child is None:
                first_new = p
                break
            self.stats.deduped_pages += 1
            self._adopt(lease, child, state_at, cache, batch_idx, p)
            node = child
        if first_new < n_pages:
            pids = self._alloc_many(n_pages - first_new)
            self.stats.dropped_pages += (n_pages - first_new) - len(pids)
            if pids:
                self.pool.store_pages(cache, batch_idx, first_new, pids)
                for i, pid in enumerate(pids):
                    p = first_new + i
                    key = tuple(tokens[p * self.page:(p + 1) * self.page])
                    child = _Node(key, pid, node)
                    node.children[key] = child
                    self._pids.add(pid)
                    self.stats.published_pages += 1
                    self._adopt(lease, child, state_at, cache, batch_idx, p)
                    node = child

    def publish_paged(self, lease: PrefixLease, tokens: list, kv_n: int,
                      pages: list, owned: list) -> list:
        """Zero-copy publish for the paged decode path: the slot's KV
        already lives in pool pages (``pages[p]`` backs token page ``p``
        of the slot's block table; ``owned[p]`` marks pages the session
        allocated privately vs. matched tree pages). Extending the tree
        is pure **ownership transfer** — a private page becomes a tree
        node holding the same pool page id; no device copy, no store
        dispatch. A dedupe hit (another session published the identical
        page first) frees our private duplicate and *repoints* the slot
        at the tree's page — content is bitwise identical by position
        stability. Returns ``[(page_index, new_pid), ...]`` repoints for
        the caller to fold back into its block table. ``owned`` is
        updated in place: every page the tree absorbed (or repointed)
        flips to False so the caller won't double-free it."""
        if lease.released:
            return []
        root = self._root(lease.salt)
        node = lease.tail or root
        n_pages = min(kv_n, len(tokens)) // self.page
        repoints = []
        for p in range(len(lease.chain), n_pages):
            key = tuple(tokens[p * self.page:(p + 1) * self.page])
            child = node.children.get(key)
            if child is not None:
                self.stats.deduped_pages += 1
                if owned[p]:
                    assert pages[p] != child.page
                    self.pool.free(pages[p])
                    owned[p] = False
                    pages[p] = child.page
                    repoints.append((p, child.page))
            else:
                assert owned[p], (
                    "publishing a page the session neither owns nor matched")
                child = _Node(key, pages[p], node)
                node.children[key] = child
                self._pids.add(pages[p])
                owned[p] = False           # the tree owns it now
                self.stats.published_pages += 1
            child.pins += 1
            self._touch(child)
            lease.chain.append(child)
            node = child
        return repoints

    def _adopt(self, lease: PrefixLease, child: _Node, state_at: int,
               cache: dict, batch_idx: int, p: int):
        """Pin one (matched-or-new) publish page into the lease's chain,
        snapshotting state when the cache is exactly at its boundary."""
        if state_at == (p + 1) * self.page and not child.state_ok:
            self.pool.store_state(cache, batch_idx, child.page)
            child.state_ok = True
        child.pins += 1
        self._touch(child)
        lease.chain.append(child)

    def release(self, lease: PrefixLease):
        """Drop the session's pins; its pages stay published."""
        if lease.released:
            return
        lease.released = True
        for n in lease.chain:
            n.pins -= 1

    # ------------------------------------------------------------ eviction
    def _alloc_many(self, n: int) -> list:
        """Up to ``n`` free page ids. When the pool runs dry, ONE tree
        walk collects the LRU unpinned leaves and frees as many as still
        needed (per-page walks made a multi-page publish into a full
        pool O(pages x nodes) on the scheduler thread)."""
        pids = []
        while len(pids) < n:
            pid = self.pool.alloc()
            if pid is None:
                break
            pids.append(pid)
        while len(pids) < n and self._evict(n - len(pids)):
            pid = self.pool.alloc()
            while pid is not None and len(pids) < n:
                pids.append(pid)
                pid = self.pool.alloc()
            if pid is not None:
                self.pool.free(pid)
        return pids

    def _evict(self, k: int) -> bool:
        """Free up to ``k`` least-recently-used unpinned *leaf* nodes in
        one walk (interior nodes become leaves as their subtrees drain;
        evicting several leaves of one parent chain still only takes the
        current leaf layer — correct, the next walk takes the parent).
        Never touches a pinned node — a live slot's mapped pages are
        safe by construction. Returns False when nothing was evictable."""
        leaves = []

        def walk(n: _Node):
            for c in n.children.values():
                if c.children:
                    walk(c)
                elif c.pins == 0:
                    leaves.append(c)

        for root in self.roots.values():
            walk(root)
        leaves.sort(key=lambda n: n.last_used)
        for victim in leaves[:k]:
            del victim.parent.children[victim.key]
            self._pids.discard(victim.page)   # before free(): guard ordering
            self.pool.free(victim.page)
            self.stats.evicted_pages += 1
        return bool(leaves)

    def evict_one(self) -> bool:
        """Free the single LRU unpinned leaf (kept as the public
        fine-grained hook; bulk callers go through _alloc_many)."""
        return self._evict(1)
