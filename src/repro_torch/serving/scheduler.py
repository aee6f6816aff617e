"""Continuous batching scheduler -- fused decode ticks over a shared
paged-KV pool with radix-tree prefix caching (the native paged path of
the JAX package's ``serving/scheduler.py``).

Fixed decode batch of B slots. One tick decodes every slot, samples,
and masks EOS/length per slot on the device; the host reads back a
single packed (B, 3) int32 array per tick (``transfers``). An admission
additionally reads its first token as one scalar (``adm_transfers``),
so TTFT never waits for the next full tick.

Slots decode straight out of the pool buffers through per-slot block
tables: admission of a cached prefix points the slot's table at the
tree's pages, prompts prefill position-stable in page-aligned chunks
(``chunk_plan``) into private pages, and publishing at finish is an
ownership transfer. No KV byte is copied per admission.

Not ported yet, and refused with ``NotImplementedError`` rather than
served another way: the contiguous splice path (stateful families, a
pool too small for one slot, unaligned ``max_seq``), speculative
decoding and rolling windows (``WindowPolicy``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models.common import cache_layout, has_state_leaves
from repro_torch.serving.pagepool import PagePool, chunk_plan
from repro_torch.serving.prefix_cache import PrefixCache, PrefixLease
from repro_torch.serving.sampler import GenerationParams, StopMatcher, sample_slots
from repro_torch.serving.tokenizer import ByteTokenizer


def clip_prompt(ids, max_new_tokens: int, max_seq: int) -> tuple:
    """The one capacity rule: the budget charges the power-of-two bucket
    the prompt length rounds up to, and decode writes
    ``max_new_tokens - 1`` more positions, so the invariant is

        bucket(len(ids)) + max_new_tokens <= max_seq + 1

    Returns ``(ids, max_new_tokens)`` with the prompt clipped to the
    next bucket down and/or the budget clamped."""
    ids = list(ids)

    def bucket(n):
        b = 16
        while b < n:
            b *= 2
        return min(b, max_seq - 1)

    min_bucket = min(16, max(max_seq - 1, 1))
    max_new = max(min(max_new_tokens, max_seq + 1 - min_bucket), 1)
    keep = min(len(ids), max(max_seq - max_new - 1, 1))
    while bucket(keep) + max_new > max_seq + 1 and keep > 1:
        keep = bucket(keep) // 2
    return ids[:keep], max_new


@dataclass
class Request:
    rid: str
    prompt_ids: list
    max_new_tokens: int = 32
    on_token: Optional[Callable[[int, str], None]] = None
    on_done: Optional[Callable[["Request"], None]] = None
    deadline_s: float = 0.0          # 0 = none
    params: Optional[GenerationParams] = None   # per-request sampling/stop
    cache_salt: str = ""             # prefix-cache tenant key (gateway auth)
    prefix_hit_tokens: int = 0       # prefill tokens served from the cache
    submitted_at: float = field(default_factory=time.perf_counter)
    output_ids: list = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    finish_reason: str = ""          # "stop" | "length" | "cancelled"
    error: Optional[str] = None      # set when a scheduler fault ended it
    _stop: Optional[StopMatcher] = None
    _lease: Optional[PrefixLease] = None   # pinned prefix-tree chain
    _kv_ids: Optional[list] = None         # clipped prompt (KV token basis)
    # the slot's block-table mapping: _pages[p] is the pool page backing
    # token page p; _own[p] marks pages this session allocated privately
    # (freed or published at finish) vs matched tree pages (pinned)
    _pages: list = field(default_factory=list)
    _own: list = field(default_factory=list)
    _rolls: int = 0                  # window rolls (always 0: not ported)

    def _matcher(self) -> Optional[StopMatcher]:
        if self._stop is None and self.params and self.params.stop:
            self._stop = StopMatcher(self.params.stop)
        return self._stop

    def emit(self, tid: int, text: str) -> bool:
        """Deliver one decoded token through the stop matcher; returns
        True when a stop sequence completed (it is never delivered)."""
        m = self._matcher()
        if m is None:
            if self.on_token:
                self.on_token(tid, text)
            return False
        d = m.feed(text)
        if d and self.on_token:
            self.on_token(tid, d)
        return m.stopped

    def flush_stop(self, deliver: bool = True):
        """Stream ended without a stop match: release the withheld tail."""
        m = self._stop
        if m is None or m.stopped:
            return
        d = m.flush()
        if d and deliver and self.on_token:
            self.on_token(-1, d)

    def final_text(self, tokenizer) -> str:
        if self._stop is not None:
            return self._stop.text
        return tokenizer.decode(self.output_ids)


@dataclass
class _Admission:
    """An in-flight chunked prefill over the suffix the prefix cache
    could not serve."""
    req: Request
    slot: int
    cache: dict                      # batch=1 view of the pool being filled
    ids: list                        # clipped prompt (absolute token basis)
    pieces: list                     # remaining chunk lengths
    pos: int = 0                     # tokens prefilled so far (incl. cached)
    lease: Optional[PrefixLease] = None
    temp: float = 0.0                # resolved per-request sampling params
    top_p: float = 1.0
    seed: int = -1                   # -1 -> shared per-tick generator


class ContinuousBatcher:
    def __init__(self, engine, *, slots: int = 4, max_seq: int | None = None,
                 prefill_chunk: int = 32, page: int = 16,
                 prefix_pages: int | None = None):
        self.engine = engine
        self.model = engine.model
        self.cfg = engine.cfg
        self.device = engine.device
        self.B = slots
        self.max_seq = max_seq or engine.max_seq
        self.tokenizer: ByteTokenizer = engine.tokenizer
        self.prefill_chunk = prefill_chunk
        self.page = page
        if prefix_pages is None:
            prefix_pages = engine.prefix_cache_pages
        layout = cache_layout(self.model.cache_specs())
        self.n_pages = self.max_seq // page
        why = [reason for reason, bad in (
            ("prefix_pages=0", not prefix_pages),
            ("a stateful model", has_state_leaves(layout)),
            (f"max_seq={self.max_seq} not a multiple of page={page}",
             self.max_seq % page),
            (f"prefix_pages={prefix_pages} < one slot's {self.n_pages} pages",
             prefix_pages and prefix_pages < self.n_pages)) if bad]
        if why:
            raise NotImplementedError(
                "only the native paged decode path is ported; the contiguous "
                f"splice path this configuration needs ({', '.join(why)}) is not")
        self.pool = PagePool(self.model, page=page, capacity=prefix_pages,
                             kv_dtype=engine.kv_dtype, device=self.device)
        self.prefix = PrefixCache(self.pool)
        self.admissions = 0
        self._stall = False
        # the pool buffers ARE the decode cache: the model writes them in
        # place, and every admission's batch=1 cache views the same tensors
        self.cache = self.pool.paged_cache(self.B, self.n_pages)
        self._bt = np.zeros((self.B, self.n_pages), np.int32)
        self._bt_dirty = False
        self._pool_keys = [k for k in self.cache
                           if k not in ("pos", "pos_offset", "block_tables")]
        self.window = None               # rolling windows: not ported (broker reads it)
        self.active: list[Optional[Request]] = [None] * self.B
        self.queue: list[Request] = []
        self._adm: Optional[_Admission] = None
        self._freed = False
        self.tok = torch.zeros((self.B, 1), dtype=torch.int64, device=self.device)

        # host mirror of the per-slot state (tiny vectors, one host->device
        # copy per tick)
        self._active_m = np.zeros(self.B, bool)
        self._gen = np.zeros(self.B, np.int32)
        self._maxgen = np.full(self.B, 1, np.int32)
        sc = engine.sampler
        self._temp = np.full(self.B, sc.temperature, np.float32)
        self._topp = np.full(self.B, sc.top_p, np.float32)
        self._seed = np.full(self.B, -1, np.int64)
        self.transfers = 0           # packed reads; one per decode tick
        self.adm_transfers = 0       # scalar first-token reads; one per admission

    # ------------------------------------------------------------ device steps
    def _fused(self):
        """One tick: decode all slots, sample, mask EOS/length per slot.
        Returns the packed (B, 3) int32 [next, emitted, done] on the host
        -- the tick's single token transfer."""
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        state = torch.from_numpy(np.stack(
            [self._active_m.astype(np.int32), self._gen, self._maxgen])).to(
                self.device, non_blocking=True)
        run, gen, max_gen = state[0].bool(), state[1], state[2]
        logits, cache = self.model.decode_step(self.engine.params, self.tok,
                                               self.cache)
        nxt = sample_slots(logits, self.engine.gen, self.engine.sampler,
                           self._temp, self._topp, self._seed, self._gen)
        nxt = torch.where(run, nxt, pad)
        gen2 = gen + run.to(gen.dtype)
        done_now = run & ((nxt == eos) | (gen2 >= max_gen))
        alive = run & ~done_now
        # park finished/empty slots at pos 0 so their (masked, unread)
        # cache writes land on the trash page
        cache["pos"] = torch.where(alive, cache["pos"], 0).to(torch.int32)
        cache["pos_offset"] = torch.where(alive, cache["pos_offset"], 0).to(torch.int32)
        self.cache = cache
        self.tok = nxt[:, None]
        packed = torch.stack([nxt.to(torch.int32), run.to(torch.int32),
                              done_now.to(torch.int32)], dim=1)
        return packed.cpu().numpy()

    def _first(self, logits, adm: _Admission) -> int:
        """Sample an admission's first token from its prefill logits (step 0
        of its sample stream), drop it into the tok buffer, and read it as
        one scalar."""
        t = sample_slots(logits, self.engine.gen, self.engine.sampler,
                         np.array([adm.temp], np.float32),
                         np.array([adm.top_p], np.float32),
                         np.array([adm.seed], np.int64), np.zeros(1, np.int32))
        self.tok[adm.slot, 0] = t[0]
        return int(t[0])

    # ------------------------------------------------------------ admission
    def submit(self, req: Request):
        self.queue.append(req)

    def cancel(self, req: Request) -> bool:
        """Cancel one request wherever it lives: queued, mid-chunked-
        prefill, or active. Fires ``on_done`` with ``cancelled=True``.
        Returns False if the request already finished. NOT thread-safe
        against a concurrent ``step()`` -- callers serialize (see
        repro_torch.serving.broker)."""
        if req.done:
            return False
        if req in self.queue:
            self.queue.remove(req)
        elif self._adm is not None and self._adm.req is req:
            adm = self._adm
            if adm.lease is not None:
                # transfer the completed pages to the tree FIRST, then free
                # what the session still owns (pool.free asserts the order)
                self.prefix.publish_paged(adm.lease, adm.ids, adm.pos,
                                          req._pages, req._own)
            self._release_lease(req)
            self._free_pages(req)
            self._adm = None
        else:
            for slot, r in enumerate(self.active):
                if r is req:
                    self._finish(slot, cancelled=True)
                    return True
            return False
        req.done, req.cancelled = True, True
        req.finish_reason = "cancelled"
        if req.on_done:
            req.on_done(req)
        return True

    def _release_lease(self, req: Request):
        if req._lease is not None:
            self.prefix.release(req._lease)
            req._lease = None

    def _free_pages(self, req: Request):
        for pid, own in zip(req._pages, req._own):
            if own:
                self.pool.free(pid)
        req._pages, req._own = [], []

    def _pop_request(self) -> Optional[Request]:
        """Next queued request, expiring deadlined ones at the pop."""
        now = time.perf_counter()
        while self.queue:
            cand = self.queue.pop(0)
            if cand.deadline_s and (now - cand.submitted_at) > cand.deadline_s:
                cand.done, cand.cancelled = True, True
                cand.finish_reason = "cancelled"
                if cand.on_done:
                    cand.on_done(cand)
                continue
            return cand
        return None

    def _start_admission(self) -> Optional[_Admission]:
        slot = next((s for s in range(self.B) if self.active[s] is None), None)
        if slot is None:
            return None
        req = self._pop_request()
        if req is None:
            return None
        ids, req.max_new_tokens = clip_prompt(
            req.prompt_ids, req.max_new_tokens, self.max_seq)
        req._kv_ids = ids
        # zero-copy admission: the cached prefix is served by POINTING the
        # slot's block table at the tree's pages; the suffix plus the
        # decode budget get private pages allocated up front, so nothing
        # in the serving loop can run out of pages mid-stream. The last
        # written position is len(ids) + max_new - 2.
        lease = self.prefix.begin(req.cache_salt, ids)
        need = -(-(len(ids) + req.max_new_tokens - 1) // self.page)
        private = need - len(lease.chain)
        pids = self.prefix._alloc_many(private)
        if len(pids) < private:
            # pool exhausted even after eviction: put everything back and
            # retry once a slot finishes
            for pid in pids:
                self.pool.free(pid)
            self.prefix.release(lease)
            self.queue.insert(0, req)
            self._stall = True
            return None
        req._pages = [nd.page for nd in lease.chain] + pids
        req._own = [False] * len(lease.chain) + [True] * len(pids)
        row = np.zeros((1, self.n_pages), np.int32)
        row[0, :len(req._pages)] = req._pages
        one = {k: self.cache[k] for k in self._pool_keys}
        one["pos"] = lease.n_cached
        one["block_tables"] = torch.from_numpy(row).to(self.device)
        req._lease = lease
        req.prefix_hit_tokens = lease.n_cached
        p, sc = req.params, self.engine.sampler
        return _Admission(
            req=req, slot=slot, cache=one, ids=ids,
            pieces=chunk_plan(lease.n_cached, len(ids), self.page),
            pos=lease.n_cached, lease=lease,
            temp=(p.temperature if p and p.temperature is not None
                  else sc.temperature),
            top_p=p.top_p if p and p.top_p is not None else sc.top_p,
            seed=(p.seed & 0x7FFFFFFF) if p and p.seed is not None else -1)

    def _advance_admissions(self):
        """Start or advance the in-flight admission by one tick's worth of
        prefill chunks (all of them when the batch is idle). Called at
        tick start and again after reaping."""
        if self._adm is None:
            if not self.queue:
                return
            self._adm = self._start_admission()
            if self._adm is None:
                return
        adm = self._adm
        idle = not any(r is not None for r in self.active)
        budget = len(adm.ids) if idle else self.prefill_chunk
        logits = None
        while adm.pieces and budget > 0:
            n = adm.pieces.pop(0)
            chunk = torch.tensor([adm.ids[adm.pos:adm.pos + n]], dtype=torch.int64,
                                 device=self.device)
            logits, adm.cache = self.model.prefill_chunk(self.engine.params,
                                                         chunk, adm.cache)
            adm.pos += n
            budget -= n
        if adm.pieces:
            return
        # prefill complete: sample + emit the first token (one scalar read
        # per admission) before activating the slot
        slot, req = adm.slot, adm.req
        first = self._first(logits, adm)
        self._adm = None
        self.adm_transfers += 1
        req.output_ids.append(first)
        stopped = req.emit(first, self.tokenizer.decode_token(first))
        # offer the GIL to the consumer thread the emission just woke
        time.sleep(0)
        self.admissions += 1
        if adm.lease is not None:
            # publish is pure ownership transfer: the prompt's full pages
            # become tree nodes, zero bytes moved
            self.prefix.publish_paged(adm.lease, adm.ids, adm.pos,
                                      req._pages, req._own)
        if stopped or first == self.tokenizer.eos_id or req.max_new_tokens <= 1:
            req.done = True          # ended on its prefill token
            req.finish_reason = ("length" if (not stopped and
                                              first != self.tokenizer.eos_id)
                                 else "stop")
            self._release_lease(req)
            self._free_pages(req)
            req.flush_stop()
            if req.on_done:
                req.on_done(req)
            return
        # activation is two pointer writes: the block-table row and the
        # slot's position
        self._bt[slot, :] = 0
        self._bt[slot, :len(req._pages)] = req._pages
        self._bt_dirty = True
        self.cache["pos"][slot] = len(adm.ids)
        self.cache["pos_offset"][slot] = 0
        self.active[slot] = req
        self._active_m[slot] = True
        self._gen[slot] = 1          # the prefill token counts
        self._maxgen[slot] = req.max_new_tokens
        self._temp[slot] = adm.temp
        self._topp[slot] = adm.top_p
        self._seed[slot] = adm.seed

    # ------------------------------------------------------------ tick
    def _finish(self, slot: int, cancelled=False):
        req = self.active[slot]
        if req is None:
            return
        req.done, req.cancelled = True, cancelled
        if cancelled:
            req.finish_reason = "cancelled"
        elif not req.finish_reason:
            req.finish_reason = ("length" if self._gen[slot] >= self._maxgen[slot]
                                 else "stop")
        # publish the decoded extension back to the tree (ownership
        # transfer) BEFORE the owned-page sweep; KV exists for the prompt
        # plus every output token but the last
        if req._lease is not None and req._kv_ids is not None:
            kv_n = len(req._kv_ids) + max(len(req.output_ids) - 1, 0)
            self.prefix.publish_paged(req._lease, req._kv_ids + req.output_ids,
                                      kv_n, req._pages, req._own)
        self._release_lease(req)
        self._free_pages(req)
        self._bt[slot, :] = 0
        self._bt_dirty = True
        req.flush_stop(deliver=not cancelled)
        if req.on_done:
            req.on_done(req)
        self.active[slot] = None
        self._active_m[slot] = False
        self._freed = True

    def _in_flight(self) -> int:
        return (sum(r is not None for r in self.active)
                + (self._adm is not None))

    def pool_stats(self):
        return self.pool.stats()

    def bytes_copied_per_admission(self) -> float:
        """Device bytes moved per admitted session by KV copies (attention
        math excluded). The paged path re-points block tables, so 0."""
        return self.pool.bytes_copied / max(self.admissions, 1)

    @torch.inference_mode()
    def step(self) -> int:
        """One scheduler tick: admit (one chunk), fused decode, emit, reap,
        re-admit. Returns the number of requests still in flight."""
        self._freed = False
        self._stall = False
        idle = not any(r is not None for r in self.active)
        self._advance_admissions()
        if idle:
            # cold-start burst: with no decodes in flight, run prefills to
            # completion until the free slots are filled
            while (self._adm is not None
                   or (self.queue and not self._stall
                       and any(r is None for r in self.active))):
                self._advance_admissions()
        if not any(r is not None for r in self.active):
            return self._in_flight()
        if self._bt_dirty:
            # the block tables reach the device only when a mapping changed
            self.cache["block_tables"] = torch.from_numpy(self._bt.copy()).to(
                self.device, non_blocking=True)
            self._bt_dirty = False
        packed = self._fused()
        self.transfers += 1
        now = time.perf_counter()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            nxt, emitted, done = (int(v) for v in packed[slot])
            if emitted:
                req.output_ids.append(nxt)
                self._gen[slot] += 1
                if req.emit(nxt, self.tokenizer.decode_token(nxt)):
                    req.finish_reason = "stop"
                    self._finish(slot)
                    continue
            over = req.deadline_s and (now - req.submitted_at) > req.deadline_s
            if done or over:
                self._finish(slot, cancelled=bool(over))
        if self._freed and self._adm is None:
            self._advance_admissions()
        return self._in_flight()

    def run_until_drained(self, max_steps: int = 10000):
        steps = 0
        while (self.queue or self._adm is not None
               or any(r is not None for r in self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
