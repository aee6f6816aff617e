"""Continuous batching scheduler -- fused decode ticks over a shared
KV page pool with radix-tree prefix caching (the JAX package's
``serving/scheduler.py``: its native paged path and its contiguous
splice path).

Fixed decode batch of B slots. One tick decodes every slot, samples,
and masks EOS/length per slot on the device; the host reads back a
single packed (B, 3) int32 array per tick (``transfers``). An admission
additionally reads its first token as one scalar (``adm_transfers``),
so TTFT never waits for the next full tick.

**Paged** (attention-only models, page-aligned ``max_seq``, a pool that
holds one worst-case slot, ``engine.paged_kv``): slots decode straight
out of the pool buffers through per-slot block tables. Admission of a
cached prefix points the slot's table at the tree's pages, prompts
prefill position-stable in page-aligned chunks (``chunk_plan``) into
private pages, and publishing at finish is an ownership transfer. No KV
byte is copied per admission.

**Contiguous splice** (everything else, among it every stateful model:
an SSM state has no page address): slots live in a contiguous (B, ...)
cache with per-slot positions. An admission prefills into its own
batch=1 cache (loading a cached prefix from the pool first), publishes a
state snapshot at each completed page while it prefills (stateful
pools), and is spliced into its slot at activation (``SlotSplicer``);
``bytes_copied_per_admission`` counts the splice and the pool traffic.
The pool is then always in the compute dtype: ``kv_dtype`` applies to
the paged path only, as in the JAX package.

**Speculative decoding** (``engine.speculative``: "ngram" or "model"),
on both paths: a tick with drafts runs ONE ``verify_chunk`` over a
(B, W) window (W = spec_k + 1: each slot's last emitted token and its
draft) and emits the accepted prefix plus the target's correction or
bonus draw (``sampler.speculative_accept``), still with one packed host
read. A family without ``verify_chunk`` (the recurrent ones), or a
"model" mode without a drafter, runs plain decode (``spec_mode ==
"off"``), as in the JAX package.

**Rolling windows** (``engine.window_policy``, a :class:`WindowPolicy`;
the paged path only): a slot keeps its sink pages and rolls the rest.
When it fills ``cap_pages`` the oldest non-sink pages are evicted (their
token span goes to ``engine.span_summarizer``), the kept window's keys
are re-rotated in place by ``-roll_pages * page`` positions
(:meth:`ContinuousBatcher._shift_pages`), fresh pages join at the tail,
and the slot's ``pos_offset`` grows by the rolled tokens, so a session
decodes without end on a flat page budget.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.common import cache_layout, has_state_leaves, round_up
from repro_torch.models.layers import rope_shift
from repro_torch.serving import prng
from repro_torch.serving.pagepool import PagePool, SlotSplicer, chunk_plan
from repro_torch.serving.prefix_cache import PrefixCache, PrefixLease
from repro_torch.serving.sampler import (GenerationParams, StopMatcher, sample_slots,
                                         speculative_accept)
from repro_torch.serving.speculative import ModelDrafter, NgramDrafter, SpecStats
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


@dataclass(frozen=True)
class WindowPolicy:
    """Attention-sink rolling window over a slot's paged KV.

    ``sink_pages`` pages are pinned for the session's life (the
    StreamingLLM attention sinks: the prompt head every later token
    attends to); the rest roll. When the slot has filled its
    ``cap_pages = sink_pages + window_pages + 1`` pages, the oldest
    ``roll_pages`` non-sink pages are evicted in place (a block-table
    rewrite and a per-slot ``pos_offset`` bump, no KV copy) and their
    token span is handed to the span summarizer. Rope positions are
    slot-relative (``pos - pos_offset``): the sinks keep their rotations
    and the kept window is re-rotated by ``-roll_pages * page``, the key a
    fresh prefill at the shifted position would give.

    The spare page of ``cap_pages`` keeps every decode or verify write
    inside the mapping between roll checks. Only the native paged path
    takes a policy: the recurrent families have no page-granular state
    to evict and keep append-only KV.
    """
    sink_pages: int = 1
    window_pages: int = 4
    roll_pages: int = 1

    def __post_init__(self):
        assert self.sink_pages >= 1 and self.window_pages >= 1
        assert 1 <= self.roll_pages <= self.window_pages

    @property
    def cap_pages(self) -> int:
        return self.sink_pages + self.window_pages + 1


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
    _rolls: int = 0                  # window rolls this session has taken

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
    cache: dict                      # batch=1 view of the pool (paged) or own cache
    ids: list                        # clipped prompt (absolute token basis)
    pieces: list                     # remaining chunk lengths
    pos: int = 0                     # tokens prefilled so far (incl. cached)
    poff: int = 0                    # tokens rolled out during this prefill
    lease: Optional[PrefixLease] = None
    temp: float = 0.0                # resolved per-request sampling params
    top_p: float = 1.0
    seed: int = -1                   # -1 -> shared per-tick key


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
        self._layout = layout = cache_layout(self.model.cache_specs())
        self._splicer = SlotSplicer(layout)
        self.n_pages = self.max_seq // page
        # paged decode needs an attention-only model, page-aligned max_seq
        # and a pool that holds one worst-case slot; anything else (and
        # paged_kv=False) takes the contiguous splice path, whose pool is
        # always in the compute dtype
        self.paged = (bool(prefix_pages) and not has_state_leaves(layout)
                      and self.max_seq % page == 0 and prefix_pages >= self.n_pages
                      and engine.paged_kv)
        self.pool = (PagePool(self.model, page=page, capacity=prefix_pages,
                              kv_dtype=engine.kv_dtype if self.paged else "fp32",
                              device=self.device)
                     if prefix_pages else None)
        self.prefix = PrefixCache(self.pool) if self.pool is not None else None
        self.admissions = 0
        self._stall = False
        if self.paged:
            # the pool buffers ARE the decode cache: the model writes them in
            # place, and every admission's batch=1 cache views the same tensors
            self.cache = self.pool.paged_cache(self.B, self.n_pages)
            self._bt = np.zeros((self.B, self.n_pages), np.int32)
            self._bt_dirty = False
            self._pool_keys = [k for k in self.cache
                               if k not in ("pos", "pos_offset", "block_tables")]
        else:
            self.cache = self.model.init_cache(self.B, self.max_seq, self.device)
            self.cache["pos"] = torch.zeros((self.B,), dtype=torch.int32,
                                            device=self.device)
        # rolling-window policy: the roll is block-table surgery plus a
        # pos_offset bump, so only the native paged path takes it, and only
        # when the table can map a whole window; recurrent state has no
        # page address, so the splice path keeps append-only KV
        policy = getattr(engine, "window_policy", None)
        self.window: Optional[WindowPolicy] = (
            policy if (policy is not None and self.paged
                       and policy.cap_pages <= self.n_pages) else None)
        # rolled-out token spans go here per (rid, ids), off the decode path
        self.span_sink = getattr(engine, "span_summarizer", None)
        self.rolls = 0               # window rolls across all sessions
        self._poff = np.zeros(self.B, np.int64)   # host pos_offset mirror
        if self.window is not None:
            self._rope_leaves = self._roped_leaf_axes()
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

        # ---- speculative decoding (the propose_k / verify_chunk contract):
        # spec_k is clamped below a page, so a window crosses at most one
        # page boundary. ``_pos`` mirrors each slot's absolute position
        # on the host, for the contiguous path's end-of-cache check.
        spec_mode = getattr(engine, "speculative", "off") or "off"
        self.spec_k = min(int(getattr(engine, "spec_k", 4)), max(page - 1, 1))
        draft = getattr(engine, "drafter", None)
        ok = (spec_mode != "off" and self.spec_k > 0
              and hasattr(self.model, "verify_chunk"))
        if spec_mode == "model":
            ok = ok and draft is not None and hasattr(draft.model, "propose_k")
        self.spec_mode = spec_mode if ok else "off"
        self.spec = self.spec_mode != "off"
        self.spec_stats = SpecStats()
        # test and benchmark injection point: draft_hook(slot, req) -> the
        # proposed token ids (forces exact acceptance patterns)
        self.draft_hook: Optional[Callable[[int, Request], list]] = None
        self._pos = np.zeros(self.B, np.int64)
        if self.spec:
            self._draft_len = np.zeros(self.B, np.int32)
            self._draft_host = np.zeros((self.B, self.spec_k), np.int64)
            self._ngram = (NgramDrafter(self.spec_k)
                           if self.spec_mode == "ngram" else None)
            self._drafter = (ModelDrafter(draft, self.B, self.max_seq, page=page,
                                          k=self.spec_k, device=self.device)
                             if self.spec_mode == "model" else None)

    # ------------------------------------------------------------ device steps
    def _slot_state(self):
        """The per-slot (active, gen, max_gen) mirrors on the device: one
        host-to-device copy a tick."""
        state = torch.from_numpy(np.stack(
            [self._active_m.astype(np.int32), self._gen, self._maxgen])).to(
                self.device, non_blocking=True)
        return state[0].bool(), state[1], state[2]

    def _fused(self, rng):
        """One tick: decode all slots, sample (``rng``, the tick's key),
        mask EOS/length per slot. Returns the packed (B, 3) int32 [next,
        emitted, done] on the host -- the tick's single token transfer."""
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        run, gen, max_gen = self._slot_state()
        logits, cache = self.model.decode_step(self.engine.params, self.tok,
                                               self.cache)
        nxt = sample_slots(logits, rng, self.engine.sampler,
                           self._temp, self._topp, self._seed, self._gen)
        nxt = torch.where(run, nxt, pad)
        gen2 = gen + run.to(gen.dtype)
        done_now = run & ((nxt == eos) | (gen2 >= max_gen))
        alive = run & ~done_now
        # park finished/empty slots at pos 0 so their (masked, unread)
        # cache writes land on the trash page (paged) or their own slot
        cache["pos"] = torch.where(alive, cache["pos"], 0).to(torch.int32)
        if "pos_offset" in cache:
            cache["pos_offset"] = torch.where(alive, cache["pos_offset"],
                                              0).to(torch.int32)
        self.cache = cache
        self.tok = nxt[:, None]
        packed = torch.stack([nxt.to(torch.int32), run.to(torch.int32),
                              done_now.to(torch.int32)], dim=1)
        return packed.cpu().numpy()

    def _verify(self, drafts, draft_len, rng):
        """One speculative tick on the device: score every slot's (B, W)
        window in one ``verify_chunk``, replay the target's sample stream
        over it (``speculative_accept``) and emit the accepted prefix
        plus the correction/bonus draw -- n_acc + 1 tokens a slot,
        clamped by its budget and cut after the first EOS, as plain
        decode would have produced them one tick at a time.

        Rollback is position arithmetic: ``pos`` advances by the emitted
        count only, so rejected window positions lie beyond it, masked by
        ``kv_len`` and rewritten before ``pos`` reaches them (a paged
        slot's writes past its mapped pages went to the trash page).

        Returns the packed (B, W + 3) int32 [g_0 .. g_{W-1}, n_emit,
        done, n_acc] on the host: still one transfer a tick."""
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        W = self.spec_k + 1
        run, gen, max_gen = self._slot_state()
        win = torch.cat([self.tok, drafts.to(self.tok.dtype)], dim=1)       # (B, W)
        logits, cache = self.model.verify_chunk(self.engine.params, win, self.cache)
        g, n_acc = speculative_accept(
            logits, drafts, torch.from_numpy(draft_len).to(self.device),
            rng, self.engine.sampler, self._temp, self._topp, self._seed, self._gen)
        # the budget first (>= 1: a running slot always emits its
        # correction token), then cut after the first EOS of the emission
        n_emit = torch.minimum(n_acc + 1, (max_gen - gen).clamp(min=1))
        idx = torch.arange(W, device=g.device)[None, :]
        eos_hit = (g == eos) & (idx < n_emit[:, None])
        any_eos = eos_hit.any(dim=1)
        first_eos = torch.where(any_eos, eos_hit.to(torch.int32).argmax(dim=1), W)
        n_emit = torch.where(run, torch.minimum(n_emit, first_eos + 1), 0)
        done_now = run & (any_eos | (gen + n_emit >= max_gen))
        alive = run & ~done_now
        # the rollback: pos advances past emitted tokens only; finished
        # and empty slots park at 0, as in the plain tick
        cache["pos"] = torch.where(alive, cache["pos"] + n_emit, 0).to(torch.int32)
        if "pos_offset" in cache:
            cache["pos_offset"] = torch.where(alive, cache["pos_offset"],
                                              0).to(torch.int32)
        last = torch.gather(g, 1, (n_emit - 1).clamp(min=0)[:, None])
        self.cache = cache
        self.tok = torch.where(run[:, None], last, pad)
        out = torch.where(run[:, None], g, pad)
        packed = torch.cat([out, n_emit[:, None], done_now.to(torch.int64)[:, None],
                            n_acc[:, None]], dim=1).to(torch.int32)
        return packed.cpu().numpy()

    def _prepare_drafts(self) -> bool:
        """Fill the per-slot draft buffers for this tick. False when the
        tick should run plain decode: nothing drafted anywhere, or (the
        contiguous path only) an active slot so close to the end of the
        cache that a W-token window write would clip. Paged slots need no
        such check: window positions past a slot's mapped pages go to the
        trash page."""
        W = self.spec_k + 1
        self._draft_len[:] = 0
        any_draft = False
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            if not self.paged and self._pos[slot] + W > self.max_seq:
                return False
            cap = min(self.spec_k, int(self._maxgen[slot]) - int(self._gen[slot]) - 1)
            if self.window is not None:
                # clamp the verify window at the roll boundary: a window
                # written past it would compute post-boundary tokens with
                # pre-roll context, where plain decode rolls first. With
                # the clamp, rolls land where plain decode takes them and
                # speculative streams stay the plain ones under rolling.
                bnd = (self.window.cap_pages - 1) * self.page
                cap = min(cap, bnd - (int(self._pos[slot]) - int(self._poff[slot])))
            if cap <= 0:
                continue
            if self.draft_hook is not None:
                d = list(self.draft_hook(slot, req))[:cap]
            elif self.spec_mode == "model":
                if self.window is not None and self._pos[slot] + W > self.max_seq:
                    # the drafter's contiguous (B, max_seq) cache cannot
                    # hold a rolled session past max_seq: plain decode for
                    # this slot (its tokens are the target's either way)
                    continue
                # the drafter proposes for the whole batch on the device
                # (_spec_tick); only the per-slot clamp is decided here
                self._draft_len[slot] = cap
                any_draft = True
                continue
            else:
                d = self._ngram.propose((req._kv_ids or []) + req.output_ids)[:cap]
            if d:
                self._draft_host[slot, :len(d)] = d
                self._draft_len[slot] = len(d)
                any_draft = True
        return any_draft

    # ------------------------------------------------------------ rolling window
    def _roped_leaf_axes(self) -> list:
        """(cache key, pool axis) of every pooled leaf that holds roped
        keys: the leaves a roll re-rotates. GQA caches roped k; MLA ropes
        only its decoupled k_rope part (the latent c_kv is position-free).
        V is never rotated. A key is a leaf name (the paged path's keys
        are top-level names; nested specs give path tuples)."""
        out = []
        for key in self._pool_keys:
            name = key[-1] if isinstance(key, tuple) else key
            if name == "k_rope" or name.endswith("_krope"):
                out.append((key, self._layout[key].batch_axis))
            elif self.cfg.use_rope and (name == "k" or name.endswith("_k")):
                out.append((key, self._layout[key].batch_axis))
        return out

    def _shift_pages(self, pids: list, delta: int):
        """Re-rotate the kept window's cached keys by ``-delta`` positions,
        in place in the pool buffers (the pool IS the decode cache, and
        every admission's batch=1 cache views the same tensors, so the
        rotated pages are written into the existing storage, never into
        new tensors). Touches only the kept pages; unwritten ones ride
        along, masked by kv_len until overwritten.

        Quantized pools dequantize the pages with their scale sidecar,
        rotate in float32 and requantize codes and scales in place: one
        more rounding a roll."""
        if not pids or not self._rope_leaves:
            return
        idx = torch.tensor(pids, dtype=torch.long, device=self.device)
        theta = self.cfg.rope_theta
        for key, ba in self._rope_leaves:
            pool = self.cache[key].movedim(ba, 0)         # a view: pages first
            skey = f"{key}_qscale"
            if skey not in self.cache:
                pool[idx] = rope_shift(pool[idx], -delta, theta)
                continue
            # the sidecar is the pool's shape minus its feature axis, so ba
            # is the page axis of both
            spool = self.cache[skey].movedim(ba, 0)
            rot = rope_shift(ops.dequantize_kv(pool[idx], spool[idx]), -delta, theta)
            pool[idx], spool[idx] = ops.quantize_kv(rot, pool.dtype)

    def _roll_once(self, req: Request, poff: int) -> int:
        """One roll of ``req``'s mapping: evict the oldest non-sink pages,
        hand their token span to the summarizer, re-rotate the kept
        window and append fresh pages at the tail. Returns the new
        pos_offset; the caller updates the position state wherever the
        mapping lives (a decode slot or the admission in flight)."""
        w = self.window
        s, r = w.sink_pages, w.roll_pages
        delta = r * self.page
        evicted, ev_own = req._pages[s:s + r], req._own[s:s + r]
        kept = req._pages[s + r:]
        # a roll touches session-private pages past the sinks only: prefix
        # matching and publishing stop at the sinks for a rolling session,
        # so no tree page sits in the window (free_guard would catch one)
        assert all(req._own[s:]), "tree-owned page inside the rolling window"
        # the span before any state moves: slot-space pages [s, s + r) hold
        # the absolute tokens [s * page + poff, (s + r) * page + poff)
        lo = s * self.page + poff
        span = ((req._kv_ids or []) + req.output_ids)[lo:lo + delta]
        # free, then allocate: the free list is LIFO, so the same pages come
        # straight back as the new tail, occupancy stays flat and the
        # allocation cannot fail
        for pid, own in zip(evicted, ev_own):
            if own:
                self.pool.free(pid)
        fresh = self.prefix._alloc_many(len(evicted))
        assert len(fresh) == len(evicted), "roll re-allocation failed"
        req._pages = req._pages[:s] + kept + fresh
        req._own = req._own[:s] + req._own[s + r:] + [True] * len(fresh)
        self._shift_pages(kept, delta)
        if self.span_sink is not None and span:
            self.span_sink.submit(req.rid, span)
        req._rolls += 1
        self.rolls += 1
        return poff + delta

    def _maybe_roll_slots(self):
        """Roll every active slot whose next tick could write past its
        mapped cap. Runs before drafts are prepared, so a verify window
        (W <= page) never straddles a roll: the spare page of cap_pages
        takes the largest window between checks. A roll writes the slot's
        pos_offset on the device and marks the block tables for upload."""
        w = self.window
        if w is None:
            return
        cap_tok = w.cap_pages * self.page
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            poff = int(self._poff[slot])
            rolled = False
            while int(self._pos[slot]) - poff + self.page > cap_tok:
                poff = self._roll_once(req, poff)
                rolled = True
            if rolled:
                self._poff[slot] = poff
                self.cache["pos_offset"][slot] = poff
                self._bt[slot, :] = 0
                self._bt[slot, :len(req._pages)] = req._pages
                self._bt_dirty = True
                if self.spec:
                    # drafts from before the roll saw the old window
                    self._draft_len[slot] = 0

    def _spec_tick(self, rng):
        """One speculative tick (drafts prepared): propose, verify, emit.
        A slot with ``draft_len == 0`` rides the same window as a plain
        decode: it emits exactly its one target draw."""
        W = self.spec_k + 1
        if self.spec_mode == "model" and self.draft_hook is None:
            drafts = self._drafter.propose(self.tok, self.cache["pos"])
        else:
            drafts = torch.from_numpy(self._draft_host).to(self.device)
        lens = self._draft_len.copy()
        packed = self._verify(drafts, lens, rng)
        self.transfers += 1
        self.spec_stats.spec_ticks += 1
        now = time.perf_counter()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            n_emit, done, n_acc = (int(v) for v in packed[slot, W:W + 3])
            self.spec_stats.proposed += int(lens[slot])
            self.spec_stats.accepted += n_acc
            self.spec_stats.emitted += n_emit
            self._pos[slot] += n_emit
            self._gen[slot] += n_emit
            stopped = False
            for j in range(n_emit):
                t = int(packed[slot, j])
                req.output_ids.append(t)
                if req.emit(t, self.tokenizer.decode_token(t)):
                    # a stop completed mid-window: the later window tokens
                    # are discarded, as plain decode never produced them
                    req.finish_reason = "stop"
                    self._finish(slot)
                    stopped = True
                    break
            if stopped:
                continue
            over = req.deadline_s and (now - req.submitted_at) > req.deadline_s
            if done or over:
                self._finish(slot, cancelled=bool(over))

    def _first(self, logits, adm: _Admission) -> int:
        """Sample an admission's first token from its prefill logits (step 0
        of its sample stream), drop it into the tok buffer, and read it as
        one scalar."""
        self.engine.rng, k = prng.split(self.engine.rng)
        t = sample_slots(logits, k, self.engine.sampler,
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
            if self.paged and adm.lease is not None:
                # transfer the completed pages to the tree FIRST, then free
                # what the session still owns (pool.free asserts the order);
                # a rolling session publishes its sinks only (its window
                # pages are position-shifted, not what a cold prefill gives)
                self.prefix.publish_paged(adm.lease, adm.ids, self._publishable(adm.pos),
                                          req._pages, req._own)
            elif adm.lease is not None and not self.pool.stateful:
                # a cancelled prefill still publishes the pages it completed
                # (stateful pools published them page by page already)
                self.prefix.publish(adm.lease, adm.ids, adm.cache, 0,
                                    kv_n=adm.pos, state_at=-1)
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
        if req._lease is not None and self.prefix is not None:
            self.prefix.release(req._lease)
            req._lease = None

    def _publishable(self, n: int) -> int:
        """How many of ``n`` prefilled tokens a paged session may publish:
        all of them, or under a window its sink pages' tokens at most."""
        return n if self.window is None else min(n, self.window.sink_pages * self.page)

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
        if self.window is None:
            ids, req.max_new_tokens = clip_prompt(
                req.prompt_ids, req.max_new_tokens, self.max_seq)
        else:
            # a rolling session has no end: the prompt rolls through the
            # window while it prefills, so the capacity rule does not apply
            ids = list(req.prompt_ids)
            req.max_new_tokens = max(int(req.max_new_tokens), 1)
        req._kv_ids = ids
        if self.paged:
            if not self._map_pages(req, ids):
                return None
            lease = req._lease
            one = {k: self.cache[k] for k in self._pool_keys}
            one["pos"] = lease.n_cached
            row = np.zeros((1, self.n_pages), np.int32)
            row[0, :len(req._pages)] = req._pages
            one["block_tables"] = torch.from_numpy(row).to(self.device)
        else:
            # splice admission: prefill into a batch=1 cache of its own,
            # after loading the longest cached page-aligned prefix under
            # this tenant's salt from the pool; the lease pins the matched
            # pages until the session finishes
            lease = None
            one = self.model.init_cache(1, self.max_seq, self.device)
            if self.prefix is not None:
                lease = self.prefix.begin(req.cache_salt, ids)
                if lease.n_cached:
                    one = self.prefix.load_into(lease, one, 0)
        n_cached = lease.n_cached if lease is not None else 0
        req._lease = lease
        req.prefix_hit_tokens = n_cached
        p, sc = req.params, self.engine.sampler
        return _Admission(
            req=req, slot=slot, cache=one, ids=ids,
            pieces=chunk_plan(n_cached, len(ids), self.page),
            pos=n_cached, lease=lease,
            temp=(p.temperature if p and p.temperature is not None
                  else sc.temperature),
            top_p=p.top_p if p and p.top_p is not None else sc.top_p,
            seed=(p.seed & 0x7FFFFFFF) if p and p.seed is not None else -1)

    def _map_pages(self, req: Request, ids: list) -> bool:
        """Zero-copy paged admission: the cached prefix is served by
        POINTING the slot's block table at the tree's pages; the suffix
        plus the decode budget get private pages allocated up front, so
        nothing in the serving loop can run out of pages mid-stream (the
        last written position is len(ids) + max_new - 2). False, with the
        request back at the queue's head, when the pool is exhausted even
        after eviction. A rolling session matches at most its sink pages
        (everything past them is evicted and re-rotated by rolls, which
        must never touch a page the tree shares) and maps at most
        ``cap_pages``."""
        w = self.window
        lease = self.prefix.begin(req.cache_salt,
                                  ids if w is None else ids[:w.sink_pages * self.page + 1])
        need = -(-(len(ids) + req.max_new_tokens - 1) // self.page)
        if w is not None:
            need = min(need, w.cap_pages)
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
            return False
        req._pages = [nd.page for nd in lease.chain] + pids
        req._own = [False] * len(lease.chain) + [True] * len(pids)
        req._lease = lease
        return True

    def _roll_admission(self, adm: _Admission, n: int):
        """A prompt longer than the window rolls while it prefills: the
        decode-time roll, applied to the admission's own block-table row
        before the ``n``-token chunk whose write would pass the cap."""
        rolled = False
        while adm.pos - adm.poff + n > self.window.cap_pages * self.page:
            adm.poff = self._roll_once(adm.req, adm.poff)
            rolled = True
        if rolled:
            row = np.zeros((1, self.n_pages), np.int32)
            row[0, :len(adm.req._pages)] = adm.req._pages
            adm.cache["block_tables"] = torch.from_numpy(row).to(self.device)
            adm.cache["pos_offset"] = adm.poff

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
            if self.window is not None:
                self._roll_admission(adm, n)
            chunk = torch.tensor([adm.ids[adm.pos:adm.pos + n]], dtype=torch.int64,
                                 device=self.device)
            logits, adm.cache = self.model.prefill_chunk(self.engine.params,
                                                         chunk, adm.cache)
            adm.pos += n
            budget -= n
            if adm.lease is not None and self.pool.stateful:
                # recurrent models publish per completed page DURING
                # prefill: the state snapshot a node needs exists only
                # while the cache sits exactly at that page's boundary
                self.prefix.publish(adm.lease, adm.ids, adm.cache, 0,
                                    kv_n=adm.pos, state_at=adm.pos)
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
        if self.paged and adm.lease is not None:
            # publish is pure ownership transfer: the prompt's full pages
            # become tree nodes, zero bytes moved (a rolling session's sinks
            # only: the rest of its mapping rolls and re-rotates in place,
            # which must never happen to a shared tree page)
            self.prefix.publish_paged(adm.lease, adm.ids, self._publishable(adm.pos),
                                      req._pages, req._own)
        elif adm.lease is not None and not self.pool.stateful:
            # attention-only models on the splice path: store the prompt's
            # pages in one batched copy, after the first token left
            self.prefix.publish(adm.lease, adm.ids, adm.cache, 0,
                                kv_n=adm.pos, state_at=-1)
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
        if self.paged:
            # activation is two pointer writes: the block-table row and the
            # slot's position
            self._bt[slot, :] = 0
            self._bt[slot, :len(req._pages)] = req._pages
            self._bt_dirty = True
            self.cache["pos"][slot] = len(adm.ids)
            self.cache["pos_offset"][slot] = adm.poff
            self._poff[slot] = adm.poff
        else:
            # splice: the admission's used pages and whole state into the slot
            used = min(round_up(len(adm.ids), self.page), self.max_seq)
            self._splicer(self.cache, adm.cache, slot, used)
        self.active[slot] = req
        self._active_m[slot] = True
        self._gen[slot] = 1          # the prefill token counts
        self._maxgen[slot] = req.max_new_tokens
        self._temp[slot] = adm.temp
        self._topp[slot] = adm.top_p
        self._seed[slot] = adm.seed
        self._pos[slot] = len(adm.ids)
        if self.spec:
            self._draft_len[slot] = 0
            if self._drafter is not None and len(adm.ids) <= self.max_seq:
                # the drafter takes the prompt after the first token left
                # (off the TTFT path); its splice traffic is its own. A
                # rolling session's prompt may not fit its contiguous cache:
                # such a slot never drafts
                self._drafter.admit(slot, adm.ids)

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
        # publish the decoded extension back to the tree: KV exists for the
        # prompt plus every output token but the last. Paged: an ownership
        # transfer, BEFORE the owned-page sweep. Splice: a store from the
        # slot; no state snapshot exists mid-decode (state_at=-1), so a
        # stateful node becomes resumable only once a later prefill
        # re-crosses it at its boundary
        # A session that rolled publishes nothing here: its non-sink pages
        # hold position-shifted KV, not the cold-prefill pages the tree's
        # token keys promise (its sinks went in at admission)
        if req._lease is not None and req._kv_ids is not None and req._rolls == 0:
            kv_n = len(req._kv_ids) + max(len(req.output_ids) - 1, 0)
            if self.paged:
                self.prefix.publish_paged(req._lease, req._kv_ids + req.output_ids,
                                          kv_n, req._pages, req._own)
            else:
                self.prefix.publish(req._lease, req._kv_ids + req.output_ids,
                                    self.cache, slot, kv_n=kv_n, state_at=-1)
        self._release_lease(req)
        self._free_pages(req)
        if self.paged:
            self._bt[slot, :] = 0
            self._bt_dirty = True
        req.flush_stop(deliver=not cancelled)
        if req.on_done:
            req.on_done(req)
        self.active[slot] = None
        self._active_m[slot] = False
        self._pos[slot] = 0
        self._poff[slot] = 0
        if self.spec:
            self._draft_len[slot] = 0     # the slot re-admits with a clean window
        self._freed = True

    def _in_flight(self) -> int:
        return (sum(r is not None for r in self.active)
                + (self._adm is not None))

    def pool_stats(self):
        """The pool's PoolStats (None when prefix caching is off)."""
        return self.pool.stats() if self.pool is not None else None

    def bytes_copied_per_admission(self) -> float:
        """Device bytes moved per admitted session by splice, store and
        load copies (attention math excluded). The paged path re-points
        block tables, so 0; the splice path pays a slot splice plus its
        pool stores and loads."""
        total = self._splicer.bytes_copied
        if self.pool is not None:
            total += self.pool.bytes_copied
        return total / max(self.admissions, 1)

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
        self._maybe_roll_slots()
        if self.paged and self._bt_dirty:
            # the block tables reach the device only when a mapping changed
            self.cache["block_tables"] = torch.from_numpy(self._bt.copy()).to(
                self.device, non_blocking=True)
            self._bt_dirty = False
        # one key a tick, split on the host as the JAX package splits it
        self.engine.rng, rng = prng.split(self.engine.rng)
        if self.spec and self._prepare_drafts():
            self._spec_tick(rng)
            if self._freed and self._adm is None:
                self._advance_admissions()
            return self._in_flight()
        if self.spec:
            self.spec_stats.plain_ticks += 1
        packed = self._fused(rng)
        self.transfers += 1
        now = time.perf_counter()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            nxt, emitted, done = (int(v) for v in packed[slot])
            if emitted:
                req.output_ids.append(nxt)
                self._gen[slot] += 1
                self._pos[slot] += 1
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
