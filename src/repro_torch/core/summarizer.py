"""Tier-aware rolling context summarization (paper §6).

When the conversation reaches 80% of the TARGET tier's context window,
older messages are compressed into a summary sized for that tier, and
the most recent ``keep_turn_pairs`` turn pairs stay verbatim:

    local: 32K window -> 2K summary + last 3 turn pairs
    hpc:   64K window -> 4K summary + last 6 turn pairs
    cloud: summarization disabled (windows large enough)

The paper generates the summary with the free local model; our stand-in
is deterministic extractive compression (head sentences per message,
clipped to the budget) — same token accounting, zero-cost property
preserved, and the probe experiment (Table 3) reproduces exactly.

**Prefix stability.** The summary block is *append-only*: each head
message compresses to one deterministic line, lines are emitted oldest
first, and the budget cut freezes at the same message on every turn —
so turn N's summary text is always a byte prefix of turn N+1's. Since
the block sits directly after the (stable) system messages, the serving
tiers' radix-tree prefix caches see summarization as *extending* the
cached conversation prefix rather than invalidating it: only the
sliding verbatim tail re-prefills each turn. (The cache salt rides the
request, not this module — summaries are per-conversation content.)

**Token accounting.** ``count_tokens``/``conversation_tokens`` accept
the system tokenizer so the ``needed()``/``fits()`` thresholds agree
with what the engine actually prefills (the conversation is serialized
as one newline-joined prompt with a single BOS —
``core.tiers.canonical_prompt``); without a tokenizer they fall back to
the byte-count heuristic, which overcounts by one per message.
"""

from __future__ import annotations

import queue
import threading
import time as _time
from dataclasses import dataclass


@dataclass(frozen=True)
class SummarizerPolicy:
    context_window: int
    summary_budget: int      # tokens
    keep_turn_pairs: int
    enabled: bool = True
    trigger_frac: float = 0.8
    # room reserved for the response: a serving engine rejects prompts
    # that leave no generation headroom, so "fits" means prompt+headroom
    response_headroom: int = 2048


DEFAULT_POLICIES = {
    "local": SummarizerPolicy(context_window=32_768, summary_budget=2048, keep_turn_pairs=3),
    "hpc": SummarizerPolicy(context_window=65_536, summary_budget=4096, keep_turn_pairs=6),
    "cloud": SummarizerPolicy(context_window=1_048_576, summary_budget=0,
                              keep_turn_pairs=0, enabled=False),
}


def count_tokens(text: str, tokenizer=None) -> int:
    """Token count of one text blob: the system tokenizer when
    available, else the byte-level heuristic (matches the serving
    tokenizer's byte mapping plus a BOS)."""
    if tokenizer is not None:
        return tokenizer.count(text)
    return len(text.encode("utf-8")) + 1


def conversation_tokens(messages, tokenizer=None) -> int:
    """Tokens the engine will actually prefill for this conversation.
    With a tokenizer this counts the real serialized prompt (newline-
    joined contents, ONE BOS — ``core.tiers.canonical_prompt``), so the
    thresholds track whatever tokenizer the system serves with; the
    fallback heuristic charges one token per message byte plus one per
    message (which happens to agree exactly for the byte tokenizer,
    where each uncounted newline separator offsets one per-message
    surcharge — but drifts for any subword tokenizer)."""
    if tokenizer is not None:
        return tokenizer.count(
            "\n".join(m.get("content", "") for m in messages))
    return sum(count_tokens(m.get("content", "")) for m in messages)


def _summary_lines(messages) -> list:
    """One deterministic line per message: first sentence, clipped.
    Pure per-message function — the append-only building block of the
    prefix-stable summary."""
    lines = []
    for m in messages:
        first = m.get("content", "").split(". ")[0][:400]
        lines.append(f"[{m.get('role', 'user')}] {first}")
    return lines


def _clip_to_tokens(text: str, budget: int, tokenizer=None) -> str:
    """Longest prefix of ``text`` that counts to <= ``budget`` tokens —
    binary search on the character cut, measured through the SAME
    counter as the budget (a raw character slice treated tokens as
    characters, overshooting the budget for multi-byte or subword
    tokenizers). Deterministic, so the summary stays prefix-stable."""
    lo, hi = 0, len(text)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if count_tokens(text[:mid], tokenizer) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return text[:lo]


def _extract_summary(messages, budget_tokens: int, tokenizer=None) -> str:
    """Deterministic extractive compression: per-message lines, oldest
    first, until the budget is filled. Append-only across turns: as the
    head grows, earlier lines never change, and once the budget cut
    lands on a message it lands there on every later turn too."""
    parts = []
    used = 0
    for line in _summary_lines(messages):
        t = count_tokens(line, tokenizer)
        if used + t > budget_tokens:
            frag = _clip_to_tokens(line, max(budget_tokens - used, 0),
                                   tokenizer)
            if len(frag) > 16:
                parts.append(frag)
            break
        parts.append(line)
        used += t
    return "\n".join(parts)


class TierAwareSummarizer:
    def __init__(self, policies: dict | None = None, tokenizer=None):
        self.policies = dict(policies or DEFAULT_POLICIES)
        self.tokenizer = tokenizer
        self.n_summarizations = 0

    def needed(self, messages, tier: str) -> bool:
        pol = self.policies[tier]
        if not pol.enabled:
            return False
        return (conversation_tokens(messages, self.tokenizer)
                >= pol.trigger_frac * pol.context_window)

    def apply(self, messages, tier: str):
        """Returns (messages', did_summarize). System messages are kept.
        The emitted summary message is deterministic and append-only
        across turns (see module docstring) so it extends, rather than
        invalidates, the serving tiers' cached conversation prefix."""
        pol = self.policies[tier]
        if not self.needed(messages, tier):
            return list(messages), False
        system = [m for m in messages if m.get("role") == "system"]
        convo = [m for m in messages if m.get("role") != "system"]
        keep = pol.keep_turn_pairs * 2
        head, tail = (convo[:-keep], convo[-keep:]) if keep else (convo, [])
        summary_text = _extract_summary(head, pol.summary_budget,
                                        self.tokenizer)
        summary_msg = {"role": "system",
                       "content": f"[conversation summary — compressed for the "
                                  f"{tier} tier]\n{summary_text}"}
        self.n_summarizations += 1
        return system + [summary_msg] + tail, True

    def fits(self, messages, tier: str) -> bool:
        """Would this conversation fit the tier's window (with room left
        for the response)?"""
        pol = self.policies[tier]
        return (conversation_tokens(messages, self.tokenizer)
                + pol.response_headroom <= pol.context_window)


class SpanSummarizer:
    """Async span summarization for rolling-window serving.

    When a decode slot's rolling window evicts its oldest non-sink pages
    (:class:`repro_torch.serving.scheduler.WindowPolicy`), the scheduler hands
    the evicted span's token ids here and keeps decoding; a single
    worker thread decodes and folds each span into the session's
    **pinned, append-only summary block** — pinned in that it is never
    rolled or evicted for the session's life, append-only so earlier
    summary text never changes once written (the same prefix-stability
    contract as :class:`TierAwareSummarizer`).

    ``submit`` is called on the scheduler thread and must never block:
    it only enqueues. One global FIFO queue drained by one worker gives
    per-session ordering for free — a session that rolls twice before
    its first span is summarized has the second span *queued behind* the
    first, never dropped or reordered. Folding is the repo's
    deterministic extractive stand-in: the span text head-clipped to
    ``span_budget`` tokens (a span at or under the budget folds in
    losslessly), one line per span.
    """

    def __init__(self, tokenizer=None, *, span_budget: int = 160):
        self.tokenizer = tokenizer
        self.span_budget = span_budget
        self.spans_in = 0            # spans enqueued (scheduler thread)
        self.spans_done = 0          # spans folded (worker thread)
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._lines: dict = {}       # rid -> [line, ...] (append-only)
        self._rolled: dict = {}      # rid -> rolled-out token count
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------- producer
    def submit(self, rid: str, span_ids: list):
        """Enqueue one rolled-out span (scheduler thread; non-blocking).
        Empty spans are acknowledged and skipped."""
        if not span_ids:
            return
        with self._lock:
            self.spans_in += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="span-summarizer")
                self._thread.start()
        self._q.put((rid, list(span_ids)))

    # ---------------------------------------------------------- worker
    def _loop(self):
        while True:
            rid, ids = self._q.get()
            try:
                if self.tokenizer is not None:
                    text = self.tokenizer.decode(ids)
                else:
                    text = " ".join(str(i) for i in ids)
                line = _clip_to_tokens(text, self.span_budget, self.tokenizer)
            except Exception:
                line = ""            # a bad span must not kill the worker
            with self._lock:
                if line:
                    self._lines.setdefault(rid, []).append(line)
                self._rolled[rid] = self._rolled.get(rid, 0) + len(ids)
                self.spans_done += 1
                self._idle.notify_all()

    # ---------------------------------------------------------- readers
    def summary(self, rid: str) -> str:
        """The session's summary block so far — one line per folded
        span, oldest first. Always a byte prefix of every later call for
        the same session (append-only)."""
        with self._lock:
            return "\n".join(self._lines.get(rid, []))

    def rolled_tokens(self, rid: str) -> int:
        with self._lock:
            return self._rolled.get(rid, 0)

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every submitted span has been folded (tests and
        benchmarks synchronize on the async path here). Returns False on
        timeout."""
        deadline = _time.monotonic() + timeout
        with self._lock:
            while self.spans_done < self.spans_in:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def drop(self, rid: str):
        """Forget one session's summary state."""
        with self._lock:
            self._lines.pop(rid, None)
            self._rolled.pop(rid, None)
