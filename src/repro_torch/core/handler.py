"""StreamingHandler — the per-query pipeline (paper §2, Figure 1):

    judge -> route -> (summarize for target tier) -> dispatch -> stream
    -> usage log (no content) ; automatic fallback to the next tier in
    the chain on backend failure.

Mid-stream fallback is duplicate-safe: the handler taps ``on_token`` and
counts tokens already delivered to the caller, so when a backend dies
AFTER emitting (a relay teardown halfway through a response), the next
tier in the chain resumes the client-visible stream at the failure point
instead of replaying the prefix (``_ResumeTap``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.judge import Complexity
from repro_torch.core.metrics import UsageTracker
from repro_torch.core.router import TierRouter
from repro_torch.core.summarizer import TierAwareSummarizer, conversation_tokens
from repro_torch.core.tiers import BackendError, TierResult
from repro_torch.serving.sampler import GenerationParams


@dataclass
class HandledQuery:
    result: TierResult
    complexity: Complexity
    tier_used: str
    chain: tuple
    fallback_depth: int
    summarized: bool
    judge_latency_s: float
    resumed_tokens: int = 0   # tokens swallowed after a mid-stream fallback
    cache_hit_tokens: int = 0  # prompt tokens the tier served from KV cache


class _ResumeTap:
    """Token tap making mid-stream fallback duplicate-safe. It forwards
    tokens to the caller's ``on_token`` and counts deliveries; when a new
    backend attempt starts after a failure, the first ``delivered``
    tokens of the replacement stream are swallowed so the client never
    sees the prefix twice."""

    def __init__(self, on_token: Callable[[int, str], None]):
        self._on_token = on_token
        self.delivered = 0       # forwarded to the caller, across attempts
        self.skip = 0            # replacement-stream tokens to swallow
        self._seen = 0           # tokens seen in the CURRENT attempt

    def new_attempt(self):
        self.skip = self.delivered
        self._seen = 0

    def __call__(self, tid: int, text: str):
        self._seen += 1
        if self._seen <= self.skip:
            return
        self.delivered += 1
        self._on_token(tid, text)


class StreamingHandler:
    def __init__(self, router: TierRouter, summarizer: TierAwareSummarizer,
                 tracker: UsageTracker | None = None):
        self.router = router
        self.summarizer = summarizer
        self.tracker = tracker or UsageTracker()

    def handle(self, query: str, history: list | None = None, *,
               override_tier: str | None = None,
               params: GenerationParams | None = None, max_tokens: int = 64,
               on_token: Optional[Callable[[int, str], None]] = None,
               cancel_event=None,
               on_attempt: Optional[Callable] = None,
               cache_salt: str = "", on_meta=None) -> HandledQuery:
        """Run one query through the pipeline. Thread-safe: concurrent
        handle() calls stream through each tier's session broker and
        interleave in its decode batch. ``params`` is the per-request
        :class:`GenerationParams` contract (the legacy ``max_tokens``
        kwarg is folded into it). ``cancel_event`` (a threading.Event)
        tears the in-flight stream down mid-generation and frees its
        decode slot. ``on_attempt(tier, depth, decision)`` fires just
        before each backend dispatch — the gateway uses it to expose
        routing metadata before the first token arrives. ``cache_salt``
        namespaces the serving tiers' prefix caches per tenant, and
        ``on_meta`` surfaces the admission's prefix-cache hit (fired by
        the serving backend just before its first token)."""
        params = GenerationParams.of(params, max_tokens=max_tokens)
        history = list(history or [])
        decision = self.router.route(query, override_tier=override_tier)
        if not decision.chain:
            raise BackendError("no healthy tier available")

        tap = _ResumeTap(on_token) if on_token is not None else None
        last_err: Exception | None = None
        for depth, tier in enumerate(decision.chain):
            backend = self.router.backends[tier]
            messages = history + [{"role": "user", "content": query}]
            # tier-aware summarization against the *target* tier's window
            messages, summarized = self.summarizer.apply(messages, tier)
            if not self.summarizer.fits(messages, tier):
                last_err = BackendError(f"context exceeds {tier} window even "
                                        f"after summarization")
                continue
            if on_attempt is not None:
                on_attempt(tier, depth, decision)
            if tap is not None:
                tap.new_attempt()
            try:
                result = backend.stream(messages, params=params,
                                        on_token=tap,
                                        cancel_event=cancel_event,
                                        cache_salt=cache_salt,
                                        on_meta=on_meta)
            except BackendError as e:
                last_err = e
                continue
            self.tracker.record(
                tier=tier, model=result.model, complexity=decision.complexity.name,
                prompt_tokens=result.n_prompt_tokens,
                completion_tokens=result.n_completion_tokens,
                cost_usd=result.cost_usd, ttft_s=result.ttft_s,
                total_s=result.total_s, streamed=result.streamed,
                fallback_depth=depth, judge_latency_s=decision.judge_latency_s)
            return HandledQuery(result=result, complexity=decision.complexity,
                                tier_used=tier, chain=decision.chain,
                                fallback_depth=depth, summarized=summarized,
                                judge_latency_s=decision.judge_latency_s,
                                resumed_tokens=tap.skip if tap else 0,
                                cache_hit_tokens=result.prefix_hit_tokens)
        raise BackendError(f"all tiers failed; last error: {last_err}")

    def route_only(self, query: str, history: list | None = None) -> str:
        """Which tier WOULD serve this query (Table-3 probe experiment):
        first tier in the chain whose window fits the (possibly
        summarized) conversation."""
        history = list(history or [])
        decision = self.router.route(query)
        for tier in decision.chain:
            messages = history + [{"role": "user", "content": query}]
            messages, _ = self.summarizer.apply(messages, tier)
            if self.summarizer.fits(messages, tier):
                return tier
        return decision.chain[-1] if decision.chain else "none"
