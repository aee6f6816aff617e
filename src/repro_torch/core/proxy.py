"""DEPRECATED — ``HPCAsAPIProxy`` survives as a thin shim over
:class:`repro_torch.core.gateway.StreamGateway`.

The proxy (paper §4) wrapped exactly one backend behind an
OpenAI-compatible endpoint. The gateway generalizes it: the same
middleware (auth -> rate limit -> validation -> audit) in front of the
FULL judge/route/summarize/fallback pipeline, with model-alias routing
over all tiers. New code should build a :class:`StreamGateway` (see
``build_system(...).gateway``); this shim keeps the old constructor and
``handle_chat_completions`` call surface working by pinning every
request to the wrapped backend's tier through a single-tier handler.

``ValidationError`` / ``validate_chat_request`` / ``ProxyResponse`` are
re-exported from the gateway, where the shared middleware now lives.
"""

from __future__ import annotations

from repro_torch.core.auth import DualAuthenticator, SlidingWindowRateLimiter
from repro_torch.core.gateway import (MAX_CONTENT_CHARS, MAX_MESSAGES, VALID_ROLES,
                                GatewayResponse, StreamGateway,
                                ValidationError, validate_chat_request)
from repro_torch.core.handler import StreamingHandler
from repro_torch.core.metrics import UsageTracker
from repro_torch.core.router import TierRouter
from repro_torch.core.summarizer import (DEFAULT_POLICIES, SummarizerPolicy,
                                   TierAwareSummarizer)

# legacy name for the response envelope
ProxyResponse = GatewayResponse


class HPCAsAPIProxy:
    """Deprecated single-backend facade; use ``StreamGateway`` instead.

    Every request routes to the wrapped backend's tier (no judge, no
    cross-tier fallback — exactly the old proxy's semantics). Any
    ``model`` string is accepted and echoed back, as before."""

    def __init__(self, backend, authenticator: DualAuthenticator,
                 rate_limiter: SlidingWindowRateLimiter | None = None):
        self.backend = backend
        self.auth = authenticator
        self.limiter = rate_limiter or SlidingWindowRateLimiter()
        tier = backend.spec.name
        router = TierRouter({tier: backend}, judge=None)  # override-only
        policy = DEFAULT_POLICIES.get(tier) or SummarizerPolicy(
            context_window=backend.spec.context_window,
            summary_budget=2048, keep_turn_pairs=4)
        handler = StreamingHandler(router, TierAwareSummarizer({tier: policy}),
                                   UsageTracker())
        self._gateway = StreamGateway(
            handler, authenticator, self.limiter,
            aliases={backend.spec.model_name: tier, f"stream-{tier}": tier},
            default_model=backend.spec.model_name, default_tier=tier,
            strict_models=False)

    @property
    def audit_log(self) -> list:
        """A list snapshot of the gateway's bounded audit deque — old
        callers sliced and json.dumps'ed a plain list, and a deque
        supports neither; note the gateway bounds it, so the oldest
        entries eventually age out."""
        return list(self._gateway.audit_log)

    def handle_chat_completions(self, request: dict, *, bearer: str | None,
                                client_ip: str = "0.0.0.0") -> ProxyResponse:
        return self._gateway.handle_chat_completions(
            request, bearer=bearer, client_ip=client_ip)
