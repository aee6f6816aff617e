"""STREAM's contribution (PyTorch port): three-tier routing, dual-channel streaming,
tier-aware summarization, and the unified OpenAI-compatible gateway
(plus the deprecated single-tier HPC-as-API proxy shim)."""

from repro_torch.core.crypto import AESGCM, InvalidTag, new_key
from repro_torch.core.relay import Relay, AuthError, RelayError, new_channel_id
from repro_torch.core.control_plane import ComputeEndpoint, TaskFailed, submit_with_retries
from repro_torch.core.data_plane import TokenProducer, consume_tokens, produce_tokens
from repro_torch.core.judge import Complexity, KeywordJudge, FeatureJudge, CachedJudge
from repro_torch.core.summarizer import TierAwareSummarizer, SummarizerPolicy, DEFAULT_POLICIES
from repro_torch.core.router import TierRouter, FALLBACK_CHAINS
from repro_torch.core.handler import StreamingHandler
from repro_torch.core.tiers import (TierSpec, TierResult, TierBackend, LocalBackend,
                              HPCBackend, CloudBackend, BackendError)
from repro_torch.errors import SchedulerStopped
from repro_torch.core.auth import (GlobusAuthService, ApiKeyStore, DualAuthenticator,
                             SlidingWindowRateLimiter, AuthFailure)
from repro_torch.core.gateway import (StreamGateway, GatewayResponse, ValidationError,
                                validate_chat_request, DEFAULT_ALIASES)
from repro_torch.core.proxy import HPCAsAPIProxy
from repro_torch.core.metrics import FleetMetrics, RoutingDecision, UsageTracker
from repro_torch.core.system import StreamSystem, build_system
from repro_torch.serving.sampler import GenerationParams

__all__ = [
    "AESGCM", "InvalidTag", "new_key",
    "Relay", "AuthError", "RelayError", "new_channel_id",
    "ComputeEndpoint", "TaskFailed", "submit_with_retries",
    "TokenProducer", "consume_tokens", "produce_tokens",
    "Complexity", "KeywordJudge", "FeatureJudge", "CachedJudge",
    "TierAwareSummarizer", "SummarizerPolicy", "DEFAULT_POLICIES",
    "TierRouter", "FALLBACK_CHAINS", "StreamingHandler",
    "TierSpec", "TierResult", "TierBackend",
    "LocalBackend", "HPCBackend", "CloudBackend", "BackendError",
    "SchedulerStopped", "FleetMetrics", "RoutingDecision",
    "GlobusAuthService", "ApiKeyStore", "DualAuthenticator",
    "SlidingWindowRateLimiter", "AuthFailure",
    "StreamGateway", "GatewayResponse", "ValidationError",
    "validate_chat_request", "DEFAULT_ALIASES", "GenerationParams",
    "HPCAsAPIProxy", "UsageTracker",
    "StreamSystem", "build_system",
]
