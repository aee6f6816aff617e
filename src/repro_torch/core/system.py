"""Assemble a full STREAM deployment on the port's engines: tiers,
judge, router, summarizer, handler, gateway (+ the deprecated proxy
shim) — server mode (all components) in one call.

The HPC tier's endpoint gets the tier engine + relay handle injected as
worker globals (the vLLM-over-localhost analogue) and the credentials
pre-provisioned via worker_init_env — the same trust topology as the
paper: secrets live on the endpoint and the proxy, never in task args.
"""

from __future__ import annotations

import base64
import secrets as _secrets
from dataclasses import dataclass

from repro_torch.configs import get_smoke_config
from repro_torch.core.auth import ApiKeyStore, DualAuthenticator, GlobusAuthService, SlidingWindowRateLimiter
from repro_torch.core.control_plane import ComputeEndpoint
from repro_torch.core.crypto import new_key
from repro_torch.core.data_plane import TokenProducer, produce_tokens
from repro_torch.core.gateway import StreamGateway
from repro_torch.core.handler import StreamingHandler
from repro_torch.core.judge import CachedJudge, KeywordJudge
from repro_torch.core.metrics import UsageTracker
from repro_torch.core.proxy import HPCAsAPIProxy
from repro_torch.core.relay import Relay
from repro_torch.core.router import TierRouter
from repro_torch.core.summarizer import DEFAULT_POLICIES, TierAwareSummarizer
from repro_torch.core.tiers import CloudBackend, HPCBackend, LocalBackend, TierSpec
from repro_torch.models import build_model
from repro_torch.serving import EngineFleet, ServingEngine, resolve_device
from repro_torch.serving.quantize import quantize_mlp_tree


@dataclass
class StreamSystem:
    handler: StreamingHandler
    router: TierRouter
    summarizer: TierAwareSummarizer
    tracker: UsageTracker
    relay: Relay
    endpoint: ComputeEndpoint
    proxy: HPCAsAPIProxy            # deprecated shim (HPC tier only)
    globus: GlobusAuthService
    api_keys: ApiKeyStore
    backends: dict
    engines: dict
    gateway: StreamGateway = None   # the OpenAI facade over ALL tiers


def build_system(*, relay_enabled: bool = True, encrypt: bool = True,
                 dispatch_latency_s: float = 0.05, cloud_ttft_s: float = 0.03,
                 judge=None, local_arch: str = "xlstm-125m",
                 hpc_arch: str = "minitron-8b", max_seq: int = 128,
                 summarizer_policies: dict | None = None,
                 hpc_fail: bool = False, cloud_fail: bool = False,
                 rate_limit: int = 1000, scheduler_slots: int = 8,
                 hpc_workers: int = 8, hpc_overrides: dict | None = None,
                 local_overrides: dict | None = None,
                 prefix_cache_pages: int = 256,
                 speculative: bool = False,
                 spec_k: int = 4, replicas: int = 1,
                 fleet_overrides: dict | None = None,
                 kv_dtype: str = "fp32",
                 quantize_mlp: bool = False, device=None) -> StreamSystem:
    """Everything wired: both tier engines on ``device`` (default the
    CUDA card; ``device="cpu"`` for the tests), smoke-scale models unless
    ``hpc_overrides``/``local_overrides`` widen them.

    ``scheduler_slots`` sizes each tier engine's session broker;
    ``hpc_workers`` sizes the control-plane worker pool (the workers
    only shepherd relay traffic; decode work is batched on the HPC
    engine's broker thread).

    ``kv_dtype`` ("fp32" | "int8" | "fp8_e4m3") selects the paged KV
    pool's storage on both tier engines: int8 / fp8 codes with float32
    per-position scales, dequantized inside the paged-attention kernel.
    ``quantize_mlp=True`` serves both tiers with W4A16 AWQ weights
    (gated MLP and attention ``wo``, group 64): the paper's
    Qwen-72B-AWQ HPC tier. Each tier's dense params are built on
    ``device``, quantized once there, and dropped.

    ``speculative=True`` turns on speculative decoding per tier, as in
    the JAX package: the local tier self-drafts with prompt-lookup
    n-grams, and the HPC tier verifies drafts from the LOCAL tier's model
    (params and all: the cross-tier pairing) when that model implements
    ``propose_k``; a recurrent local tier (the default xLSTM) leaves the
    HPC tier on n-gram drafts. Output tokens are the same either way.

    ``replicas=N`` (N > 1) puts an :class:`~repro_torch.serving.EngineFleet`
    of N local engines behind the local tier (and the cloud tier's token
    source), all on ``device``: the N - 1 peers share replica 0's params
    (quantized ones included), so a failed-over stream is the same
    tokens. Cache-aware routing, work stealing and mid-stream failover
    stay behind the tier/gateway contract. ``fleet_overrides`` tunes the
    fleet (``steal_threshold``, ``tick_timeout_s``, ...)."""
    device = resolve_device(device)

    # --- engines (the per-tier model servers) ---
    # vocab >= 259 so the byte tokenizer can round-trip real text
    local_cfg = get_smoke_config(local_arch).replace(vocab_size=384)
    hpc_cfg = get_smoke_config(hpc_arch).replace(vocab_size=384)
    if hpc_overrides:
        hpc_cfg = hpc_cfg.replace(**hpc_overrides)
    if local_overrides:
        local_cfg = local_cfg.replace(**local_overrides)
    if quantize_mlp and (hpc_cfg.is_encoder_decoder or local_cfg.is_encoder_decoder):
        raise NotImplementedError(
            "W4A16 (quantize_mlp) is not ported for the encoder-decoder family: the JAX "
            "package multiplies its cross-attention output projection densely and cannot "
            "take a quantized one")
    def params_for(cfg):
        # W4A16: init the params the engine would build itself and quantize
        # them once with group 64 (it fits smoke-scale contraction dims; what
        # does not divide stays dense), in place, so each dense stack goes
        # as its quantized copy lands
        if not quantize_mlp:
            return None
        return quantize_mlp_tree(build_model(cfg).init(0, device), group_size=64,
                                 in_place=True)

    spec_local = spec_hpc = {}
    if speculative:
        spec_local = {"speculative": "ngram", "spec_k": spec_k}
        spec_hpc = dict(spec_local)
    local_engine = ServingEngine(local_cfg, params=params_for(local_cfg),
                                 max_seq=max_seq, seed=0,
                                 scheduler_slots=scheduler_slots,
                                 prefix_cache_pages=prefix_cache_pages,
                                 kv_dtype=kv_dtype, device=device, **spec_local)
    local_tier_engine = local_engine
    if replicas > 1:
        peers = [ServingEngine(local_cfg, params=local_engine.params, max_seq=max_seq,
                               seed=0, scheduler_slots=scheduler_slots,
                               prefix_cache_pages=prefix_cache_pages, kv_dtype=kv_dtype,
                               device=device, **spec_local)
                 for _ in range(replicas - 1)]
        local_tier_engine = EngineFleet([local_engine] + peers, **(fleet_overrides or {}))
    if speculative and hasattr(local_engine.model, "propose_k"):
        # cross-tier: the local tier's model (params and all) drafts for
        # the HPC tier's verifier
        spec_hpc = {"drafter_cfg": local_cfg, "drafter_params": local_engine.params,
                    "spec_k": spec_k}
    hpc_engine = ServingEngine(hpc_cfg, params=params_for(hpc_cfg),
                               max_seq=max_seq, seed=0,
                               scheduler_slots=scheduler_slots,
                               prefix_cache_pages=prefix_cache_pages,
                               kv_dtype=kv_dtype, device=device, **spec_hpc)
    local_tier_engine.warmup()
    hpc_engine.warmup()

    # --- data plane ---
    relay_secret = _secrets.token_urlsafe(24)
    enc_key = new_key() if encrypt else None
    relay = Relay(relay_secret) if relay_enabled else None

    # --- control plane: credentials pre-provisioned, engine injected ---
    worker_env = {"RELAY_SECRET": relay_secret}
    if enc_key is not None:
        worker_env["RELAY_ENCRYPTION_KEY"] = base64.b64encode(enc_key).decode()
    endpoint = ComputeEndpoint(
        "lakeshore-gpu", worker_init_env=worker_env,
        dispatch_latency_s=dispatch_latency_s, n_workers=hpc_workers,
        extra_globals={"ENGINE": hpc_engine, "RELAY": relay,
                       "PRODUCE_TOKENS": produce_tokens,
                       "TOKEN_PRODUCER": TokenProducer})
    if hpc_fail:
        endpoint.shutdown()

    # --- tiers ---
    specs = {
        "local": TierSpec("local", "llama-3.2-3b(sim)", 32_768),
        "hpc": TierSpec("hpc", "qwen2.5-vl-72b-awq(sim)", 65_536),
        "cloud": TierSpec("cloud", "claude-sonnet-4-6(sim)", 1_048_576,
                          cost_per_1k_prompt=0.003, cost_per_1k_completion=0.015),
    }
    backends = {
        "local": LocalBackend(specs["local"], local_tier_engine),
        "hpc": HPCBackend(specs["hpc"], endpoint, relay, relay_secret, enc_key),
        "cloud": CloudBackend(specs["cloud"], ttft_s=cloud_ttft_s,
                              engine=local_tier_engine, fail=cloud_fail),
    }

    # --- routing / summarization / handler ---
    judge = judge or CachedJudge(KeywordJudge())
    router = TierRouter(backends, judge)
    # token accounting against the REAL tokenizer, so needed()/fits()
    # thresholds agree with what the engines actually prefill
    summarizer = TierAwareSummarizer(summarizer_policies or DEFAULT_POLICIES,
                                     tokenizer=local_engine.tokenizer)
    tracker = UsageTracker()
    handler = StreamingHandler(router, summarizer, tracker)

    # --- OpenAI-compatible facade ---
    globus = GlobusAuthService()
    api_keys = ApiKeyStore()
    authenticator = DualAuthenticator(globus, api_keys)
    # the gateway fronts the FULL routed pipeline (stream-auto/-local/
    # -hpc/-cloud aliases); the deprecated proxy shim keeps the old
    # single-tier call surface alive. Separate limiters so a caller's
    # budget isn't double-counted across the two entry points.
    gateway = StreamGateway(handler, authenticator,
                            SlidingWindowRateLimiter(max_requests=rate_limit))
    proxy = HPCAsAPIProxy(backends["hpc"], authenticator,
                          SlidingWindowRateLimiter(max_requests=rate_limit))

    return StreamSystem(handler=handler, router=router, summarizer=summarizer,
                        tracker=tracker, relay=relay, endpoint=endpoint,
                        proxy=proxy, globus=globus, api_keys=api_keys,
                        backends=backends,
                        engines={"local": local_tier_engine, "hpc": hpc_engine},
                        gateway=gateway)
