"""The three inference tiers (paper §2.1), backed by the serving engine.

  * LocalBackend — in-process engine (the Ollama analogue).
  * HPCBackend — the FULL dual-channel path: a control-plane task is
    submitted to the ComputeEndpoint (batch semantics, dispatch
    latency); the remote function generates with the cluster-side
    engine and pushes each token outbound to the relay; the proxy-side
    consumer (opened *before* dispatch, as in the paper) streams them
    to the caller. If the relay is down -> batch fallback: the full
    response returns via the control plane and TTFT == total time.
  * CloudBackend — simulated commercial API: configurable TTFT/rate
    latency model + real per-token cost accounting (no network here).

All backends implement the :class:`TierBackend` protocol:
stream(messages, params=GenerationParams, on_token, cancel_event)
-> TierResult, plus health_check(). ``params`` is the first-class
generation contract (temperature / top_p / stop / seed / max_tokens)
threaded from the gateway down to the engine's sampler; the legacy
``max_tokens=`` kwarg is still accepted and folded into it.

Concurrency: every backend streams through the engine's session broker
(``ServingEngine.submit``) rather than a blocking ``generate`` call, so
N concurrent ``stream()`` calls — N proxy sessions, N handler threads —
interleave their decode ticks in one shared continuous batch instead of
serializing on the engine. ``cancel_event`` (set by the caller, e.g. an
SSE client disconnect) tears the session down mid-stream and frees its
decode slot.
"""

from __future__ import annotations

import base64
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, runtime_checkable

from repro_torch.core.control_plane import ComputeEndpoint, TaskFailed
from repro_torch.core.data_plane import (REMOTE_FN_NAME, REMOTE_FN_SOURCE,
                                   consume_tokens, produce_tokens)
from repro_torch.errors import BackendError, SchedulerStopped
from repro_torch.core.relay import Relay, new_channel_id
from repro_torch.serving.sampler import GenerationParams


@dataclass(frozen=True)
class TierSpec:
    name: str                      # local | hpc | cloud
    model_name: str
    context_window: int
    cost_per_1k_prompt: float = 0.0
    cost_per_1k_completion: float = 0.0


@dataclass
class TierResult:
    tier: str
    model: str
    text: str
    n_prompt_tokens: int
    n_completion_tokens: int
    ttft_s: float
    total_s: float
    tok_per_s: float
    cost_usd: float
    streamed: bool
    finish_reason: str = "stop"    # "stop" | "length" | "cancelled"
    error: Optional[str] = None
    prefix_hit_tokens: int = 0     # prompt tokens served from the KV cache


@runtime_checkable
class TierBackend(Protocol):
    """The backend contract every tier implements — what the router,
    handler, and gateway program against. ``stream`` MUST honor
    ``params`` (sampling + stop + max_tokens), fire ``on_token`` per
    generated token on whatever thread produces it, and tear the
    session down (freeing its decode slot) when ``cancel_event`` is
    set. ``cache_salt`` namespaces the serving engine's prefix cache
    per tenant (the gateway derives it from the authenticated
    principal); ``on_meta`` fires once before the first token with
    ``{"prefix_hit_tokens": n}``. ``health_check`` must be cheap
    (~100 ms auth ping at most) — it runs at routing time for every
    query."""

    spec: TierSpec

    def stream(self, messages, *, params: GenerationParams | None = None,
               max_tokens: int | None = None,
               on_token: Optional[Callable[[int, str], None]] = None,
               cancel_event=None, cache_salt: str = "",
               on_meta=None) -> TierResult: ...

    def health_check(self) -> bool: ...


def _resolve_params(params, max_tokens) -> GenerationParams:
    """Transitional shim: fold the legacy ``max_tokens`` kwarg into the
    params contract (an explicit GenerationParams always wins)."""
    return GenerationParams.of(params, max_tokens=max_tokens)


def canonical_prompt(messages) -> str:
    """THE deterministic chat-messages -> engine-prompt serialization,
    shared by every tier backend. Stability matters beyond aesthetics:
    turn N's serialized conversation must be a byte prefix of turn
    N+1's, so the engines' radix-tree prefix caches see multi-turn
    follow-ups (and shared system prompts) as cache hits rather than
    fresh prefills."""
    return "\n".join(m.get("content", "") for m in messages)


_join_messages = canonical_prompt      # legacy alias


class LocalBackend:
    """Free, private, on-device (paper: Ollama / Llama 3.2 3B).

    Streams through the engine's session broker, so concurrent local
    queries share one decode batch."""

    def __init__(self, spec: TierSpec, engine, *, timeout_s: float = 120.0):
        self.spec = spec
        self.engine = engine
        self.timeout_s = timeout_s

    def health_check(self) -> bool:
        return True

    def stream(self, messages, *, params=None, max_tokens=None, on_token=None,
               cancel_event=None, cache_salt: str = "",
               on_meta=None) -> TierResult:
        gp = _resolve_params(params, max_tokens)
        t0 = time.perf_counter()
        prompt = canonical_prompt(messages)
        box = {}
        handle_box = {}

        def cb(tid, text):
            if "ttft" not in box:
                box["ttft"] = time.perf_counter() - t0
            if cancel_event is not None and cancel_event.is_set():
                h = handle_box.get("h")
                if h is not None:
                    h.cancel()
                return
            if on_token:
                on_token(tid, text)

        handle = self.engine.submit(prompt, params=gp, on_token=cb,
                                    cache_salt=cache_salt, on_meta=on_meta)
        handle_box["h"] = handle
        try:
            res = handle.result(timeout=self.timeout_s)
        except TimeoutError as e:
            handle.cancel()          # don't leak the decode slot
            raise BackendError(f"local session timed out: {e}") from e
        if res.cancelled and not (cancel_event is not None
                                  and cancel_event.is_set()):
            # the broker cancelled us (scheduler fault, dead callback) —
            # NOT the caller: surface it so the handler falls back to
            # the next tier instead of returning a truncated 200
            raise BackendError(
                f"local session failed: {res.error or 'cancelled by broker'}")
        total = time.perf_counter() - t0
        return TierResult(
            tier=self.spec.name, model=self.spec.model_name, text=res.text,
            n_prompt_tokens=res.n_prompt, n_completion_tokens=res.n_generated,
            ttft_s=box.get("ttft", total), total_s=total,
            tok_per_s=res.n_generated / max(total - box.get("ttft", 0.0), 1e-9),
            cost_usd=0.0, streamed=True, finish_reason=res.finish_reason,
            error="cancelled" if res.cancelled else None,
            prefix_hit_tokens=res.prefix_hit_tokens)


class HPCBackend:
    """Institutional HPC behind the dual-channel architecture (paper §3)."""

    def __init__(self, spec: TierSpec, endpoint: ComputeEndpoint,
                 relay: Optional[Relay], relay_secret: str,
                 enc_key: bytes | None = None, task_timeout_s: float = 120.0):
        self.spec = spec
        self.endpoint = endpoint
        self.relay = relay
        self._secret = relay_secret       # held by the proxy side only
        self._enc_key = enc_key
        self.task_timeout_s = task_timeout_s
        self.relay_enabled = relay is not None

    def health_check(self) -> bool:
        """Lightweight auth check (~100 ms) — NOT a full task round-trip."""
        return self.endpoint.health_check()

    def stream(self, messages, *, params=None, max_tokens=None, on_token=None,
               cancel_event=None, cache_salt: str = "",
               on_meta=None) -> TierResult:
        gp = _resolve_params(params, max_tokens)
        if self.relay_enabled and self.relay is not None:
            return self._stream_relay(messages, gp, on_token, cancel_event,
                                      cache_salt, on_meta)
        return self._batch_fallback(messages, gp, on_token, cache_salt, on_meta)

    # ---- dual-channel path ----
    def _stream_relay(self, messages, gp: GenerationParams, on_token,
                      cancel_event=None, cache_salt: str = "",
                      on_meta=None) -> TierResult:
        t0 = time.perf_counter()
        # (1) fresh UUID channel per query
        channel_id = new_channel_id()
        # (2) submit the control-plane task with the channel id as an arg
        #     (no credentials in args — pre-provisioned worker env; the
        #     generation params ride as a plain JSON-able dict, the
        #     tenant's cache salt alongside them).
        fut = self.endpoint.submit(
            REMOTE_FN_SOURCE, REMOTE_FN_NAME,
            messages=[{"role": m.get("role", "user"), "content": m.get("content", "")}
                      for m in messages],
            model=self.spec.model_name, channel_id=channel_id,
            max_tokens=gp.max_tokens, gen_params=gp.to_dict(),
            cache_salt=cache_salt,
            relay_url="wss://relay.example/ws",
            vllm_url="http://127.0.0.1:8000/v1")
        # (3) immediately open the consumer — it is usually waiting before
        #     the first token arrives (dispatch takes a few hundred ms).
        pieces = []
        ttft = None
        n = 0
        hit = 0
        cancelled = False
        try:
            for payload in consume_tokens(self.relay, channel_id, self._secret,
                                          self._enc_key, timeout_s=self.task_timeout_s):
                if payload.get("t") == "meta":
                    # in-band cache metadata rides the channel ahead of
                    # the first token — not a token, no TTFT stamp
                    hit = int(payload.get("prefix_hit_tokens", 0))
                    if on_meta:
                        on_meta({"prefix_hit_tokens": hit})
                    continue
                if ttft is None:
                    ttft = time.perf_counter() - t0
                n += 1
                pieces.append(payload.get("text", ""))
                if on_token:
                    on_token(payload.get("id", 0), payload.get("text", ""))
                if cancel_event is not None and cancel_event.is_set():
                    # breaking out closes the consumer connection (the
                    # generator's finally); the relay then refuses the
                    # producer's next send, which cancels the remote
                    # session and frees its decode slot.
                    cancelled = True
                    break
            if not cancelled:
                result = fut.result(timeout=self.task_timeout_s)
        except Exception as e:
            raise BackendError(f"dual-channel stream failed: {e}") from e
        total = time.perf_counter() - t0
        ttft = ttft if ttft is not None else total
        text = "".join(pieces) if cancelled else result.get("text", "".join(pieces))
        finish = ("cancelled" if cancelled
                  else result.get("finish_reason", "stop") or "stop")
        if not cancelled:
            hit = int(result.get("prefix_hit_tokens", hit) or hit)
        return TierResult(
            tier=self.spec.name, model=self.spec.model_name, text=text,
            n_prompt_tokens=sum(len(m.get("content", "")) for m in messages),
            n_completion_tokens=n, ttft_s=ttft, total_s=total,
            tok_per_s=n / max(total - ttft, 1e-9), cost_usd=0.0, streamed=True,
            finish_reason=finish, error="cancelled" if cancelled else None,
            prefix_hit_tokens=hit)

    # ---- batch fallback (relay unavailable; paper §7.2 row 3) ----
    def _batch_fallback(self, messages, gp: GenerationParams, on_token,
                        cache_salt: str = "", on_meta=None) -> TierResult:
        t0 = time.perf_counter()
        fut = self.endpoint.submit(
            REMOTE_FN_SOURCE, REMOTE_FN_NAME,
            messages=list(messages), model=self.spec.model_name,
            channel_id=new_channel_id(), max_tokens=gp.max_tokens,
            gen_params=gp.to_dict(), cache_salt=cache_salt)
        try:
            result = fut.result(timeout=self.task_timeout_s)
        except TaskFailed as e:
            raise BackendError(f"hpc batch task failed: {e}") from e
        total = time.perf_counter() - t0
        text = result.get("text", "")
        hit = int(result.get("prefix_hit_tokens", 0) or 0)
        if on_meta:
            on_meta({"prefix_hit_tokens": hit})
        if on_token:  # entire payload arrives at once
            on_token(-1, text)
        n = result.get("n_tokens", 0)
        return TierResult(
            tier=self.spec.name, model=self.spec.model_name, text=text,
            n_prompt_tokens=sum(len(m.get("content", "")) for m in messages),
            n_completion_tokens=n, ttft_s=total, total_s=total,  # TTFT == total
            tok_per_s=n / max(total, 1e-9), cost_usd=0.0, streamed=False,
            finish_reason=result.get("finish_reason", "stop") or "stop",
            prefix_hit_tokens=hit)


class CloudBackend:
    """Simulated commercial API (OpenRouter analogue): latency model +
    real cost accounting. The only paid tier."""

    def __init__(self, spec: TierSpec, *, ttft_s: float = 0.05,
                 tok_per_s: float = 400.0, fail: bool = False, engine=None,
                 timeout_s: float = 120.0):
        self.spec = spec
        self.ttft_s = ttft_s
        self.tok_per_s = tok_per_s
        self.fail = fail
        self.engine = engine  # optional: real generation for token content
        self.timeout_s = timeout_s

    def health_check(self) -> bool:
        return not self.fail

    def stream(self, messages, *, params=None, max_tokens=None, on_token=None,
               cancel_event=None, cache_salt: str = "",
               on_meta=None) -> TierResult:
        gp = _resolve_params(params, max_tokens)
        if self.fail:
            raise BackendError("cloud API unreachable")
        t0 = time.perf_counter()
        prompt = canonical_prompt(messages)
        handle = None
        done_box = {}
        if self.engine is not None:
            # real token content rides the shared decode batch; the
            # latency model below only paces *delivery*, so concurrent
            # cloud sessions don't serialize on the engine either
            import queue as _q
            q: _q.Queue = _q.Queue()

            def _done(res):
                done_box["finish"] = res.finish_reason
                if res.cancelled:
                    done_box["fault"] = res.error or "cancelled by broker"
                q.put(None)

            handle = self.engine.submit(
                prompt, params=gp,
                on_token=lambda tid, text: q.put((tid, text)),
                on_done=_done, cache_salt=cache_salt, on_meta=on_meta)

            def _iter(h=handle):
                while True:
                    try:
                        item = q.get(timeout=self.timeout_s)
                    except _q.Empty:
                        h.cancel()   # wedged session: free the slot
                        raise BackendError(
                            f"cloud session stalled > {self.timeout_s}s")
                    if item is None:
                        return
                    yield item

            token_iter = _iter()
        else:
            token_iter = ((i, f"cloud-token-{i} ") for i in range(gp.max_tokens))
        time.sleep(self.ttft_s)
        ttft = time.perf_counter() - t0
        out = []
        n_comp = 0
        cancelled = False
        for tid, text in token_iter:
            if cancel_event is not None and cancel_event.is_set():
                if handle is not None:
                    handle.cancel()
                cancelled = True
                break
            out.append(text)
            n_comp += 1
            if on_token:
                on_token(tid, text)
            time.sleep(1.0 / self.tok_per_s)
        if done_box.get("fault") and not cancelled and not (
                cancel_event is not None and cancel_event.is_set()):
            # engine-side fault, not a caller cancel: fall back, don't
            # bill the caller for a truncated completion
            raise BackendError(f"cloud session failed: {done_box['fault']}")
        total = time.perf_counter() - t0
        n_prompt = len(prompt.encode()) + 1
        cost = (n_prompt * self.spec.cost_per_1k_prompt
                + n_comp * self.spec.cost_per_1k_completion) / 1000.0
        finish = ("cancelled" if cancelled
                  else done_box.get("finish") or "length")
        return TierResult(
            tier=self.spec.name, model=self.spec.model_name, text="".join(out),
            n_prompt_tokens=n_prompt, n_completion_tokens=n_comp,
            ttft_s=ttft, total_s=total, tok_per_s=n_comp / max(total - ttft, 1e-9),
            cost_usd=cost, streamed=True, finish_reason=finish,
            error="cancelled" if cancelled else None,
            prefix_hit_tokens=handle.prefix_hit_tokens if handle is not None else 0)
