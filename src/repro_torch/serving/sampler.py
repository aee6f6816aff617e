"""Token samplers + the per-request generation-params contract.

``SamplerConfig`` is the ENGINE default (greedy / temperature / top-k /
top-p, vocab-mask aware). ``GenerationParams`` is the PER-REQUEST
contract threaded end to end — gateway -> handler -> tier backend ->
broker -> this module — replacing the old ad-hoc ``max_tokens``-only
kwargs. A field left ``None`` inherits the engine default, so existing
callers are unaffected.

The continuous batcher mixes requests with different params in one
fused device step, so ``sample_slots`` samples every decode slot with
its OWN temperature / top-p / seed in one call.

Stochastic draws use ``torch.Generator``s and Gumbel-max sampling. They
are not bitwise the JAX package's threefry streams (a known difference,
ROADMAP queue 3): a seeded request reproduces within the port, keyed on
(seed, step), whatever other sessions share its batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0    # 0 -> greedy
    top_k: int = 0              # 0 -> full softmax
    top_p: float = 1.0          # 1 -> nucleus filtering disabled
    vocab_size: int = 0         # mask padded logits beyond this


@dataclass(frozen=True)
class GenerationParams:
    """Per-request generation contract (the OpenAI chat-completions
    subset the gateway exposes). ``None`` means "inherit the engine's
    SamplerConfig default"; ``stop`` strings are matched host-side
    against the decoded stream tail; ``seed`` pins the request's sample
    stream independent of batch composition."""
    max_tokens: int = 64
    temperature: float | None = None
    top_p: float | None = None
    stop: tuple = ()
    seed: int | None = None

    @classmethod
    def from_request(cls, req: dict, *, default_max_tokens: int = 64) -> "GenerationParams":
        """Build from a (pre-validated) chat-completions request body."""
        stop = req.get("stop") or ()
        if isinstance(stop, str):
            stop = (stop,)
        return cls(
            max_tokens=int(req.get("max_tokens", default_max_tokens)),
            temperature=(float(req["temperature"]) if req.get("temperature")
                         is not None else None),
            top_p=float(req["top_p"]) if req.get("top_p") is not None else None,
            stop=tuple(stop),
            seed=int(req["seed"]) if req.get("seed") is not None else None)

    @classmethod
    def of(cls, params: "GenerationParams | dict | None", *,
           max_tokens: int | None = None) -> "GenerationParams":
        """Normalize the transitional call surface: an explicit params
        object wins; a dict (the control-plane wire form) is rebuilt; a
        bare legacy ``max_tokens`` becomes a params object."""
        if isinstance(params, dict):
            params = cls(**{k: (tuple(v) if k == "stop" else v)
                            for k, v in params.items()})
        if params is not None:
            return params
        return cls(max_tokens=max_tokens if max_tokens is not None else 64)

    def to_dict(self) -> dict:
        """Wire form for the control plane (plain JSON-able values)."""
        return {"max_tokens": self.max_tokens, "temperature": self.temperature,
                "top_p": self.top_p, "stop": list(self.stop), "seed": self.seed}


class StopMatcher:
    """Incremental stop-sequence matching with OpenAI semantics, shared
    by the serial generate path and the continuous batcher.

    Feed decoded token text as it is produced; ``feed`` returns the text
    that is safe to DELIVER now. Text that could be the beginning of a
    stop sequence is withheld until disambiguated (so a stop spanning
    several tokens never leaks its prefix to the client), and on a match
    the stop string and everything after it is suppressed. ``text`` is
    the cumulative delivered text — the response body for a stopped
    request. Call ``flush`` when the stream ends without a match to
    release the withheld tail."""

    def __init__(self, stops):
        self.stops = tuple(s for s in stops if s)
        self.text = ""        # delivered so far (never includes the stop)
        self.held = ""        # possible stop prefix, pending disambiguation
        self.stopped = False

    def feed(self, token_text: str) -> str:
        if self.stopped:
            return ""
        if not self.stops:
            self.text += token_text
            return token_text
        buf = self.held + token_text
        hit = min((i for i in (buf.find(s) for s in self.stops) if i >= 0),
                  default=-1)
        if hit >= 0:
            deliver, self.held, self.stopped = buf[:hit], "", True
            self.text += deliver
            return deliver
        # withhold the longest tail that is a proper prefix of any stop
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), hold, -1):
                if buf.endswith(s[:k]):
                    hold = k
                    break
        deliver = buf[:len(buf) - hold] if hold else buf
        self.held = buf[len(deliver):]
        self.text += deliver
        return deliver

    def flush(self) -> str:
        """Stream ended without a match: the held tail is real output."""
        deliver, self.held = self.held, ""
        self.text += deliver
        return deliver


def _mask_vocab(logits, sc: SamplerConfig):
    logits = logits.float()
    if sc.vocab_size and sc.vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., sc.vocab_size:] = -1e30
    return logits


def _nucleus_mask(z, probs, top_p):
    """Mask z to the smallest prob-sorted prefix with mass >= top_p.
    ``top_p`` is (B, 1); rows with top_p >= 1 are left untouched."""
    sp = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sp, dim=-1)
    keep_n = torch.sum(cum < top_p, dim=-1, keepdim=True) + 1
    thresh = torch.gather(sp, -1, (keep_n - 1).clamp(max=sp.shape[-1] - 1))
    return torch.where((top_p >= 1.0) | (probs >= thresh), z, -1e30)


def _gumbel(V: int, gen: torch.Generator, device):
    u = torch.rand(V, generator=gen, device=device).clamp_(min=1e-20)
    return -torch.log(-torch.log(u))


def sample_slots(logits, gen: torch.Generator, sc: SamplerConfig, temps, top_ps,
                 seeds, steps):
    """Per-slot sampling for one fused decode tick.

    logits (B, V) on the device; ``temps``/``top_ps``/``seeds``/``steps``
    (B,) host arrays. A slot with ``temp <= 0`` takes argmax. ``seed >= 0``
    draws from a per-request stream keyed on (seed, step), independent of
    which other sessions share the batch; ``seed < 0`` draws from the
    shared generator ``gen``. Returns (B,) int64 token ids on the device.
    The greedy decision is made on the host, so an all-greedy batch is a
    single argmax with no host read.
    """
    logits = _mask_vocab(logits, sc)
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    if not (temps > 0.0).any():
        return greedy
    dev = logits.device
    B, V = logits.shape
    z = logits / torch.as_tensor(np.maximum(temps, 1e-6), device=dev)[:, None]
    if sc.top_k:
        kth = torch.topk(z, sc.top_k, dim=-1).values[..., -1:]
        z = torch.where(z < kth, -1e30, z)
    probs = torch.softmax(z, dim=-1)
    z = _nucleus_mask(z, probs, torch.as_tensor(
        np.asarray(top_ps, np.float32), device=dev)[:, None])
    noise = torch.stack([
        _gumbel(V, torch.Generator(device=dev).manual_seed(
            (int(s) << 32) + int(t)) if s >= 0 else gen, dev)
        for s, t in zip(np.asarray(seeds), np.asarray(steps))])
    drawn = torch.argmax(z + noise, dim=-1)
    return torch.where(torch.as_tensor(temps <= 0.0, device=dev), greedy, drawn)
