"""ServingEngine: prefill/decode generation over a model, on one device.

The per-tier inference backend. ``submit`` streams a session through
the engine's :class:`~repro_torch.serving.broker.SessionBroker` (the
shared continuous batch); ``generate`` runs one request on its own with
a contiguous cache, yielding tokens through ``on_token`` as they are
produced. Prefill is position-stable everywhere: prompts run at absolute
positions 0..n-1 in page-aligned chunks (``pagepool.chunk_plan``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: with ``device=None`` the engine raises where no sm_90
card is present rather than falling back to the CPU.
``generate_batch`` is not ported yet (it needs ``SlotSplicer``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.serving.pagepool import chunk_plan
from repro_torch.serving.sampler import (GenerationParams, SamplerConfig,
                                         StopMatcher, sample_slots)
from repro_torch.serving.scheduler import clip_prompt
from repro_torch.serving.tokenizer import ByteTokenizer


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must be a Hopper (sm_90);
    anything else is taken as given. Raises where the card is absent --
    there is no fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    cap = torch.cuda.get_device_capability()
    if cap[0] != 9:
        raise RuntimeError(f"the port's kernels target sm_90a (Hopper); this "
                           f"card is sm_{cap[0]}{cap[1]}")
    return torch.device("cuda", torch.cuda.current_device())


@dataclass
class GenerationResult:
    tokens: list
    text: str
    ttft_s: float               # time to first token (from generate() entry)
    total_s: float
    tok_per_s: float
    n_prompt: int
    n_generated: int
    finish_reason: str = "stop"  # "stop" | "length"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, *, params=None, seed: int = 0,
                 max_seq: int = 256, sampler: SamplerConfig | None = None,
                 scheduler_slots: int = 4, prefill_chunk: int = 32,
                 page: int = 16, prefix_cache_pages: int = 256,
                 kv_dtype: str = "fp32", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.params = (params if params is not None
                       else self.model.init(seed, self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.max_seq = max_seq
        self.tokenizer = ByteTokenizer(cfg.vocab_size)
        self.sampler = sampler or SamplerConfig(vocab_size=cfg.vocab_size)
        self.page = page
        self.prefix_cache_pages = prefix_cache_pages
        self.kv_dtype = kv_dtype
        self.scheduler_slots = scheduler_slots
        self.prefill_chunk = prefill_chunk
        self._broker = None
        self._broker_lock = threading.Lock()

    @property
    def scheduler(self):
        """The engine's SessionBroker, or None if never started."""
        return self._broker

    @property
    def prefix_cache(self):
        return self._broker.batcher.prefix if self._broker is not None else None

    def _get_broker(self):
        with self._broker_lock:
            if self._broker is None:
                from repro_torch.serving.broker import SessionBroker
                self._broker = SessionBroker(
                    self, slots=self.scheduler_slots,
                    prefill_chunk=self.prefill_chunk, page=self.page,
                    prefix_pages=self.prefix_cache_pages)
            return self._broker

    def shutdown(self):
        with self._broker_lock:
            if self._broker is not None:
                self._broker.shutdown()
                self._broker = None

    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32,
               on_token: Optional[Callable[[int, str], None]] = None,
               on_done=None, deadline_s: float = 0.0, rid: str | None = None,
               params: GenerationParams | dict | None = None,
               cache_salt: str = "", on_meta=None):
        """Thread-safe streaming submission: enqueue one session in the
        broker's shared decode batch and return a SessionHandle at once.
        All device work runs on the broker's scheduler thread."""
        return self._get_broker().submit(
            prompt, max_new_tokens=max_new_tokens, on_token=on_token,
            on_done=on_done, deadline_s=deadline_s, rid=rid, params=params,
            cache_salt=cache_salt, on_meta=on_meta)

    def _chunked_prefill(self, ids: list, cache: dict):
        """Position-stable prefill of ``ids`` from position 0, one
        ``prefill_chunk`` call per page-aligned piece."""
        off, logits = 0, None
        for n in chunk_plan(0, len(ids), self.page):
            chunk = torch.tensor([ids[off:off + n]], dtype=torch.int64,
                                 device=self.device)
            logits, cache = self.model.prefill_chunk(self.params, chunk, cache)
            off += n
        return logits, cache

    def _param_vectors(self, gp: GenerationParams | None, B: int = 1):
        """Per-slot sampling vectors for ``sample_slots``, resolved against
        the engine default (as the batcher resolves them at admission)."""
        sc = self.sampler
        temp = (gp.temperature if gp is not None and gp.temperature is not None
                else sc.temperature)
        topp = gp.top_p if gp is not None and gp.top_p is not None else sc.top_p
        seed = ((gp.seed & 0x7FFFFFFF)
                if gp is not None and gp.seed is not None else -1)
        return (np.full(B, temp, np.float32), np.full(B, topp, np.float32),
                np.full(B, seed, np.int64))

    @torch.inference_mode()
    def warmup(self, batch: int = 1):
        """Run every page-aligned prefill-chunk shape ((1, page) and each
        power of two below it), a contiguous decode step and the slot
        sampler once, so the first request pays no lazy set-up (cuBLAS
        handles, kernel builds)."""
        sizes = sorted({min(s, self.max_seq)
                        for s in ([self.page]
                                  + [1 << k for k in range(20) if (1 << k) < self.page])})
        last = cache = None
        for s in sizes:
            toks = torch.zeros((batch, s), dtype=torch.int64, device=self.device)
            cache = self.model.init_cache(batch, self.max_seq, self.device)
            last, cache = self.model.prefill_chunk(self.params, toks, cache)
        tok = torch.argmax(last, -1)[:, None]
        self.model.decode_step(self.params, tok, cache)
        t, p, s = self._param_vectors(None, batch)
        sample_slots(last, self.gen, self.sampler, t, p, s, np.zeros(batch, np.int32))

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, prompt: str | list, *, max_new_tokens: int = 32,
                 on_token: Optional[Callable[[int, str], None]] = None,
                 stop_on_eos: bool = True,
                 params: GenerationParams | dict | None = None) -> GenerationResult:
        """Single-request generation with a per-token streaming callback,
        over a contiguous cache (the contiguous decode kernel)."""
        t0 = time.perf_counter()
        gp = GenerationParams.of(params) if params is not None else None
        if gp is not None:
            max_new_tokens = gp.max_tokens
        ids = self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        ids, max_new_tokens = clip_prompt(ids, max_new_tokens, self.max_seq)
        temps, topps, seeds = self._param_vectors(gp)

        def draw(logits, step):
            return sample_slots(logits, self.gen, self.sampler, temps, topps,
                                seeds, np.full(1, step, np.int32))

        cache = self.model.init_cache(1, self.max_seq, self.device)
        logits, cache = self._chunked_prefill(ids, cache)
        tok = draw(logits, 0)[:, None]
        first = int(tok[0, 0])
        ttft = time.perf_counter() - t0
        out = [first]
        matcher = StopMatcher(gp.stop) if gp is not None and gp.stop else None
        finish = ""

        def emit(t: int) -> bool:
            text = self.tokenizer.decode_token(t)
            if matcher is None:
                if on_token:
                    on_token(t, text)
                return False
            d = matcher.feed(text)
            if d and on_token:
                on_token(t, d)
            return matcher.stopped

        if emit(first):
            finish = "stop"
        for _ in range(max_new_tokens - 1):
            if finish:
                break
            if stop_on_eos and out[-1] == self.tokenizer.eos_id:
                finish = "stop"
                break
            logits, cache = self.model.decode_step(self.params, tok, cache)
            tok = draw(logits, len(out))[:, None]
            t = int(tok[0, 0])
            out.append(t)
            if emit(t):
                finish = "stop"
                break

        if not finish:
            finish = ("stop" if stop_on_eos and out[-1] == self.tokenizer.eos_id
                      else "length")
        if matcher is not None and not matcher.stopped:
            d = matcher.flush()
            if d and on_token:
                on_token(-1, d)
        text = matcher.text if matcher is not None else self.tokenizer.decode(out)
        total = time.perf_counter() - t0
        return GenerationResult(
            tokens=out, text=text, ttft_s=ttft,
            total_s=total, tok_per_s=len(out) / max(total - ttft, 1e-9),
            n_prompt=len(ids), n_generated=len(out), finish_reason=finish)
