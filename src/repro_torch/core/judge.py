"""Complexity judge (paper §2.2 + §7.1).

Three judges, composable:
  * KeywordJudge — the paper's heuristic fallback.
  * FeatureJudge — the paper's own "most important next step": a
    dedicated trained text classifier replacing LLM-as-a-judge. Features
    are cheap lexical/structural signals; the 3-class logistic head is
    trained *in this framework* (PyTorch grad descent) on the synthetic
    query benchmark.
  * CachedJudge — result cache for repeated queries (paper: judge cache).

All judges return (Complexity, latency_s); the router pays this latency
once per query in AUTO mode, so it is tracked explicitly.
"""

from __future__ import annotations

import enum
import math
import re
import threading
import time

import numpy as np


class Complexity(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

_MATH = re.compile(r"[∫∑√^=<>±×÷]|\b(integral|derivative|matrix|eigen|theorem|proof|converge)\b", re.I)
_CODE = re.compile(r"\b(implement|debug|refactor|segfault|race condition|complexity|algorithm|compile|kernel)\b", re.I)
_REASON = re.compile(r"\b(why|explain|compare|trade-?offs?|derive|analyze|design|evaluate|critique|prove|optimi[sz]e)\b", re.I)
_SIMPLE = re.compile(r"\b(what is|who is|when did|where is|define|capital of|how many|list)\b", re.I)
_EXPERT = re.compile(r"\b(novel|research|state.of.the.art|publication|frontier|open problem|conjecture)\b", re.I)
_MULTI = re.compile(r"\b(and|then|also|furthermore|additionally|versus|vs\.?)\b", re.I)


def extract_features(text: str) -> np.ndarray:
    t = text.strip()
    words = t.split()
    n_words = len(words)
    feats = [
        1.0,
        math.log1p(n_words) / 6.0,
        math.log1p(len(t)) / 8.0,
        float(bool(_SIMPLE.search(t))),
        float(bool(_MATH.search(t))),
        float(bool(_CODE.search(t))),
        float(bool(_REASON.search(t))),
        float(bool(_EXPERT.search(t))),
        min(len(_MULTI.findall(t)), 5) / 5.0,
        min(t.count("?"), 3) / 3.0,
        min(t.count(","), 8) / 8.0,
        float(n_words > 40),
        float(n_words < 8),
        float(bool(re.search(r"\d", t))),
        float(bool(re.search(r"step.by.step|detailed|in depth|thorough", t, re.I))),
        float(bool(re.search(r"\b(code|function|class|script|api)\b", t, re.I))),
    ]
    return np.asarray(feats, np.float32)


N_FEATURES = 16


# ---------------------------------------------------------------------------
# judges
# ---------------------------------------------------------------------------


class KeywordJudge:
    """Heuristic fallback (paper §2.2)."""

    name = "keyword"

    def judge(self, text: str):
        t0 = time.perf_counter()
        score = 0
        if _MATH.search(text):
            score += 1
        if _CODE.search(text):
            score += 1
        if _REASON.search(text):
            score += 1
        if _EXPERT.search(text):
            score += 2
        if len(text.split()) > 40:
            score += 1
        if _SIMPLE.search(text) and score <= 1:
            score = 0
        c = Complexity.LOW if score == 0 else (Complexity.MEDIUM if score <= 2 else Complexity.HIGH)
        return c, time.perf_counter() - t0


class FeatureJudge:
    """Trained 3-class logistic classifier over lexical features."""

    name = "feature"

    def __init__(self, weights: np.ndarray | None = None):
        self.w = weights if weights is not None else np.zeros((N_FEATURES, 3), np.float32)

    def judge(self, text: str):
        t0 = time.perf_counter()
        logits = extract_features(text) @ self.w
        c = Complexity(int(np.argmax(logits)))
        return c, time.perf_counter() - t0

    # ---- in-framework training (PyTorch) ----
    @classmethod
    def train(cls, texts: list[str], labels: list[int], *, steps: int = 300,
              lr: float = 0.5, seed: int = 0):
        import torch

        X = torch.from_numpy(np.stack([extract_features(t) for t in texts]))
        y = torch.as_tensor(np.asarray(labels, np.int64))

        def loss_fn(w):
            nll = torch.nn.functional.cross_entropy(X @ w, y)
            return nll + 1e-4 * torch.sum(w * w)

        g = torch.Generator().manual_seed(seed)
        w = (torch.randn((N_FEATURES, 3), generator=g) * 0.01).requires_grad_()
        for _ in range(steps):
            (grad,) = torch.autograd.grad(loss_fn(w), w)
            with torch.no_grad():
                w -= lr * grad
        with torch.no_grad():
            final = float(loss_fn(w))
        return cls(w.detach().numpy().astype(np.float32)), final


class CachedJudge:
    """Result cache for repeated queries (paper §2.2). Thread-safe: the
    judge sits on the concurrent-session path, so cache bookkeeping is
    locked (the inner judge runs outside the lock)."""

    def __init__(self, inner, maxsize: int = 4096):
        self.inner = inner
        self.name = f"cached({inner.name})"
        self._cache: dict[str, Complexity] = {}
        self._lock = threading.Lock()
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0

    def judge(self, text: str):
        t0 = time.perf_counter()
        key = text.strip().lower()
        with self._lock:
            if key in self._cache:
                self.hits += 1
                return self._cache[key], time.perf_counter() - t0
            self.misses += 1
        c, _ = self.inner.judge(text)
        with self._lock:
            if len(self._cache) >= self.maxsize:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = c
        return c, time.perf_counter() - t0
