"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and makes the requests of a run from ``--seed``.

Every length is a fixed quantile of the mix's distribution, and their
order is fixed too: the seed writes the text (and, in the harness, the
weights) but not the work, so a window whose few admissions would
otherwise draw a different mix of prompt lengths on every seed does the
same work on all of them. The order is stratified: the sorted quantiles
fall into ``strata`` bands, and each round of ``strata`` requests takes
one from every band. A closed loop
has ``clients_per_slot`` callers per batch slot; each starts with a
fill request whose output length is a quantile of the residual life of
the mix's outputs (what is left of a request caught in flight), so
completions, and the admissions behind them, spread over the window as
in a steady state.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

from stream_bench.queries import generate

BOS_TOKENS = 1          # the byte tokenizer's BOS before the prompt bytes


@dataclass(frozen=True)
class Request:
    content: str        # the user message sent through the gateway
    n_prompt: int       # tokens the engine sees: BOS + one per byte
    max_tokens: int


@dataclass(frozen=True)
class Traffic:
    clients: int
    temperature: float
    fill: tuple         # one per client, queued in this order during set-up
    pool: tuple         # the window's requests, taken in this order


def quantiles(spec: dict, n: int) -> list:
    """The n mid-quantiles of a length distribution, as whole tokens."""
    (kind, (lo, hi)), = spec.items()
    if kind != "loguniform":
        raise ValueError(f"unknown length distribution {kind!r}")
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (k + 0.5) / n * (b - a)))) for k in range(n)]


def stratified(values: list, strata: int, rng: random.Random) -> list:
    """``values`` reordered in rounds that take one value from each of
    ``strata`` bands of the sorted values, bands and rounds shuffled."""
    v = sorted(values)
    if len(v) % strata:
        raise ValueError(f"{len(v)} values do not split into {strata} strata")
    per = len(v) // strata
    bands = [v[i * per:(i + 1) * per] for i in range(strata)]
    for b in bands:
        rng.shuffle(b)
    out = []
    for r in range(per):
        round_ = [b[r] for b in bands]
        rng.shuffle(round_)
        out += round_
    return out


def residual_quantiles(lengths: list, n: int) -> list:
    """n mid-quantiles of the residual life R of a renewal process whose
    lengths are ``lengths``: P(R <= r) = sum(min(r, L)) / sum(L)."""
    total = sum(lengths)
    out = []
    for k in range(n):
        u = (k + 0.5) / n
        lo, hi = 1, max(lengths)
        while lo < hi:
            mid = (lo + hi) // 2
            if sum(min(mid, L) for L in lengths) / total >= u:
                hi = mid
            else:
                lo = mid + 1
        out.append(lo)
    return out


def _text(rng: random.Random, n_bytes: int, head: str, corpus: list) -> str:
    """ASCII text of exactly ``n_bytes`` bytes that starts with ``head``."""
    if n_bytes < len(head):
        raise ValueError(f"a prompt of {n_bytes} bytes cannot hold its head {head!r}")
    parts, size = [head], len(head)
    while size < n_bytes:
        q = rng.choice(corpus)
        parts.append(q)
        size += len(q) + 1
    return " ".join(parts)[:n_bytes]


ORDER_SEED = 20240905      # the one order of lengths every seed shares


def make(mix: dict, seed: int, slots: int) -> Traffic:
    rng = random.Random(int(seed))
    order_rng = random.Random(ORDER_SEED)
    texts, _ = generate(n_per_class=100, seed=rng.randrange(1 << 30))
    corpus = [t.encode("ascii", "ignore").decode() for t in texts]
    strata = int(mix["strata"])
    n_pool = int(mix["pool"])
    clients = slots * int(mix["clients_per_slot"])
    tag = rng.randrange(1 << 40)

    def request(i: int, n_prompt: int, max_tokens: int) -> Request:
        content = _text(rng, n_prompt - BOS_TOKENS, f"[{tag:x}.{i}] ", corpus)
        return Request(content=content, n_prompt=BOS_TOKENS + len(content),
                       max_tokens=max_tokens)

    outs = quantiles(mix["output_tokens"], n_pool)
    prompts = stratified(quantiles(mix["prompt_tokens"], n_pool), strata, order_rng)
    order = stratified(outs, strata, order_rng)
    pool = tuple(request(i, p, o) for i, (p, o) in enumerate(zip(prompts, order)))
    fill_p = quantiles(mix["prompt_tokens"], clients)
    fill_o = residual_quantiles(outs, clients)
    order_rng.shuffle(fill_p)
    order_rng.shuffle(fill_o)
    fill = tuple(request(n_pool + c, p, o) for c, (p, o) in enumerate(zip(fill_p, fill_o)))
    return Traffic(clients=clients, temperature=float(mix.get("temperature", 0.0)),
                   fill=fill, pool=pool)


def prompt_ids(content: str) -> list:
    """The ids the byte tokenizer gives a prompt: BOS (0), then each
    byte plus 3 (the three special ids come first)."""
    return [0] + [b + 3 for b in content.encode("utf-8")]


def token_text(i: int) -> str:
    """The text the byte tokenizer streams for one id."""
    return bytes([i - 3]).decode("utf-8", errors="replace") if 3 <= i < 259 else ""
