"""Usage/cost tracking (paper §2): per-request metadata — model name,
prompt tokens, completion tokens, cost, latency — WITHOUT message
content. Tests assert no content string ever lands in a record.

Also home to :class:`FleetMetrics`, the replica-fleet counters: like the
usage tracker it records metadata only (replica ids, match lengths,
queue depths — never prompt content), and it lives here rather than in
``serving/`` so the gateway can surface it without new import edges."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class UsageRecord:
    ts: float
    tier: str
    model: str
    complexity: str
    prompt_tokens: int
    completion_tokens: int
    cost_usd: float
    ttft_s: float
    total_s: float
    streamed: bool
    fallback_depth: int
    judge_latency_s: float


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1)), len(sorted_vals) - 1)
    return sorted_vals[i]


@dataclass(frozen=True)
class RoutingDecision:
    """One fleet placement decision, recorded at routing time."""
    ts: float
    rid: str
    replica: int
    kind: str            # "route" | "steal" | "failover"
    match_tokens: int    # prefix-tree match length at decision time
    queue_depth: int     # chosen replica's queue depth at decision time


class FleetMetrics:
    """Thread-safe per-replica counters + a bounded routing-decision
    log. Written by the fleet's submit/steal/failover paths (multiple
    threads), read by the gateway's usage-chunk metadata block."""

    def __init__(self, n_replicas: int, *, log_size: int = 256):
        self.n_replicas = n_replicas
        self._lock = threading.Lock()
        self.routed = [0] * n_replicas       # sessions placed at submit
        self.stolen = [0] * n_replicas       # sessions re-queued TO replica
        self.failed_over = [0] * n_replicas  # streams resumed ON replica
        self._log: deque[RoutingDecision] = deque(maxlen=log_size)

    def record(self, kind: str, replica: int, *, rid: str = "",
               match_tokens: int = 0, queue_depth: int = 0):
        dec = RoutingDecision(ts=time.time(), rid=rid, replica=replica,
                              kind=kind, match_tokens=match_tokens,
                              queue_depth=queue_depth)
        with self._lock:
            if kind == "route":
                self.routed[replica] += 1
            elif kind == "steal":
                self.stolen[replica] += 1
            elif kind == "failover":
                self.failed_over[replica] += 1
            self._log.append(dec)
        return dec

    def decisions(self) -> list:
        with self._lock:
            return list(self._log)

    def snapshot(self) -> dict:
        """JSON-able summary for the gateway usage-chunk ``fleet`` block."""
        with self._lock:
            return {
                "replicas": self.n_replicas,
                "routed": list(self.routed),
                "stolen": list(self.stolen),
                "failed_over": list(self.failed_over),
            }


class UsageTracker:
    def __init__(self):
        self._records: list[UsageRecord] = []
        self._lock = threading.Lock()

    def record(self, **kw) -> UsageRecord:
        rec = UsageRecord(ts=time.time(), **kw)
        with self._lock:
            self._records.append(rec)
        return rec

    def records(self):
        with self._lock:
            return list(self._records)

    def summary(self) -> dict:
        recs = self.records()
        out = {"n_requests": len(recs),
               "total_cost_usd": sum(r.cost_usd for r in recs),
               "by_tier": {}}
        for tier in sorted({r.tier for r in recs}):
            rs = [r for r in recs if r.tier == tier]
            tt = sorted(r.ttft_s for r in rs)
            out["by_tier"][tier] = {
                "n": len(rs),
                "ttft_p50": _pct(tt, 0.5),
                "ttft_p95": _pct(tt, 0.95),
                "cost_usd": sum(r.cost_usd for r in rs),
                "tokens_out": sum(r.completion_tokens for r in rs),
            }
        return out
