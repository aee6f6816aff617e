"""Tier router (paper §2.2): complexity -> tier, asymmetric fallback.

  LOW    -> local  (fallback: local -> hpc -> cloud)
  MEDIUM -> hpc    (fallback: hpc -> cloud -> local)   # escalate
  HIGH   -> cloud  (fallback: cloud -> hpc -> local)   # descend

Health checking avoids the latency trap: only the lightweight auth
check runs at routing time; if a tier dies mid-stream the handler moves
to the next tier in the chain.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.judge import Complexity

FALLBACK_CHAINS = {
    Complexity.LOW: ("local", "hpc", "cloud"),
    Complexity.MEDIUM: ("hpc", "cloud", "local"),
    Complexity.HIGH: ("cloud", "hpc", "local"),
}


@dataclass
class RouteDecision:
    complexity: Complexity
    chain: tuple
    judge_latency_s: float
    overridden: bool = False
    health_skipped: tuple = ()


class TierRouter:
    def __init__(self, backends: dict, judge):
        self.backends = backends
        self.judge = judge

    def available_tiers(self) -> tuple:
        """Tier names this router can dispatch to (gateway alias table)."""
        return tuple(self.backends)

    def _health_filter(self, chain) -> tuple:
        """Lightweight health check (~100 ms auth ping); unhealthy tiers
        are skipped in the chain, not retried."""
        healthy, skipped = [], []
        for t in chain:
            b = self.backends.get(t)
            ok = False
            try:
                ok = bool(b and b.health_check())
            except Exception:
                ok = False
            (healthy if ok else skipped).append(t)
        return tuple(healthy), tuple(skipped)

    def route(self, query: str, *, override_tier: str | None = None) -> RouteDecision:
        if override_tier is not None:
            if override_tier not in self.backends:
                raise KeyError(f"unknown tier {override_tier}")
            # the override tier leads unconditionally (the caller asked
            # for it; a dead backend surfaces as a fallback, not a skip);
            # the rest of the chain is restricted to known backends and
            # health-filtered like any routed chain.
            rest = [t for t in ("local", "hpc", "cloud")
                    if t != override_tier and t in self.backends]
            healthy, skipped = self._health_filter(rest)
            return RouteDecision(complexity=Complexity.MEDIUM,
                                 chain=(override_tier, *healthy),
                                 judge_latency_s=0.0, overridden=True,
                                 health_skipped=skipped)
        c, lat = self.judge.judge(query)
        healthy, skipped = self._health_filter(FALLBACK_CHAINS[c])
        return RouteDecision(complexity=c, chain=healthy,
                             judge_latency_s=lat, health_skipped=skipped)
