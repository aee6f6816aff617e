"""Dual-mode authentication + rate limiting for the HPC-as-API proxy
(paper §4) and the simulated federated IdP.

GlobusAuthService stands in for Globus Auth: it issues opaque bearer
tokens bound to an identity (email) and verifies them with a
configurable latency (the paper's ~100 ms verification round-trip).
ApiKeyStore holds pre-issued keys hashed at rest. The proxy tries
Globus verification first, then API-key lookup — exactly the paper's
order.
"""

from __future__ import annotations

import hashlib
import secrets as _secrets
import threading
import time
from collections import deque
from dataclasses import dataclass


def _hash(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()


@dataclass(frozen=True)
class Identity:
    subject: str          # email
    mode: str             # "globus" | "api_key"
    display: str = ""


class AuthFailure(Exception):
    pass


class GlobusAuthService:
    """Simulated federated IdP (issue + verify opaque access tokens)."""

    def __init__(self, verify_latency_s: float = 0.0):
        self._tokens: dict[str, str] = {}       # token-hash -> email
        self._lock = threading.Lock()
        self.verify_latency_s = verify_latency_s

    def issue_token(self, email: str) -> str:
        tok = "globus_" + _secrets.token_urlsafe(24)
        with self._lock:
            self._tokens[_hash(tok)] = email
        return tok

    def verify(self, token: str) -> str:
        """Returns the email bound to the token; raises AuthFailure."""
        if self.verify_latency_s:
            time.sleep(self.verify_latency_s)
        with self._lock:
            email = self._tokens.get(_hash(token))
        if email is None:
            raise AuthFailure("invalid Globus token")
        return email

    def revoke(self, token: str):
        with self._lock:
            self._tokens.pop(_hash(token), None)


class ApiKeyStore:
    """Pre-issued keys for external services; hashed at rest."""

    def __init__(self):
        self._keys: dict[str, str] = {}         # key-hash -> owner
        self._lock = threading.Lock()

    def issue(self, owner: str) -> str:
        key = "sk-stream-" + _secrets.token_urlsafe(24)
        with self._lock:
            self._keys[_hash(key)] = owner
        return key

    def validate(self, key: str) -> str:
        with self._lock:
            owner = self._keys.get(_hash(key))
        if owner is None:
            raise AuthFailure("invalid API key")
        return owner

    def revoke(self, key: str):
        with self._lock:
            self._keys.pop(_hash(key), None)


class DualAuthenticator:
    """Paper §4: try Globus token verification first, then API key."""

    def __init__(self, globus: GlobusAuthService, keys: ApiKeyStore,
                 allowed_domains: tuple = ("uic.edu",)):
        self.globus = globus
        self.keys = keys
        self.allowed_domains = tuple(allowed_domains)

    def authenticate(self, bearer: str | None) -> Identity:
        if not bearer:
            raise AuthFailure("missing Authorization bearer token")
        try:
            email = self.globus.verify(bearer)
            domain = email.rsplit("@", 1)[-1]
            if domain not in self.allowed_domains:
                raise AuthFailure(f"email domain {domain!r} not allowed")
            return Identity(subject=email, mode="globus")
        except AuthFailure as globus_err:
            if str(globus_err).startswith("email domain"):
                raise
        try:
            owner = self.keys.validate(bearer)
            return Identity(subject=owner, mode="api_key")
        except AuthFailure:
            raise AuthFailure("bearer token is neither a valid Globus token "
                              "nor a known API key")


class SlidingWindowRateLimiter:
    """Per-caller sliding window (paper §4)."""

    def __init__(self, max_requests: int = 30, window_s: float = 60.0):
        self.max_requests = max_requests
        self.window_s = window_s
        self._events: dict[str, deque] = {}
        self._lock = threading.Lock()

    def allow(self, caller: str, now: float | None = None) -> bool:
        now = now if now is not None else time.monotonic()
        with self._lock:
            dq = self._events.setdefault(caller, deque())
            while dq and dq[0] <= now - self.window_s:
                dq.popleft()
            if len(dq) >= self.max_requests:
                return False
            dq.append(now)
            return True

    def retry_after(self, caller: str, now: float | None = None) -> float:
        """Seconds until the caller's oldest in-window event expires —
        the earliest moment a new request can succeed (the 429
        ``Retry-After`` header, computed from the sliding window)."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            dq = self._events.get(caller)
            if not dq or len(dq) < self.max_requests:
                return 0.0
            return max(dq[0] + self.window_s - now, 0.0)


def credential_hash(bearer: str) -> str:
    """What lands in the audit log instead of the credential."""
    return _hash(bearer)[:16]
