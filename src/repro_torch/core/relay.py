"""The WebSocket-relay data plane (paper §3.1–3.2), as an in-process,
thread-safe protocol engine.

Faithful protocol semantics:
  * per-query channels keyed by UUID (122 bits of entropy = unguessable);
  * both producer and consumer "connect outbound" — the relay never
    initiates a connection (here: both sides call connect_*; the relay
    object is passive);
  * post-handshake auth: a connection is unusable until authenticate()
    is called with the shared secret as the FIRST message; the secret
    never appears in the connection "URL" and therefore never in the
    access log (asserted by tests — the paper's ?secret= pitfall);
  * connections that do not authenticate within ``auth_timeout_s`` are
    closed;
  * up to ``buffer_size`` (default 1000) messages are buffered per
    channel and replayed in order when the consumer attaches late —
    no token loss; a producer that outruns a full buffer blocks
    (backpressure) up to ``send_timeout_s``;
  * channels are removed as soon as both sides disconnect; a channel
    with a missing side is reaped after ``reap_timeout_s`` (default
    300 s, sized to worst-case control-plane cold start);
  * payloads are opaque: the relay never parses the "data" field — with
    E2E encryption on, a compromised relay sees only ciphertext.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field


class RelayError(Exception):
    pass


class AuthError(RelayError):
    pass


class ChannelClosed(RelayError):
    pass


@dataclass
class _Channel:
    channel_id: str
    created_at: float
    buffer: deque = field(default_factory=deque)
    cond: threading.Condition = field(default_factory=threading.Condition)
    producer_attached: bool = False
    producer_done: bool = False
    consumer_attached: bool = False
    consumer_closed: bool = False
    consumer_drained: bool = False   # stream completed normally
    reaped: bool = False
    n_relayed: int = 0
    peak_buffered: int = 0


def new_channel_id() -> str:
    """Fresh UUID per query — the rendezvous token (122 bits entropy)."""
    return str(uuid.uuid4())


class _Conn:
    def __init__(self, relay: "Relay", chan: _Channel, role: str):
        self._relay = relay
        self._chan = chan
        self._role = role
        self._authed = False
        self._opened_at = time.monotonic()

    def authenticate(self, secret: str):
        """Must be the first message after the handshake (paper §5)."""
        if time.monotonic() - self._opened_at > self._relay.auth_timeout_s:
            self._relay._log(self._role, self._chan.channel_id, "auth_timeout")
            raise AuthError("auth window expired")
        if not _const_eq(secret, self._relay._secret):
            self._relay._log(self._role, self._chan.channel_id, "auth_fail")
            raise AuthError("bad relay secret")
        self._authed = True
        self._relay._log(self._role, self._chan.channel_id, "auth_ok")
        return self

    def _require_auth(self):
        if not self._authed:
            raise AuthError(f"{self._role} not authenticated")


def _const_eq(a: str, b: str) -> bool:
    if len(a) != len(b):
        return False
    diff = 0
    for x, y in zip(a.encode(), b.encode()):
        diff |= x ^ y
    return diff == 0


class ProducerConn(_Conn):
    def send(self, message: dict):
        """Enqueue one message; blocks on a full buffer (backpressure).

        Raises ChannelClosed as soon as the channel is torn down — the
        consumer disconnected mid-stream or the relay reaped the channel
        — so the producing session can be cancelled and its decode slot
        reclaimed instead of streaming into the void."""
        self._require_auth()
        ch = self._chan
        deadline = time.monotonic() + self._relay.send_timeout_s
        with ch.cond:
            while True:
                if ch.reaped:
                    raise ChannelClosed("channel reaped")
                if ch.consumer_closed and not ch.consumer_drained:
                    raise ChannelClosed("consumer gone")
                if len(ch.buffer) < self._relay.buffer_size:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._relay.stats["send_timeouts"] += 1
                    raise RelayError("relay buffer full (backpressure timeout)")
                ch.cond.wait(timeout=remaining)
            ch.buffer.append(dict(message))
            ch.n_relayed += 1
            ch.peak_buffered = max(ch.peak_buffered, len(ch.buffer))
            ch.cond.notify_all()

    def close(self):
        ch = self._chan
        with ch.cond:
            ch.producer_done = True
            ch.cond.notify_all()
        self._relay._maybe_remove(ch)
        self._relay._log("producer", ch.channel_id, "close")


class ConsumerConn(_Conn):
    def recv(self, timeout: float | None = None):
        """Next message, or None when the producer closed and the buffer
        drained. Raises TimeoutError if nothing arrives in ``timeout``."""
        self._require_auth()
        ch = self._chan
        deadline = None if timeout is None else time.monotonic() + timeout
        with ch.cond:
            while True:
                if ch.buffer:
                    msg = ch.buffer.popleft()
                    ch.cond.notify_all()
                    return msg
                if ch.producer_done:
                    # stream complete == disconnect (a NORMAL teardown:
                    # drained is what distinguishes it from a mid-stream
                    # disconnect, which makes the producer raise)
                    ch.consumer_drained = True
                    ch.consumer_closed = True
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("relay consumer timeout")
                ch.cond.wait(timeout=remaining if remaining is not None else 0.1)
        # channel removed immediately once both sides are done (paper §3.2)
        self._relay._maybe_remove(ch)
        return None

    def __iter__(self):
        while True:
            msg = self.recv(timeout=self._relay.consumer_timeout_s)
            if msg is None:
                return
            yield msg

    def close(self):
        ch = self._chan
        with ch.cond:
            ch.consumer_closed = True
            ch.cond.notify_all()
        self._relay._maybe_remove(ch)
        self._relay._log("consumer", ch.channel_id, "close")


class Relay:
    def __init__(self, secret: str, *, buffer_size: int = 1000,
                 reap_timeout_s: float = 300.0, auth_timeout_s: float = 10.0,
                 send_timeout_s: float = 30.0, consumer_timeout_s: float = 60.0):
        self._secret = secret
        self.buffer_size = buffer_size
        self.reap_timeout_s = reap_timeout_s
        self.auth_timeout_s = auth_timeout_s
        self.send_timeout_s = send_timeout_s
        self.consumer_timeout_s = consumer_timeout_s
        self._channels: dict[str, _Channel] = {}
        self._lock = threading.Lock()
        # access log: (ts, role, channel, event) — never contains secrets
        # or payloads; tests assert the secret is absent.
        self.access_log: list[tuple] = []
        self.stats = {"channels_created": 0, "channels_reaped": 0,
                      "messages_relayed": 0, "send_timeouts": 0}

    # ------------------------------------------------------------- log
    def _log(self, role: str, channel_id: str, event: str):
        self.access_log.append((time.time(), role, channel_id, event))

    # ------------------------------------------------------------- channels
    def _get_or_create(self, channel_id: str) -> _Channel:
        with self._lock:
            self._reap_locked()
            ch = self._channels.get(channel_id)
            if ch is None:
                ch = _Channel(channel_id=channel_id, created_at=time.monotonic())
                self._channels[channel_id] = ch
                self.stats["channels_created"] += 1
            return ch

    def _maybe_remove(self, ch: _Channel):
        with self._lock:
            done = ch.producer_done and (ch.consumer_closed or not ch.buffer)
            both_closed = ch.producer_done and ch.consumer_closed
            if both_closed or (done and ch.consumer_attached):
                self.stats["messages_relayed"] += ch.n_relayed
                self._channels.pop(ch.channel_id, None)

    def _reap_locked(self):
        now = time.monotonic()
        dead = [cid for cid, ch in self._channels.items()
                if (not ch.producer_attached or not ch.consumer_attached)
                and now - ch.created_at > self.reap_timeout_s]
        for cid in dead:
            ch = self._channels.pop(cid)
            # wake any blocked producer so it sees the teardown and can
            # cancel its session rather than streaming into the void
            with ch.cond:
                ch.reaped = True
                ch.cond.notify_all()
            self.stats["channels_reaped"] += 1
            self._log("relay", cid, "reaped")

    # ------------------------------------------------------------- connect
    def connect_producer(self, channel_id: str) -> ProducerConn:
        ch = self._get_or_create(channel_id)
        ch.producer_attached = True
        self._log("producer", channel_id, "connect")
        return ProducerConn(self, ch, "producer")

    def connect_consumer(self, channel_id: str) -> ConsumerConn:
        ch = self._get_or_create(channel_id)
        with ch.cond:
            ch.consumer_attached = True
            ch.cond.notify_all()
        self._log("consumer", channel_id, "connect")
        return ConsumerConn(self, ch, "consumer")

    def n_channels(self) -> int:
        with self._lock:
            return len(self._channels)
