"""Data-plane helpers: the producer/consumer halves of the dual channel.

The producer side runs *inside the remote function* on the control
plane's worker (the paper copies the AES helper into the remote function
body because the package isn't installed on the endpoint; our equivalent
is REMOTE_FN_SOURCE below — a self-contained source string that only
assumes WORKER_ENV and a relay handle exist in its namespace).

The consumer side runs in the HPC proxy (server mode) or in-process
(desktop mode) and re-assembles the ordered, decrypted token stream.
"""

from __future__ import annotations

import base64
import json
import time

from repro_torch.core.crypto import AESGCM, decrypt_envelope, encrypt_envelope
from repro_torch.core.relay import Relay


def produce_tokens(relay: Relay, channel_id: str, secret: str, token_iter,
                   enc_key: bytes | None = None):
    """Producer loop: forward each token to the relay as it is generated.

    token_iter yields (token_id, text) tuples. Returns token count.
    """
    aes = AESGCM(enc_key) if enc_key else None
    prod = relay.connect_producer(channel_id).authenticate(secret)
    seq = 0
    try:
        for token_id, text in token_iter:
            payload = {"t": "token", "seq": seq, "id": int(token_id), "text": text}
            prod.send(encrypt_envelope(aes, payload) if aes else payload)
            seq += 1
        prod.send(encrypt_envelope(aes, {"t": "done", "seq": seq})
                  if aes else {"t": "done", "seq": seq})
    except BaseException as e:
        try:
            payload = {"t": "error", "seq": seq, "error": f"{type(e).__name__}: {e}"}
            prod.send(encrypt_envelope(aes, payload) if aes else payload)
        except Exception:
            pass
        raise
    finally:
        prod.close()
    return seq


class TokenProducer:
    """Push-style producer half: the session broker's ``on_token``
    callback calls ``push`` directly, so a streaming session needs no
    per-session pump thread or queue hop between the engine and the
    relay (at 16 concurrent sessions those hops, not the engine, were
    the throughput ceiling). ``push`` raises ChannelClosed on channel
    teardown — inside a broker callback that cancels the session and
    frees its decode slot."""

    def __init__(self, relay: Relay, channel_id: str, secret: str,
                 enc_key: bytes | None = None):
        self._aes = AESGCM(enc_key) if enc_key else None
        self._prod = relay.connect_producer(channel_id).authenticate(secret)
        self.seq = 0           # channel sequence (tokens + meta)
        self.n_tokens = 0      # tokens only

    def _send(self, payload: dict):
        self._prod.send(encrypt_envelope(self._aes, payload)
                        if self._aes else payload)

    def push(self, token_id, text: str):
        self._send({"t": "token", "seq": self.seq,
                    "id": int(token_id), "text": text})
        self.seq += 1
        self.n_tokens += 1

    def meta(self, payload: dict):
        """In-band session metadata (e.g. the admission's prefix-cache
        hit), sent ahead of the first token. Consumes a sequence number
        like any other message; the consumer side does not count it as
        a token or stamp TTFT on it."""
        self._send({"t": "meta", "seq": self.seq, **payload})
        self.seq += 1

    def done(self) -> int:
        """Terminate the stream normally; returns tokens relayed
        (meta messages excluded)."""
        try:
            self._send({"t": "done", "seq": self.seq})
        finally:
            self._prod.close()
        return self.n_tokens

    def fail(self, error: str):
        """Best-effort in-band error + close (teardown may already have
        made the channel unwritable)."""
        try:
            self._send({"t": "error", "seq": self.seq, "error": error})
        except Exception:
            pass
        self._prod.close()


def consume_tokens(relay: Relay, channel_id: str, secret: str,
                   enc_key: bytes | None = None, timeout_s: float = 60.0):
    """Consumer generator: yields decrypted token payload dicts in order.

    Raises RuntimeError on an in-band error message; verifies sequence
    numbers (a tampered/reordered stream fails loudly)."""
    aes = AESGCM(enc_key) if enc_key else None
    cons = relay.connect_consumer(channel_id).authenticate(secret)
    expect = 0
    try:
        while True:
            msg = cons.recv(timeout=timeout_s)
            if msg is None:
                return
            payload = decrypt_envelope(aes, msg) if aes else msg
            if payload.get("t") == "error":
                raise RuntimeError(f"producer error: {payload.get('error')}")
            if payload.get("t") == "done":
                return
            if payload.get("seq") != expect:
                raise RuntimeError(
                    f"out-of-order token: got seq={payload.get('seq')}, want {expect}")
            expect += 1
            yield payload
    finally:
        cons.close()


# ---------------------------------------------------------------------------
# The remote function, as shipped source (paper §3.2 items (1) and (2)).
# Self-contained: reads credentials from WORKER_ENV, uses only names the
# endpoint injects (relay handle + engine handle via extra_globals).
# ---------------------------------------------------------------------------

REMOTE_FN_NAME = "hpc_stream_task"

REMOTE_FN_SOURCE = '''
import base64

def hpc_stream_task(*, messages, model, channel_id, max_tokens=64,
                    gen_params=None, cache_salt="", relay_url=None,
                    vllm_url=None):
    """Runs ON the HPC worker. Submits to the cluster engine's shared
    continuous batch (ServingEngine.submit — the paper's vLLM-over-
    localhost call) so N concurrent tasks interleave their decode ticks
    in one batch. Each token is pushed outbound to the relay straight
    from the session callback (TokenProducer): no per-session pump
    thread, no queue hop. Credentials come from the pre-provisioned
    worker env, NEVER from task args. Returns the full text (the
    batch-mode payload used when the relay is unreachable). If the relay
    channel is torn down mid-stream (client gone, channel reaped), the
    push raises, the broker cancels the session, and its decode slot is
    reclaimed."""
    secret = WORKER_ENV["RELAY_SECRET"]
    enc_key_b64 = WORKER_ENV.get("RELAY_ENCRYPTION_KEY")
    enc_key = base64.b64decode(enc_key_b64) if enc_key_b64 else None

    engine = ENGINE            # injected: the tier's serving engine
    relay = RELAY              # injected: reachable relay handle (or None)
    Producer = TOKEN_PRODUCER  # injected: repro_torch.core.data_plane.TokenProducer

    prompt = "\\n".join(m.get("content", "") for m in messages)
    # per-request generation contract rides the task args as a plain
    # dict (engine.submit rebuilds GenerationParams from the wire form)
    params = dict(gen_params) if gen_params else {"max_tokens": max_tokens}

    if relay is None:
        # batch fallback: no streaming; the complete response returns
        # through the control plane (TTFT == total time).
        handle = engine.submit(prompt, params=params, cache_salt=cache_salt)
        res = handle.result(timeout=600.0)
        return {"text": res.text, "n_tokens": res.n_generated,
                "finish_reason": res.finish_reason, "streamed": False,
                "prefix_hit_tokens": res.prefix_hit_tokens}

    # stream as generated: the broker's on_token callback IS the relay
    # producer; a failed push cancels the session (slot reclamation).
    # The admission's prefix-cache hit rides the channel in-band as a
    # meta message ahead of the first token.
    prod = Producer(relay, channel_id, secret, enc_key)
    handle = engine.submit(prompt, params=params, on_token=prod.push,
                           cache_salt=cache_salt, on_meta=prod.meta)
    res = handle.result(timeout=600.0)
    if res.cancelled:
        prod.fail("relay channel torn down")
        raise RuntimeError("stream cancelled: relay channel torn down")
    n = prod.done()
    return {"text": res.text, "n_tokens": n,
            "finish_reason": res.finish_reason, "streamed": True,
            "prefix_hit_tokens": res.prefix_hit_tokens}
'''
