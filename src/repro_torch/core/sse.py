"""Server-Sent Events framing + OpenAI-compatible chat-chunk builders."""

from __future__ import annotations

import json
import time
import uuid


def sse_event(data: dict | str) -> str:
    payload = data if isinstance(data, str) else json.dumps(data, separators=(",", ":"))
    return f"data: {payload}\n\n"


SSE_DONE = "data: [DONE]\n\n"


def parse_sse(stream_text: str):
    """Inverse of sse_event, for tests/clients."""
    out = []
    for block in stream_text.split("\n\n"):
        block = block.strip()
        if not block.startswith("data: "):
            continue
        body = block[len("data: "):]
        if body == "[DONE]":
            break
        out.append(json.loads(body))
    return out


def chat_chunk(request_id: str, model: str, delta: str, *, role=None,
               finish_reason=None, created=None) -> dict:
    d = {}
    if role:
        d["role"] = role
    if delta:
        d["content"] = delta
    return {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": created or int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": d, "finish_reason": finish_reason}],
    }


def chat_completion(request_id: str, model: str, text: str, *, prompt_tokens=0,
                    completion_tokens=0, finish_reason: str = "stop") -> dict:
    return {
        "id": request_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0,
                     "message": {"role": "assistant", "content": text},
                     "finish_reason": finish_reason}],
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens,
                  "total_tokens": prompt_tokens + completion_tokens},
    }


def usage_chunk(request_id: str, model: str, *, prompt_tokens=0,
                completion_tokens=0, stream_meta: dict | None = None) -> dict:
    """The final ``stream_options.include_usage`` chunk: empty choices,
    a ``usage`` block, and (vendor extension) the STREAM routing
    metadata under ``"stream"`` — tier served, judge complexity,
    fallback depth, cost — mirroring the ``x-stream-*`` headers."""
    chunk = {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [],
        "usage": {"prompt_tokens": prompt_tokens,
                  "completion_tokens": completion_tokens,
                  "total_tokens": prompt_tokens + completion_tokens},
    }
    if stream_meta:
        chunk["stream"] = dict(stream_meta)
    return chunk


def new_request_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]
