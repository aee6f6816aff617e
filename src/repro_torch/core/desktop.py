"""Desktop mode (paper §2.3): everything in ONE process with no external
dependencies — the paper collapses its five server-mode containers into
a single PyWebView process backed by SQLite.

Shares >90% of the code with server mode (the paper's number — here it
is literally the same classes): the only differences are (1) the relay
consumer runs in-process ("litellm_direct in the same process as the
middleware"), (2) usage records persist to an embedded sqlite3 database
instead of PostgreSQL, and (3) there is no standalone proxy container —
the handler IS the surface.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from dataclasses import dataclass

from repro_torch.core.metrics import UsageRecord, UsageTracker
from repro_torch.core.system import StreamSystem, build_system


class SQLiteUsageTracker(UsageTracker):
    """Paper: per-request metadata to the database WITHOUT message
    content. Embedded sqlite3, thread-safe, schema created on first use."""

    SCHEMA = """CREATE TABLE IF NOT EXISTS usage (
        ts REAL, tier TEXT, model TEXT, complexity TEXT,
        prompt_tokens INTEGER, completion_tokens INTEGER,
        cost_usd REAL, ttft_s REAL, total_s REAL,
        streamed INTEGER, fallback_depth INTEGER, judge_latency_s REAL)"""

    def __init__(self, path: str = ":memory:"):
        super().__init__()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db_lock = threading.Lock()
        with self._db_lock:
            self._db.execute(self.SCHEMA)
            self._db.commit()

    def record(self, **kw) -> UsageRecord:
        rec = super().record(**kw)
        with self._db_lock:
            self._db.execute(
                "INSERT INTO usage VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
                (rec.ts, rec.tier, rec.model, rec.complexity,
                 rec.prompt_tokens, rec.completion_tokens, rec.cost_usd,
                 rec.ttft_s, rec.total_s, int(rec.streamed),
                 rec.fallback_depth, rec.judge_latency_s))
            self._db.commit()
        return rec

    def db_rows(self):
        with self._db_lock:
            return list(self._db.execute("SELECT * FROM usage"))


def build_desktop_system(db_path: str = ":memory:", **kw) -> StreamSystem:
    """Single-process deployment: same components, embedded persistence,
    consumer co-located with the middleware (it already is — the relay
    here is in-process by construction, which desktop mode makes the
    *intended* topology rather than a simulation shortcut). ``kw`` goes to
    :func:`build_system`: the engines run on the CUDA card unless it
    says ``device="cpu"``."""
    kw.setdefault("dispatch_latency_s", 0.0)
    system = build_system(**kw)
    tracker = SQLiteUsageTracker(db_path)
    system.handler.tracker = tracker
    # rebind so StreamSystem.tracker reflects the persistent one
    system.tracker = tracker
    return system
