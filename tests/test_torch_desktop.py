"""Desktop mode (paper §2.3) on the port: one process, the relay
consumer in it, usage rows in an embedded SQLite database with no
message content (the desktop cases of ``tests/test_desktop_elastic.py``;
its elastic restore waits for the port of ``distributed/``)."""

import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.desktop import SQLiteUsageTracker, build_desktop_system  # noqa: E402


@pytest.fixture(scope="module")
def desktop():
    s = build_desktop_system(max_seq=96, device="cpu")
    yield s
    for e in s.engines.values():
        e.shutdown()
    s.endpoint.shutdown()


def test_desktop_single_process_roundtrip(desktop):
    h = desktop.handler.handle("What is the capital of Italy?", max_tokens=4)
    assert h.tier_used == "local"
    assert desktop.tracker is desktop.handler.tracker
    rows = desktop.handler.tracker.db_rows()
    assert len(rows) == 1
    assert rows[0][1] == "local"              # the tier column
    assert "capital" not in str(rows)         # the schema has no content column


def test_desktop_hpc_path_in_process(desktop):
    h = desktop.handler.handle(
        "Explain and compare the trade-offs of two schedulers.", max_tokens=4)
    assert h.tier_used == "hpc"
    assert h.result.streamed


def test_sqlite_tracker_thread_safety():
    t = SQLiteUsageTracker()

    def work(i):
        for _ in range(20):
            t.record(tier="local", model="m", complexity="LOW", prompt_tokens=1,
                     completion_tokens=1, cost_usd=0.0, ttft_s=0.0, total_s=0.0,
                     streamed=True, fallback_depth=0, judge_latency_s=0.0)
    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    [x.start() for x in ts]
    [x.join() for x in ts]
    assert len(t.db_rows()) == 80
