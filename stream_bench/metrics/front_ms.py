"""Gateway and relay: the callers' median time to first token less the
engine's own (``ContinuousBatcher.submit`` to the request's first emit),
over requests sent in the window: what dispatch, relay and SSE add."""

from stream_bench.stats import median


def read(rec):
    if not rec["ttft_s"] or not rec["engine_ttft_s"]:
        return None
    return (median(rec["ttft_s"]) - median(rec["engine_ttft_s"])) * 1e3
