"""Broker and batcher: the window's wall ms over its scheduler ticks that
decoded (``ContinuousBatcher.step`` calls that made a decode transfer)."""


def read(rec):
    if not rec["decode_ticks"]:
        return None
    return rec["window_s"] * 1e3 / rec["decode_ticks"]
