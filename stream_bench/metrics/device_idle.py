"""Device: the share of the traced window in which no kernel ran."""


def read(rec):
    p = rec["profile"]
    if not p or not p["busy_s"] or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
