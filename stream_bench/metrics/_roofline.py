"""Shared arithmetic of the attention kernels' roofline shares: over the
traced calls, the least time their live positions need at the card's
peaks, over the kernels' measured time."""

from stream_bench.peaks import bound_s


def share(rec, kind: str, cost):
    p = rec["profile"]
    calls = rec.get("attn_calls", {}).get(kind) or []
    if not p or not calls:
        return None
    kernel_s = sum(v for n, v in p["kernel_s_by_name"].items() if rec["kernel_match"][kind] in n)
    if not kernel_s:
        return None
    need = sum(bound_s(*cost(rec["model"], kv)) for kv in calls)
    return 100.0 * need / kernel_s
