"""Model step: the profiler's kernel time launched inside
``TransformerLM.decode_step`` ranges, a decode step, over the traced part
of the window."""


def read(rec):
    p = rec["profile"]
    if not p or not p["busy_s"] or not p["ranges"].get("sb.decode_step"):
        return None
    return p["kernel_s_in"]["sb.decode_step"] * 1e3 / p["ranges"]["sb.decode_step"]
