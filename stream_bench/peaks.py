"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
700 W limit) and the roofline bound. Copied from chip_smoke.py's
HBM_BYTES_PER_S, PEAK_FLOPS and bound_ms, so that the yardstick lives
with this benchmark."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the bytes and the operations take at the peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
