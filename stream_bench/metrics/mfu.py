"""Model step: the operations the window's tokens need (stream_bench.flops:
each prefilled and each decoded token's weights and its attention over
its live context) over the window's seconds at the card's bf16 peak."""

from stream_bench.flops import token_flops
from stream_bench.peaks import PEAK_FLOPS


def read(rec):
    m = rec["model"]
    head = 2.0 * m["d_model"] * m["vocab_size"]
    ops = 0.0
    for n, start in rec["prefills"]:
        ops += sum(token_flops(m, start + j + 1) - head for j in range(n))
    for i, n_prompt in rec["decoded"]:
        # token 0 is the prefill's last row through the head; token i > 0
        # came from a decode step over n_prompt + i positions
        ops += head if i == 0 else token_flops(m, n_prompt + i)
    if not ops:
        return None
    return 100.0 * ops / (rec["window_s"] * PEAK_FLOPS["bfloat16"])
