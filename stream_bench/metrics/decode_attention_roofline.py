"""Kernels: ``decode_attention``'s share of its roofline, counting each
call's live ``kv_len`` positions once (stream_bench.flops)."""

from stream_bench.flops import decode_attention_cost
from stream_bench.metrics._roofline import share


def read(rec):
    return share(rec, "decode_attention", decode_attention_cost)
