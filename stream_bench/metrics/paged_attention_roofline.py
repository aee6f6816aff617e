"""Kernels: ``paged_attention``'s share of its roofline over grok's GQA
pages, counting each call's live ``kv_len`` positions once
(stream_bench.flops)."""

from stream_bench.flops import paged_attention_cost
from stream_bench.metrics._roofline import share


def read(rec):
    return share(rec, "paged_attention", paged_attention_cost)
