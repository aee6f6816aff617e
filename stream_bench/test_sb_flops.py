"""The yardstick's operation and byte counts: mfu's per-token operations
and the attention kernels' roofline bytes over live positions."""

import pytest

from stream_bench import flops, peaks

MLA = dict(n_layers=3, d_model=8, n_heads=2, n_kv_heads=2, head_dim=4, d_ff=16, moe_d_ff=4,
           vocab_size=32, n_experts=4, n_shared_experts=1, top_k=2, first_dense_layers=1,
           use_mla=True, kv_lora_rank=6, qk_nope_head_dim=4, qk_rope_head_dim=2, v_head_dim=3)
GQA = dict(n_layers=2, d_model=8, n_heads=4, n_kv_heads=2, head_dim=2, d_ff=12, moe_d_ff=12,
           vocab_size=32, n_experts=4, n_shared_experts=0, top_k=2, first_dense_layers=0,
           use_mla=False)


def test_mla_token_flops_by_hand():
    D, H, r, dn, dr, dv = 8, 2, 6, 4, 2, 3
    attn = D * H * (dn + dr) + D * r + D * dr + r * H * (dn + dv) + H * dv * D
    dense = attn + 3 * D * 16
    moe = attn + D * 4 + (2 + 1) * 3 * D * 4
    weights = dense + 2 * moe + D * 32
    assert flops.weights_per_token(MLA) == weights
    ctx = 10
    assert flops.token_flops(MLA, ctx) == 2 * weights + 2 * 3 * H * ctx * (dn + dr + dv)


def test_gqa_token_flops_by_hand():
    D, H, Hkv, hd = 8, 4, 2, 2
    attn = 2 * D * H * hd + 2 * D * Hkv * hd
    moe = attn + D * 4 + 2 * 3 * D * 12
    weights = 2 * moe + D * 32
    assert flops.weights_per_token(GQA) == weights
    assert flops.token_flops(GQA, 5) == 2 * weights + 2 * 2 * H * 5 * (hd + hd)


def test_decode_attention_counts_live_positions_once():
    H, dk, dv = 2, 6, 3
    nbytes, ops = flops.decode_attention_cost(MLA, [5, 1, 10])
    assert nbytes == 2 * (H * 16 * (dk + dv) + 3 * H * (dk + dv))
    assert ops == 2 * H * 16 * (dk + dv)
    # a longer view with the same live positions costs the same
    assert flops.decode_attention_cost(MLA, [5, 1, 10]) == (nbytes, ops)


def test_paged_attention_reads_each_kv_head_once():
    H, Hkv, hd = 4, 2, 2
    nbytes, ops = flops.paged_attention_cost(GQA, [7, 3])
    assert nbytes == 2 * (2 * Hkv * hd * 10 + 2 * 2 * H * hd)
    assert ops == 4 * H * hd * 10


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
