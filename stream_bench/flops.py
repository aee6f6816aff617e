"""Operations and bytes the work needs, counted from the configuration and
the lengths: the yardstick of ``mfu`` and of the kernels' rooflines. A
later change to a kernel or to the model code cannot move it.

A token touches, in each layer, its attention projections, the router,
its top-k routed experts and the shared ones (or the dense MLP), and
at the end the head; each weight it touches costs 2 operations. Its
attention over ``ctx`` positions (itself included) costs 2 operations a
position per head and width for the scores and again for the values.
The naive MLA decode's re-expansion of every cached position is work
the program chooses, not work the token needs, and is not counted.
"""

from __future__ import annotations

BF16_BYTES = 2


def _attn_weights(m: dict) -> int:
    D, H = m["d_model"], m["n_heads"]
    if m.get("use_mla"):
        r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                         m["qk_rope_head_dim"], m["v_head_dim"])
        return D * H * (dn + dr) + D * r + D * dr + r * H * (dn + dv) + H * dv * D
    hd, Hkv = m["head_dim"], m["n_kv_heads"]
    return 2 * D * H * hd + 2 * D * Hkv * hd


def _attn_widths(m: dict) -> tuple:
    """(heads, score width, value width) of one position's attention."""
    if m.get("use_mla"):
        return (m["n_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
                m["v_head_dim"])
    return m["n_heads"], m["head_dim"], m["head_dim"]


def weights_per_token(m: dict) -> int:
    """Weights one token multiplies by, all layers and the head."""
    D, L = m["d_model"], m["n_layers"]
    nd = m.get("first_dense_layers", 0)
    f = m.get("moe_d_ff") or m["d_ff"]
    dense = _attn_weights(m) + 3 * D * m["d_ff"]
    moe = (_attn_weights(m) + D * m["n_experts"]
           + (m["top_k"] + m.get("n_shared_experts", 0)) * 3 * D * f)
    return nd * dense + (L - nd) * moe + D * m["vocab_size"]


def token_flops(m: dict, ctx: int) -> float:
    """Operations one token needs at a context of ``ctx`` positions."""
    H, dk, dv = _attn_widths(m)
    return 2.0 * weights_per_token(m) + 2.0 * m["n_layers"] * H * ctx * (dk + dv)


def decode_attention_cost(m: dict, kv_lens) -> tuple:
    """(bytes, operations) one ``decode_attention`` call needs: q and
    the output once, and each live position's K (score width) and V
    (value width) of every head once, in bf16."""
    H, dk, dv = _attn_widths(m)
    n = sum(int(k) for k in kv_lens)
    nbytes = BF16_BYTES * (H * n * (dk + dv) + len(kv_lens) * H * (dk + dv))
    return nbytes, 2.0 * H * n * (dk + dv)


def paged_attention_cost(m: dict, kv_lens) -> tuple:
    """(bytes, operations) one ``paged_attention`` call needs: each live
    position's K and V of every kv head once (its G query heads share
    them), q and the output once, in bf16."""
    H, hd, Hkv = m["n_heads"], m["head_dim"], m["n_kv_heads"]
    n = sum(int(k) for k in kv_lens)
    nbytes = BF16_BYTES * (2 * Hkv * hd * n + 2 * len(kv_lens) * H * hd)
    return nbytes, 4.0 * H * hd * n
