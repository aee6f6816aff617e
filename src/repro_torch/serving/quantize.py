"""W4A16 (AWQ-layout) weight quantization for the serving path.

The paper's HPC tier serves Qwen-72B-AWQ, and its one kernel-level perf
note is the silently disabled Marlin AWQ kernels (paper section 2.1).
This module quantizes a model's gated-MLP weights (and attention ``wo``)
to int4 with group-wise scales and zeros; ``models.layers._matmul``
sees a quantized node and routes it through ``ops.awq_matmul`` (the
plain version on the CPU, the Hopper kernel on the card).

The arithmetic is the JAX package's numpy version carried out in torch
on the weights' own device, so a full-width tree quantizes on the card
in seconds. On the same float32 input the output is bit-identical: the
same float32 operations, each correctly rounded, and round-half-even.
"""

from __future__ import annotations

import torch


def _quantize_2d(w, group_size: int, bits: int, qw_out, s_out, z_out):
    K, N = w.shape
    levels = (1 << bits) - 1
    wf = w.float().reshape(K // group_size, group_size, N)
    lo = wf.amin(dim=1)                                   # (K/g, N)
    hi = wf.amax(dim=1)
    scales = torch.clamp_min((hi - lo) / levels, 1e-8)
    zeros = torch.round(-lo / scales)
    q = torch.clamp(torch.round(wf / scales[:, None, :]) + zeros[:, None, :], 0, levels)
    # pack 8 nibbles per int32 along K (as kernels.ref.awq_pack)
    pack = 32 // bits
    qr = q.reshape(K // pack, pack, N).to(torch.int64)
    del wf, q
    out = torch.zeros((K // pack, N), dtype=torch.int64, device=w.device)
    for i in range(pack):
        out |= qr[:, i, :] << (bits * i)
    qw_out.copy_(torch.where(out >= 1 << 31, out - (1 << 32), out))
    s_out.copy_(scales)
    z_out.copy_(zeros)


def quantize_weight(w, *, group_size: int = 128, bits: int = 4):
    """w (K, N) float -> {"qw": int32 (K/8, N), "scales", "zeros" float32
    (K/g, N)}. A 3-D layer stack (L, K, N) quantizes layer by layer into
    (L, K/8, N) and (L, K/g, N) outputs, so only one layer's float32 copy
    exists at a time. Asymmetric per-group min/max quantization."""
    *lead, K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} is not a multiple of group_size={group_size}")
    pack = 32 // bits
    dev = w.device
    qw = torch.empty((*lead, K // pack, N), dtype=torch.int32, device=dev)
    scales = torch.empty((*lead, K // group_size, N), dtype=torch.float32, device=dev)
    zeros = torch.empty_like(scales)
    if w.dim() == 2:
        _quantize_2d(w, group_size, bits, qw, scales, zeros)
    else:
        for i in range(w.shape[0]):
            _quantize_2d(w[i], group_size, bits, qw[i], scales[i], zeros[i])
    return {"qw": qw, "scales": scales, "zeros": zeros}


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "qw" in p


def quantize_mlp_tree(params, *, group_size: int = 128, attn_out: bool = True,
                      in_place: bool = False):
    """Quantize every gated-MLP weight (w1/w3/w2) in a param tree whose
    contraction dim divides the group size, plus (``attn_out=True``) the
    attention output projection ``wo`` of every attention block; q/k/v
    projections stay dense. Returns a new tree; dense leaves it does not
    quantize are shared with ``params``. ``in_place=True`` instead
    replaces the leaves in ``params``' own dicts one stack at a time, so
    a caller that owns the tree holds at most the dense tree plus one
    quantized stack while it runs."""
    def quantize_if_fits(w):
        if (torch.is_tensor(w) and w.dim() in (2, 3)
                and w.shape[-2] % group_size == 0):
            return quantize_weight(w, group_size=group_size)
        return w

    def walk(node):
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        if not isinstance(node, dict):
            return node
        if {"w1", "w2", "w3"} <= set(node):
            names = {"w1", "w2", "w3"}
        elif attn_out and "wo" in node and "wq" in node:
            names = {"wo"}
        else:
            names = set()
        out = node if in_place else dict(node)
        for k in list(out):
            out[k] = quantize_if_fits(out[k]) if k in names else walk(out[k])
        return out

    return walk(params)


def weight_bytes(params) -> dict:
    """Byte accounting for a (possibly partially quantized) param tree:
    ``{"total", "quantized", "dense", "dense_equivalent"}``. ``quantized``
    counts every quantized node (qw + scales + zeros), ``dense`` the
    other leaves, ``dense_equivalent`` what the quantized nodes would
    take unpacked at the scales' float width (the JAX package's
    accounting)."""
    out = {"total": 0, "quantized": 0, "dense": 0, "dense_equivalent": 0}

    def nbytes(t):
        return t.numel() * t.element_size()

    def walk(node):
        if is_quantized(node):
            qb = sum(nbytes(v) for v in node.values() if torch.is_tensor(v))
            out["quantized"] += qb
            out["total"] += qb
            K = node["qw"].shape[-2] * 8
            N = node["qw"].shape[-1]
            L = node["qw"].shape[0] if node["qw"].dim() == 3 else 1
            out["dense_equivalent"] += L * K * N * node["scales"].element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)
        elif torch.is_tensor(node):
            out["dense"] += nbytes(node)
            out["total"] += nbytes(node)

    walk(params)
    return out
