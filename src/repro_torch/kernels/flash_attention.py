"""Blocked GQA flash attention (whole-prompt prefill and training): the
hand-written Hopper kernels (``csrc/flash_attention.cu`` forward,
``csrc/flash_attention_bwd.cu`` backward) and their plain PyTorch
versions.

Replaces the JAX package's Pallas ``kernels/flash_attention.py::
flash_attention`` (``_fa_kernel``), and masks the ragged tail of both
sequence axes where the Pallas kernel asserts they divide its blocks.
Each kernel has two bodies, chosen by dtype alone: bfloat16 runs its
products on the tensor cores (``wgmma``), float32 on CUDA cores in exact
float32 math. A CPU tensor takes the plain version -- ``ref.mha``, or
``ref.mha_chunked`` in 512-query chunks past 1024 queries, as the JAX
package's ``ops.flash_attention`` dispatches its reference -- and a CUDA
tensor launches the kernel. ``launches`` counts forward launches,
``launches_bwd`` backward launches.

Gradient: no kernel of the JAX package has a ``custom_vjp``, so it
trains through XLA's autodiff of the plain ``ref.mha``. Here the
forward records, beside the output, the log-sum-exp of each query row
(``lse``, natural log, float32) and, for bfloat16, the output's rounding
remainder (``out_lo``), and ``_FlashAttention``'s backward is the
backward kernel over them: P = exp(s - lse) is recomputed tile by tile
and no (Sq, Skv) tensor exists. ``plain_fwd`` and ``plain_bwd`` are that
formulation in plain float32 PyTorch, for the CPU tests and the card's
comparisons; the CPU path itself differentiates the plain version
directly. Remat's first pass (non-reentrant ``torch.utils.checkpoint``)
runs with grad enabled, so it too writes lse and out_lo, which the
recompute then replaces.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha, mha_chunked

launches = 0
launches_bwd = 0
CHUNK_Q = 512              # the plain version's query chunk past 1024 queries
HEAD_DIMS = (8, 16, 24, 64, 112, 128, 192, 256)   # the forward kernel's
BWD_HEAD_DIMS = (8, 16, 112, 128, 256)         # the backward kernel's

_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# csrc/flash_attention_bwd.cu's BwdArgs, passed as one block: 13 pointers
# (q, k, v, out, out_lo, lse, dout, delta, dq, dk, dv, dq_acc, sem), 8
# ints, 2 floats, the stream
_BWD_PACK = struct.Struct("<13Q8i2fQ")


def plain(q, k, v, *, causal=True, scale=None, logit_soft_cap=0.0):
    """The plain version, dispatched as the JAX package's reference path."""
    if q.shape[2] > 1024:
        return mha_chunked(q, k, v, causal=causal, scale=scale,
                           logit_soft_cap=logit_soft_cap, chunk_q=CHUNK_Q)
    return mha(q, k, v, causal=causal, scale=scale, logit_soft_cap=logit_soft_cap)


def _masked_logits(q, k, causal, scale, cap):
    """The kernels' view of the logits, float32 (B, Hkv, G, Sq, Skv): x =
    scale q.k, capped; ``vis`` the keys a row attends; a causal row that
    sees no key (query i at i + Skv - Sq < 0) attends every key with x = 0,
    so its softmax is uniform, as the plain version's all-sentinel row is;
    ``none`` marks those rows, ``capf`` is dx/ds (None without a cap)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D)
    x = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    capf = None
    if cap > 0.0:
        th = torch.tanh(x / cap)
        x, capf = cap * th, 1.0 - th * th
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    none = (qpos < 0) if causal else torch.zeros(Sq, dtype=torch.bool, device=q.device)
    vis = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        vis = (torch.arange(Skv, device=q.device)[None, :] <= qpos[:, None]) | none[:, None]
    x = torch.where(none[:, None], 0.0, x)
    return qf, x, vis, none, capf


def plain_fwd(q, k, v, *, causal=True, scale=None, logit_soft_cap=0.0):
    """The forward as the kernels compute it, in float32: (out in q's
    dtype, lse (B, Hq, Sq) float32), lse the natural log-sum-exp of each
    row's logits. A row that sees no key has lse = log(Skv), the
    log-sum-exp of its all-zero logits."""
    B, Hq, Sq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _, x, vis, _, _ = _masked_logits(q, k, causal, scale, logit_soft_cap)
    lse = torch.logsumexp(torch.where(vis, x, -math.inf), dim=-1)
    p = torch.where(vis, torch.exp(x - lse[..., None]), 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


def plain_bwd(q, k, v, o, lse, do, *, causal=True, scale=None, logit_soft_cap=0.0):
    """The gradient as the backward kernel computes it, in float32:
    P = exp(x - lse), Delta = rowsum(dO o O), dV = P^T dO, dP = dO V^T,
    dS = P o (dP - Delta) (times dx/ds under a cap), dQ = scale dS K,
    dK = scale dS^T Q, dK and dV summed over each kv head's query heads.
    Rows that see no key give dQ = 0 and nothing to dK (the plain
    version's mask cuts the gradient to every logit of such a row) and
    dO / Skv to dV at every key. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf, x, vis, none, capf = _masked_logits(q, k, causal, scale, logit_soft_cap)
    lse = lse.float().reshape(B, Hkv, G, Sq)
    dof = do.float().reshape(B, Hkv, G, Sq, D)
    delta = (dof * o.float().reshape(B, Hkv, G, Sq, D)).sum(-1)
    p = torch.where(vis, torch.exp(x - lse[..., None]), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = torch.where(vis & ~none[:, None], p * (dp - delta[..., None]), 0.0)
    if capf is not None:
        ds = ds * capf
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch(q, k, v, causal, scale, cap, with_lse):
    """The forward kernel: (out, lse, out_lo). With ``with_lse``, lse is
    the row log-sum-exp and, for bfloat16, out_lo is out's rounding
    remainder (the float32 output is out + out_lo to about 16 bits, which
    the backward's Delta needs); otherwise both are None."""
    global launches
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    out_lo = torch.empty_like(q) if with_lse and q.dtype == torch.bfloat16 else None
    if B * Hq * Sq == 0:
        return out, lse, out_lo
    err = _build.bind("flash_attention", "flash_attention_launch", _ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, out_lo.data_ptr() if out_lo is not None else None,
        B, Hq, Hkv, Sq, Skv, D, float(scale), float(cap), int(causal), _build.dtype_code(q),
        _build.raw_stream(q.device))
    _build.check(err, f"flash_attention (D={D}, B*Hq={B * Hq}; the kernel is built "
                      f"for D in {HEAD_DIMS} and B*Hq <= 65535)")
    launches += 1
    return out, lse, out_lo


def _launch_bwd(q, k, v, o, o_lo, lse, do, causal, scale, cap, need_q, need_kv):
    """The backward kernel: (dq or None, dk or None, dv or None); dq when
    ``need_q``, dk and dv when ``need_kv``. ``o_lo`` is the forward's
    out_lo (None for float32)."""
    global launches_bwd
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q) if need_q else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if need_kv else (None, None)
    if B * Hq * Sq == 0 or not (need_q or need_kv):
        return dq, dk, dv
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq_acc = sem = None
    if q.dtype == torch.bfloat16:
        # the bf16 kernel's dQ sums (float32, 64 x DP a query tile) and its
        # counters (a turn per query tile, then the ticket; the Delta pass
        # zeroes them)
        nq, dp = -(-Sq // 64), -(-D // 64) * 64
        sem = torch.empty(B * Hq * nq + 1, dtype=torch.int32, device=q.device)
        if need_q:
            dq_acc = torch.empty(B * Hq * nq * 64 * dp, dtype=torch.float32, device=q.device)
    args = _BWD_PACK.pack(*(t.data_ptr() if t is not None else 0
                            for t in (q, k, v, o, o_lo, lse, do, delta, dq, dk, dv,
                                      dq_acc, sem)),
                          B, Hq, Hkv, Sq, Skv, D, int(causal), _build.dtype_code(q),
                          float(scale), float(cap), _build.raw_stream(q.device))
    err = _build.bind("flash_attention_bwd", "flash_attention_bwd_launch",
                      (ctypes.c_char_p,))(args)
    _build.check(err, f"flash_attention backward (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                      f"{q.dtype}; the kernel is built for D in {BWD_HEAD_DIMS} and "
                      "B*Hq <= 65535)")
    launches_bwd += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel, keeping (q, k, v, out, out_lo, lse). Backward:
    the backward kernel, for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, cap):
        out, lse, out_lo = _launch(q, k, v, causal, scale, cap, True)
        ctx.save_for_backward(q, k, v, out, out_lo, lse)
        ctx.args = (causal, scale, cap)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, out_lo, lse = ctx.saved_tensors
        nq, nk, nv = ctx.needs_input_grad[:3]
        dq, dk, dv = _launch_bwd(q, k, v, out, out_lo, lse, g.contiguous(), *ctx.args,
                                 need_q=nq, need_kv=nk or nv)
        return dq, dk if nk else None, dv if nv else None, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, logit_soft_cap=0.0):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) of q's dtype, float32 or
    bfloat16 -> (B, Hq, Sq, D). Causal with query row i at absolute
    position i + (Skv - Sq); with Skv < Sq a row that sees no key is the
    mean of V over all Skv keys, as in the plain version."""
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, causal=causal, scale=scale, logit_soft_cap=logit_soft_cap)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {dev}")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or v.shape != k.shape or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must be in q's dtype")
    for t in (q, k, v):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs contiguous, 16-byte aligned "
                             "q, k, v on one device")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if D not in BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"flash_attention's backward kernel is built for D in {BWD_HEAD_DIMS}, "
                f"got D={D}: training at this head width is not ported yet")
        return _FlashAttention.apply(q, k, v, causal, scale, logit_soft_cap)
    return _launch(q, k, v, causal, scale, logit_soft_cap, False)[0]
