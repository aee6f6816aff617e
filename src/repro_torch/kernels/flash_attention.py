"""Blocked GQA flash attention (whole-prompt prefill and training): the
hand-written Hopper kernel (``csrc/flash_attention.cu``) and its plain
PyTorch version.

Replaces the JAX package's Pallas ``kernels/flash_attention.py::
flash_attention`` (``_fa_kernel``), and masks the ragged tail of both
sequence axes where the Pallas kernel asserts they divide its blocks.
The kernel has two bodies, chosen by dtype alone: bfloat16 runs both
products on the tensor cores (``wgmma``), float32 on CUDA cores in exact
float32 math. A
CPU tensor takes the plain version -- ``ref.mha``, or ``ref.mha_chunked``
in 512-query chunks past 1024 queries, as the JAX package's
``ops.flash_attention`` dispatches its reference -- and a CUDA tensor
launches the kernel. ``launches`` counts kernel launches.

Gradient: no kernel of the JAX package has a ``custom_vjp``, so it
trains through XLA's autodiff of the plain ``ref.mha``. Here the
forward value always comes from the kernel, and ``_FlashAttention``'s
backward recomputes the plain version on the saved (q, k, v) and returns
PyTorch autograd's gradient of it: the counterpart of that autodiff. The
recompute holds one (B, Hq, Sq, Skv) float32 score tensor while it runs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha, mha_chunked

launches = 0
CHUNK_Q = 512              # the plain version's query chunk past 1024 queries

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def plain(q, k, v, *, causal=True, scale=None, logit_soft_cap=0.0):
    """The plain version, dispatched as the JAX package's reference path."""
    if q.shape[2] > 1024:
        return mha_chunked(q, k, v, causal=causal, scale=scale,
                           logit_soft_cap=logit_soft_cap, chunk_q=CHUNK_Q)
    return mha(q, k, v, causal=causal, scale=scale, logit_soft_cap=logit_soft_cap)


def _launch(q, k, v, causal, scale, cap):
    global launches
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B * Hq * Sq == 0:
        return out
    err = _build.bind("flash_attention", "flash_attention_launch", _ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv,
        D, float(scale), float(cap), int(causal), _build.dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention (D={D}, B*Hq={B * Hq}; the kernel is built "
                      "for D in 16, 112, 128 and B*Hq <= 65535)")
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, cap):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, scale=scale, logit_soft_cap=cap)
        return _launch(q, k, v, causal, scale, cap)

    @staticmethod
    def backward(ctx, g):
        return _build.plain_backward(ctx, g, plain, 3)


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
        return _FlashAttention.apply(q, k, v, causal, scale, logit_soft_cap)
    return _launch(q, k, v, causal, scale, logit_soft_cap)
