"""Single-token decode attention against a contiguous per-slot cache:
the hand-written Hopper kernel (``csrc/attention.cu``, contiguous
addressing) and its plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/decode_attention.py::
decode_attention`` (``_dec_kernel``). Same design as the paged kernel,
with K/V tiles of 16 positions read by stride. A CPU tensor takes the
plain version; ``launches`` counts kernel launches. It has no gradient:
where autograd would record it, it raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import as_lengths, check_smem
from repro_torch.kernels.ref import decode_attention as plain

launches = 0
TILE = 16                    # key positions per tile (csrc/attention.cu)

_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def decode_attention(q, k, v, *, kv_len, scale=None, logit_soft_cap: float = 0.0):
    """q (B, Hq, 1, D); k, v (B, Hkv, S, D) of q's dtype; kv_len int or
    (B,) -> (B, Hq, 1, D)."""
    global launches
    _build.refuse_grad("decode_attention", q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return plain(q, k, v, kv_len=kv_len, scale=scale, logit_soft_cap=logit_soft_cap)
    B, Hq, Sq, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if dev.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got {dev}")
    if Sq != 1 or Bk != B or Dk != D or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must be in q's dtype")
    for t in (q, k, v):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("decode_attention kernel needs contiguous tensors "
                             "on one device")
    check_smem(Hq // Hkv, D, TILE)
    kv_len = as_lengths(kv_len, B, dev)
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    err = _build.bind("attention", "decode_attention_launch", _ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, S, D, float(scale), float(logit_soft_cap),
        _build.dtype_code(q), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    launches += 1
    return out
