"""Fused RMSNorm: the hand-written Hopper kernel (``csrc/rmsnorm.cu``)
and its plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/rmsnorm.py::rmsnorm``. The
wrapper takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, on PyTorch's current stream, without synchronising;
``launches`` counts its launches so a run can show that the serving
path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain

launches = 0


_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p)


def rmsnorm(x, w, *, eps: float = 1e-5, gemma_style: bool = False):
    """x (..., D) float32/bfloat16, w (D,) -> y like x."""
    global launches
    if x.device.type == "cpu":
        return plain(x, w, eps=eps, gemma_style=gemma_style)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w must be ({D},), got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    err = _build.bind("rmsnorm", "rmsnorm_launch", _ARGS)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, float(eps),
        int(gemma_style), _build.dtype_code(x), _build.dtype_code(w),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rmsnorm")
    launches += 1
    return y
