"""Fused RMSNorm: the hand-written Hopper kernel (``csrc/rmsnorm.cu``)
and its plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/rmsnorm.py::rmsnorm``. The
wrapper takes the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, on PyTorch's current stream, without synchronising;
``launches`` counts its launches so a run can show that a path went
through the kernel.

Gradient: the JAX package trains with the plain ``ref.rmsnorm`` under
XLA's autodiff (its Pallas kernel has no ``custom_vjp``). On the card,
``_RMSNorm``'s forward is the kernel and its backward recomputes the
plain version on the saved (x, w) and returns PyTorch autograd's
gradient of it: the counterpart of that autodiff. On the CPU the plain
version is differentiated directly.
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


def _launch(x, w, eps, gemma_style):
    global launches
    D = x.shape[-1]
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


class _RMSNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, w, eps, gemma_style):
        ctx.save_for_backward(x, w)
        ctx.args = dict(eps=eps, gemma_style=gemma_style)
        return _launch(x, w, eps, gemma_style)

    @staticmethod
    def backward(ctx, g):
        return _build.plain_backward(ctx, g, plain, 2)


def rmsnorm(x, w, *, eps: float = 1e-5, gemma_style: bool = False):
    """x (..., D) float32/bfloat16, w (D,) -> y like x."""
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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, gemma_style)
    return _launch(x, w, eps, gemma_style)
