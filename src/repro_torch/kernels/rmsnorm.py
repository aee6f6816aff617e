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
import struct

import torch
from torch.distributed.tensor import Replicate

from repro_torch.distributed import local_shards
from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm as plain

launches = 0

# csrc/rmsnorm.cu's RmsArgs, passed as one block (a ctypes call costs per
# argument): 3 pointers, 2 ints, a float, 3 ints, the stream
_PACK = struct.Struct("<3Q2if3iQ")
_fn = None                   # the bound C function, once the library is loaded


def _launch(x, w, eps, gemma_style):
    global launches, _fn
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    if _fn is None:
        _fn = _build.bind("rmsnorm", "rmsnorm_launch", (ctypes.c_char_p,))
    err = _fn(_PACK.pack(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, eps,
                         gemma_style, _build.DTYPES[x.dtype], _build.DTYPES[w.dtype],
                         _build.raw_stream(x.device)))
    if err:
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
    """x (..., D) float32/bfloat16, w (D,) -> y like x. On DTensors the
    rows are normalised where they lie: x may stay split along every dim
    but the last, w is replicated (its gradient a partial sum over the
    split dims)."""
    if local_shards.any_dtensor(x, w):
        mesh = local_shards.mesh_of(x, w)
        keep = local_shards.kept_shards((x,), mesh, range(x.ndim - 1))
        rep = (Replicate(),) * mesh.ndim
        return local_shards.on_local_shards(
            lambda xl, wl: rmsnorm(xl.contiguous(), wl.contiguous(), eps=eps,
                                   gemma_style=gemma_style),
            (x, w), (keep, rep), keep, (keep, local_shards.grad_partial(keep)))
    if _build.runs_plain(x):
        return plain(x, w, eps=eps, gemma_style=gemma_style)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if w.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w must be ({D},), got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")
    if x.dtype not in _build.DTYPES or w.dtype not in _build.DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, got x {x.dtype}, "
                        f"w {w.dtype}")
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return _RMSNorm.apply(x, w, float(eps), bool(gemma_style))
    return _launch(x, w, eps, gemma_style)
