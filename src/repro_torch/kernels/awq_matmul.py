"""W4A16 grouped-dequant matmul (AWQ layout): the hand-written Hopper
kernel (``csrc/awq_matmul.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/awq_matmul.py::awq_matmul``
(``_awq_kernel``). The int4 codes stay packed in device memory and are
dequantized in registers; the K loop walks whole quantization groups
(each group's scale and zero read once), so the K tile follows the
group size, which must be a multiple of 64 (the tiling and the K split
live in the source). A CPU tensor takes the plain version;
``launches`` counts calls that launch the kernel (with its split-K
reduce, when K is split). It has no gradient: where autograd would
record it, it raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import awq_matmul as plain

launches = 0

_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


@functools.cache
def splits(M: int, K: int, N: int, group: int, device: torch.device) -> int:
    """How many ranges of whole groups the kernel splits K over on
    ``device`` (the tiling lives in ``csrc/awq_matmul.cu``); raises where
    the kernel does not take the group."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = _build.bind("awq_matmul", "awq_matmul_splits", (ctypes.c_int,) * 5)(
        M, K, N, group, sms)
    if n < 1:
        raise ValueError(f"awq_matmul kernel does not take group_size={group} at K={K}: "
                         "a multiple of 64 that fits one staged chunk of x")
    return n


def awq_matmul(x, qw, scales, zeros, *, bits: int = 4, group_size: int = 128):
    """x (M, K) float32/bfloat16; qw (K/8, N) int32; scales, zeros
    (K/group_size, N) float32 -> (M, N) in x's dtype."""
    global launches
    _build.refuse_grad("awq_matmul", x, scales, zeros)
    if x.device.type == "cpu":
        return plain(x, qw, scales, zeros, bits=bits, group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"awq_matmul kernel needs CUDA tensors, got {x.device}")
    if bits != 4:
        raise ValueError(f"awq_matmul kernel takes 4-bit codes, got bits={bits}")
    M, K = x.shape
    N = qw.shape[1]
    if K % group_size:
        raise ValueError(f"K={K} is not a multiple of group_size={group_size}")
    if qw.shape != (K // 8, N) or qw.dtype != torch.int32:
        raise TypeError(f"qw must be ({K // 8}, {N}) int32, got "
                        f"{tuple(qw.shape)} {qw.dtype}")
    for name, t in (("scales", scales), ("zeros", zeros)):
        if t.shape != (K // group_size, N) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be ({K // group_size}, {N}) float32, got "
                            f"{tuple(t.shape)} {t.dtype}")
    for t in (x, qw, scales, zeros):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("awq_matmul kernel needs contiguous tensors on one device")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    n_split = splits(M, K, N, group_size, x.device)
    partial = (torch.empty((n_split, M, N), dtype=torch.float32, device=x.device)
               if n_split > 1 else out)
    err = _build.bind("awq_matmul", "awq_matmul_launch", _ARGS)(
        x.data_ptr(), qw.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        partial.data_ptr(), out.data_ptr(), M, K, N, group_size, n_split,
        _build.dtype_code(x), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "awq_matmul")
    launches += 1
    return out
