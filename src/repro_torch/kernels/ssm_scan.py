"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel
(``csrc/ssd.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/ssm_scan.py::ssd``
(``_ssd_kernel``), and takes the initial state ``h0`` that the Pallas
kernel refuses but its serving caller passes: it computes what
``kernels/ref.py::ssd`` computes. One block per (batch, head) walks the
chunks in order with the (P, N) state in shared memory. A CPU tensor
takes the plain version; ``launches`` counts kernel launches. It has no gradient
yet (the hybrid family does not train): where autograd would record it,
it raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd as plain

launches = 0

_ARGS = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def ssd(x, dt, A, B, C, D, *, chunk: int = 64, h0=None):
    """x (b, T, H, P) float32/bfloat16; dt (b, T, H), A (H,), D (H,) and
    h0 (b, H, P, N) float32; B, C (b, T, N) of x's dtype; T a multiple of
    ``chunk`` -> y (b, T, H, P) in x's dtype, h_final (b, H, P, N) f32."""
    global launches
    _build.refuse_grad("ssd", x, dt, A, B, C, D, h0)
    dev = x.device
    if dev.type == "cpu":
        return plain(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    if dev.type != "cuda":
        raise ValueError(f"ssd kernel needs CUDA tensors, got {dev}")
    b, T, H, P = x.shape
    N = B.shape[-1]
    want = {"dt": (b, T, H), "A": (H,), "D": (H,), "B": (b, T, N), "C": (b, T, N)}
    got = {"dt": dt, "A": A, "D": D, "B": B, "C": C}
    if h0 is not None:
        want["h0"], got["h0"] = (b, H, P, N), h0
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"ssd kernel needs {name} contiguous on {dev}")
        f32 = name not in ("B", "C")
        if t.dtype != (torch.float32 if f32 else x.dtype):
            raise TypeError(f"{name} must be {'float32' if f32 else x.dtype}, got {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("ssd kernel needs a contiguous x")
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")
    y = torch.empty_like(x)
    h_out = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    if b * H == 0:
        return y, h_out
    err = _build.bind("ssd", "ssd_launch", _ARGS)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h_out.data_ptr(), b, T, H, P, N, chunk, _build.dtype_code(x),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"ssd (P={P}, N={N}, chunk={chunk}; the kernel is built for "
                      f"(P, N) = (16, 16) and (64, 64) within a block's shared memory)")
    launches += 1
    return y, h_out
