"""Mamba-2 SSD chunked scan: the hand-written Hopper kernels
(``csrc/ssd.cu``) and their plain PyTorch version.

Replaces the JAX package's Pallas ``kernels/ssm_scan.py::ssd``
(``_ssd_kernel``), and takes the initial state ``h0`` that the Pallas
kernel refuses but its serving caller passes: it computes what
``kernels/ref.py::ssd`` computes. Two bodies, chosen by dtype: float32 on
CUDA cores, one block per (batch, head) walking the chunks in order (one
launch a call); bfloat16 on the tensor cores, the chunk cut into
``sub_chunk(chunk)``-step sub-chunks, one block each and a thread block
cluster a chunk, after a pass that forms C.B once for all heads (two
launches a call). A CPU tensor takes the plain version; ``launches``
counts kernel launches.

Gradient: the JAX package trains the hybrid family through XLA's
autodiff of the plain ``ref.ssd`` (its Pallas kernel has no backward).
On the card, ``_SSD``'s forward is the kernel and its backward
recomputes the plain version on the saved inputs and returns PyTorch
autograd's gradient of it (``_build.plain_backward``), as rmsnorm's does;
on the CPU the plain version is differentiated directly.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate

from repro_torch.distributed import local_shards
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd as plain

launches = 0

_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def sub_chunk(chunk: int) -> int:
    """The bf16 body's sub-chunk: 64 steps where the chunk is a multiple
    of 64, else 16 (0: a chunk it does not take). ``csrc/ssd.cu``'s
    ``sub_chunk`` is the same rule."""
    return 64 if chunk % 64 == 0 else 16 if chunk % 16 == 0 else 0


def _plain(x, dt, A, B, C, D, h0, *, chunk):
    return plain(x, dt, A, B, C, D, chunk=chunk, h0=h0)


class _SSD(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed on the saved inputs (h0 may be None)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.args = dict(chunk=chunk)
        return _launch(x, dt, A, B, C, D, chunk, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        return _build.plain_backward(ctx, (gy, gh), _plain, 1)


def ssd(x, dt, A, B, C, D, *, chunk: int = 64, h0=None):
    """x (b, T, H, P) float32/bfloat16; dt (b, T, H), A (H,), D (H,) and
    h0 (b, H, P, N) float32; B, C (b, T, N) of x's dtype; T a multiple of
    ``chunk`` -> y (b, T, H, P) in x's dtype, h_final (b, H, P, N) f32.

    On DTensors each device scans its own sequences: x, dt, B, C (and h0)
    may stay split alike along the batch; A and D are replicated (their
    gradients partial sums); any other layout is gathered first."""
    if local_shards.any_dtensor(x, dt, A, B, C, D, h0):
        batched = tuple(t for t in (x, dt, B, C, h0) if t is not None)
        mesh = local_shards.mesh_of(*batched, A, D)
        keep = local_shards.kept_shards(batched, mesh, (0,))
        rep, part = (Replicate(),) * mesh.ndim, local_shards.grad_partial(keep)
        return local_shards.on_local_shards(
            lambda x, dt, A, B, C, D, h0: ssd(
                x.contiguous(), dt.contiguous(), A, B.contiguous(), C.contiguous(), D,
                chunk=chunk, h0=None if h0 is None else h0.contiguous()),
            (x, dt, A, B, C, D, h0), (keep, keep, rep, keep, keep, rep, keep),
            (keep, keep), (keep, keep, part, keep, keep, part, keep))
    dev = x.device
    if _build.runs_plain(x):
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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, D, h0)):
        return _SSD.apply(x, dt, A, B, C, D, h0, chunk)
    return _launch(x, dt, A, B, C, D, chunk, h0)


def _launch(x, dt, A, B, C, D, chunk, h0):
    """The kernel on checked inputs: (y, h_final)."""
    global launches
    dev = x.device
    b, T, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    h_out = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    if b * H == 0:
        return y, h_out
    cb, n_launch = None, 1
    if x.dtype == torch.bfloat16:
        if any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError("ssd kernel needs 16-byte aligned x, B and C")
        # the C.B workspace: its lower-triangle 16 x 16 tiles, float32, a sub-chunk
        q = max(sub_chunk(chunk), 16)
        cb = torch.empty(b * T // q * (q // 16) * (q // 16 + 1) // 2 * 256, dtype=torch.float32,
                         device=dev)
        n_launch = 2
    err = _build.bind("ssd", "ssd_launch", _ARGS)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        D.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h_out.data_ptr(), cb.data_ptr() if cb is not None else None, b, T, H, P, N, chunk,
        _build.dtype_code(x), _build.raw_stream(dev))
    _build.check(err, f"ssd (P={P}, N={N}, chunk={chunk}; the kernel is built for "
                      f"(P, N) = (16, 16) and (64, 64); float32 within a block's shared "
                      f"memory, bfloat16 for chunks of up to 8 sub-chunks of 64 or 16)")
    launches += n_launch
    return y, h_out
