"""Build the Hopper kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own (with the ``csrc/*.cuh`` headers it includes) with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), with ptxas's report beside it (``build_log``). The
library name carries a hash of the source, the headers and the flags, so
an edited source rebuilds and an unchanged one loads straight away.
Builds happen at first use, never at import: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import is_fake

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("attention", "attention_quant", "awq_matmul", "decode_attention",
           "flash_attention", "flash_attention_bwd", "rmsnorm", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared headers rebuild every user
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together, and load them. Raises with nvcc's output when a
    build fails."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu ---\n{log}")
            else:
                out.with_suffix(".log").write_text(log)      # ptxas: registers, spills
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]


@functools.cache
def bind(lib: str, fn: str, argtypes: tuple, restype=ctypes.c_int):
    """The C function ``fn`` of library ``lib`` with its ctypes signature
    declared (pointers and the stream as ``c_void_p``)."""
    f = getattr(library(lib), fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def check(err: int, what: str):
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def refuse_grad(name: str, *tensors):
    """Raise where autograd would record a kernel that has no gradient:
    its output would have no ``grad_fn`` and cut the graph silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} kernel has no gradient: call it under "
                           "torch.no_grad() or on inputs that do not require grad")


def plain_backward(ctx, g, plain, n_args: int):
    """The backward of an ``autograd.Function`` whose forward is a kernel
    and whose gradient is autograd of the kernel's plain version: recompute
    ``plain`` on the saved tensors (``ctx.args`` its keyword arguments; a
    saved None stays None) and return the gradients of those that need
    one, then None for the ``n_args`` non-tensor arguments of ``forward``.
    ``g`` is the output's gradient, or a tuple of them where ``plain``
    returns a tuple."""
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        want = [t for t in ins if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(plain(*ins, **ctx.args), want, g))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in ins) + (None,) * n_args


def raw_stream(dev) -> int:
    """The current CUDA stream of ``dev`` as an int handle. The same as
    ``torch.cuda.current_stream(dev).cuda_stream`` without building a
    Stream object (~5 us a call on the card's host; a decode step makes
    one call a layer): the accessor Triton's launcher uses."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the kernels' dtype codes


def dtype_code(t) -> int:
    code = DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return code


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: each kernel's registers, shared memory
    and spills) from the build of ``csrc/<name>.cu``, where it was built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def runs_plain(t) -> bool:
    """True for a tensor the plain version takes: on the CPU or the meta
    device, or a FakeTensor (nothing is computed on the last two). A
    plain tensor on the card skips torch's fake check, a chain of Python
    tests that every launch would pay."""
    if t.device.type in ("cpu", "meta"):
        return True
    return type(t) is not torch.Tensor and is_fake(t)
