"""Kernel entry points the models call.

``rmsnorm``, ``decode_attention`` and ``paged_attention`` are the
kernels' wrappers, which dispatch by device: a tensor on the CPU goes to
the plain PyTorch version, a CUDA tensor launches the hand-written
Hopper kernel, or the wrapper raises. There is no switch to pick one or
the other, and no fallback from a kernel that fails to build or launch.

``chunk_attention`` and ``gather_kv_pages`` are plain PyTorch on every
device, as they are plain array code in the JAX package.
"""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401


def chunk_attention(q, k, v, *, q_offset, kv_len, scale=None, logit_soft_cap=0.0):
    """Chunked-prefill attention: q (B,Hq,Sq,D) is a prompt chunk whose
    first query sits at absolute position ``q_offset``; k,v hold
    ``kv_len`` valid positions (the chunk's own K/V already written in).
    Causal across the chunk, full across the cached prefix."""
    return _ref.mha(q, k, v, causal=True, kv_len=kv_len, q_offset=q_offset,
                    scale=scale, logit_soft_cap=logit_soft_cap)


def gather_kv_pages(pages, block_tables):
    """Pool pages (P,H,page,D) + tables (B,n) -> the contiguous per-slot
    view (B,H,n*page,D), for the chunked-prefill path."""
    return _ref.gather_kv_pages(pages, block_tables)
