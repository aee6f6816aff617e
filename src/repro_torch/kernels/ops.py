"""Kernel entry points the models call.

``rmsnorm``, ``flash_attention`` (whole-prompt prefill and training),
``decode_attention``, ``paged_attention`` (pages in q's dtype, or
int8/fp8 codes with ``k_scales``/``v_scales``), ``awq_matmul`` and
``ssd`` (the Mamba-2 chunked scan) are the kernels' wrappers, which
dispatch by device: a tensor on the CPU goes to the plain PyTorch
version, a CUDA tensor launches the hand-written Hopper kernel, or the
wrapper raises. There is no switch to pick one or the other, and no
fallback from a kernel that fails to build or launch. ``rmsnorm``,
``flash_attention`` and ``ssd`` are differentiable (flash_attention's
backward is a kernel of its own, rmsnorm's and ssd's are autograd of the
plain version, recomputed); the other three raise where autograd would
record them.

``chunk_attention``, ``gather_kv_pages``, ``gather_dequant_kv_pages``,
``kv_qmax``, ``quantize_kv``, ``dequantize_kv`` and ``ssd_step`` (the
O(1) decode recurrence) are plain PyTorch on every device, as they are plain array code in the JAX package.
"""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.awq_matmul import awq_matmul  # noqa: F401
from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.ref import (dequantize_kv, gather_dequant_kv_pages,  # noqa: F401
                                     gather_kv_pages, kv_qmax, quantize_kv, ssd_step)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
from repro_torch.kernels.ssm_scan import ssd  # noqa: F401


def chunk_attention(q, k, v, *, q_offset, kv_len, scale=None, logit_soft_cap=0.0):
    """Chunked-prefill attention: q (B,Hq,Sq,D) is a prompt chunk whose
    first query sits at absolute position ``q_offset``; k,v hold
    ``kv_len`` valid positions (the chunk's own K/V already written in).
    Causal across the chunk, full across the cached prefix."""
    return _ref.mha(q, k, v, causal=True, kv_len=kv_len, q_offset=q_offset,
                    scale=scale, logit_soft_cap=logit_soft_cap)
