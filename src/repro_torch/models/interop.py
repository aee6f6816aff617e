"""Carry the JAX package's parameters over to the port.

Torch's generators cannot reproduce ``jax.random``, so tests hand the
reference's weights to the port instead of initialising twice. Both
packages use the same key paths and layouts, so this is a leaf-by-leaf
copy with no transposes. W4A16 nodes (``{"qw", "scales", "zeros"}``)
carry over as they are: int32 codes and float32 scales and zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import torch_dtype

# ml_dtypes types numpy cannot hand to torch directly: same bits, same width
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                     # a writable host copy
    if a.dtype.name in _VIEWS:
        host, dt = _VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(host)).view(dt)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype=None):
    """The reference's param tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's nested dict of
    tensors on ``device``. ``dtype``, when given, casts the floating
    leaves of dense weights only: never a quantized node's int32 codes
    nor its float32 scales and zeros."""
    dt = torch_dtype(dtype) if dtype is not None else None

    def walk(node, cast):
        if isinstance(node, dict):
            keep = "qw" in node         # a quantized node keeps its dtypes
            return {k: walk(v, cast and not keep) for k, v in node.items()}
        t = _tensor(node).to(device)
        return t.to(dt) if cast and t.is_floating_point() else t

    return walk(tree, dt is not None)
