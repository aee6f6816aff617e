"""Carry the JAX package's parameters over to the port.

Torch's generators cannot reproduce ``jax.random``, so tests hand the
reference's weights to the port instead of initialising twice. Both
packages use the same key paths and layouts, so this is a leaf-by-leaf
copy with no transposes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import torch_dtype, tree_map


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                     # a writable host copy
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype=None):
    """The reference's param tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> the port's nested dict of
    tensors on ``device``, cast to ``dtype`` when given."""
    dt = torch_dtype(dtype) if dtype is not None else None
    return tree_map(lambda a: _tensor(a).to(device=device, dtype=dt), tree)
