"""Mesh construction over ``torch.distributed`` (the JAX package's
``launch/mesh.py``).

Functions, not module-level constants, so importing this module never
touches a process group. ``make_production_mesh`` needs a world of 256
(or 512) ranks; on one machine that is torch's fake process group
(``init_process_group("fake", store=FakeStore(), ...)``), the counterpart
of the JAX package's ``--xla_force_host_platform_device_count=512``.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.serving.engine import resolve_device


def _mesh_device_type() -> str:
    """The mesh's device type: "cuda" over NCCL and over the fake process
    group, which stands for H100s on NCCL, so that DTensor takes NCCL's
    routes (a Shard-to-Shard redistribution is one all-to-all; on a "cpu"
    mesh it is an all-gather and a chunk). The fake world's tensors are
    meta tensors."""
    return "cuda" if dist.get_backend() in ("nccl", "fake") else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {shape} needs a process group of {n} "
                           f"ranks (on one machine, the fake process group)")
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def make_local_mesh(device=None):
    """An (n, 1) ("data", "model") mesh over the processes that exist, on
    ``device`` (the CUDA card by default, which must be present; "cpu"
    for gloo). Where no process group runs, starts a world of one
    (NCCL on the card, gloo on the CPU) over an in-memory store."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh lives on the card or the CPU, not {dev}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
