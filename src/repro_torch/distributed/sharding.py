"""Logical-axis sharding rules over a ``DeviceMesh`` (the JAX package's
``distributed/sharding.py``).

Model code annotates tensors and parameters with *logical* axis names
("batch", "embed", "heads", "ffn", "vocab", "experts", "kv_seq", ...).
A rule set maps logical names to mesh axes; the mapping is resolved
against the mesh that is active (:func:`use_mesh`), so the same model
code runs on plain tensors (rules or mesh inactive, or no ``DTensor``:
:func:`shard_as` is a no-op), on a one-device mesh, and on the
(data, model) or (pod, data, model) meshes without change.

Divisibility guard: a logical dim is bound to mesh axes only if its size
is divisible by the product of their sizes; otherwise a leading axis is
dropped ("pod" first) until it divides, or the dim is replicated. That
lets a 4-head model and a 64-head model share one rule set.

A :class:`PartitionSpec` is a tuple with one entry a tensor dim (None, a
mesh axis name, or a tuple of names), as JAX's; :func:`to_placements`
turns it into the ``Shard``/``Replicate`` list DTensor takes, one entry
a mesh dim. The JAX package's ``get_abstract_mesh`` and
``shard_map_compat`` bridge JAX's API drift and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# Logical axis name -> mesh axis name(s). Values may be a string, a tuple of
# strings (sharded over the product of those axes), or None (replicated).
AxisRules = Mapping[str, Any]

# The default production rule set. "pod" and "data" jointly form the
# DP/FSDP domain; "model" is the TP/EP domain.
DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),            # FSDP shard dim for params (largest dim)
    "fsdp_big": ("pod", "data"),  # FSDP over pods too (>=60B models)
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "qkv": ("model",),            # flattened head*dim projections
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ffn": ("model",),     # fallback when expert count not divisible
    "moe_cap": ("data",),         # expert-capacity dim of dispatch buffers
    "seq": None,
    "res_seq": None,              # residual-stream seq; ("model",) = seq-parallel
    "kv_seq": None,               # bound to ("data",) for long-context decode
    "conv": None,
    "state": None,
    "layers": None,
}


class _State(threading.local):
    def __init__(self):
        self.rules: AxisRules | None = None
        self.mesh = None


_STATE = _State()


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, in that order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices or process group:
    what the rules resolve against when nothing runs."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"sizes {tuple(axis_sizes)} vs names {tuple(axis_names)}")
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None):
    """Activate a logical->mesh rule set for the enclosed code."""
    prev = _STATE.rules
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> AxisRules | None:
    return _STATE.rules


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` or an :class:`AbstractMesh`) the
    active mesh of the enclosed code, as JAX's ``with mesh:``. Inside it a
    plain tensor that meets a DTensor is taken as replicated (the
    positions, masks and batches the models make), as jit takes an
    unsharded array. The mesh is this thread's; the replication is
    torch's one flag for the process, set on entry and put back as it was
    on exit (a caller's own ``implicit_replication`` outlives this one)."""
    dispatcher = DTensor._op_dispatcher
    prev, prev_rep = _STATE.mesh, dispatcher._allow_implicit_replication
    _STATE.mesh = mesh
    dispatcher._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        _STATE.mesh = prev
        dispatcher._allow_implicit_replication = prev_rep


def _active_mesh():
    return _STATE.mesh


def _mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names for logical rules")
    return dict(zip(names, mesh.shape))


def _resolve_one(name: str | None, dim: int | None, mesh, rules: AxisRules):
    """Map one logical axis name to mesh axes, with divisibility guard."""
    if name is None:
        return None
    target = rules.get(name, None)
    if target is None:
        return None
    if isinstance(target, str):
        target = (target,)
    sizes = _mesh_axis_sizes(mesh)
    axes = tuple(a for a in target if a in sizes)     # axes present in this mesh
    if not axes:
        return None
    if dim is not None:
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if dim % prod != 0:
            # try progressively shorter prefixes (e.g. drop "pod")
            while axes:
                axes = axes[1:]
                prod = 1
                for a in axes:
                    prod *= sizes[a]
                if axes and dim % prod == 0:
                    break
            if not axes:
                return None
    return axes[0] if len(axes) == 1 else axes


def logical_to_pspec(logical: Sequence[str | None], shape: Sequence[int] | None = None,
                     mesh=None, rules: AxisRules | None = None) -> PartitionSpec:
    """Resolve a tuple of logical axis names to a :class:`PartitionSpec`."""
    rules = rules if rules is not None else (_STATE.rules or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _active_mesh()
    if mesh is None:
        return PartitionSpec(*([None] * len(logical)))
    used: set[str] = set()
    out = []
    for i, name in enumerate(logical):
        r = _resolve_one(name, None if shape is None else shape[i], mesh, rules)
        # a mesh axis may appear at most once in a PartitionSpec
        if r is not None:
            raxes = (r,) if isinstance(r, str) else tuple(r)
            if any(a in used for a in raxes):
                r = None
            else:
                used.update(raxes)
        out.append(r)
    return PartitionSpec(*out)


def to_placements(pspec: Sequence, mesh) -> tuple:
    """A :class:`PartitionSpec` as DTensor placements on ``mesh``: per mesh
    dim, ``Shard(d)`` for the tensor dim ``d`` that names it, else
    ``Replicate()``. A dim sharded over several axes takes ``Shard(d)`` on
    each of them; DTensor splits in mesh order, as JAX does for the
    rules' ("pod", "data")."""
    where = {}
    for d, entry in enumerate(pspec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in _mesh_axis_sizes(mesh))


def shard_as(x, *logical: str | None):
    """Lay ``x`` out by logical axis names (``with_sharding_constraint``):
    a no-op unless rules and a mesh are active and ``x`` is a DTensor."""
    if _STATE.rules is None:
        return x
    mesh = _active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical, shape=x.shape, mesh=mesh)
    if all(s is None for s in spec):
        return x
    # contiguous first: a redistribution's gradient is a DTensor of x's
    # strides over a contiguous gathered shard, and a transposed x (heads
    # split off a projection) would disagree with it (a view then fails).
    # The layout is constrained even where x has it already: the backward
    # lays the gradient out alike, as GSPMD's constraint does
    x = x.contiguous()
    if any(p.is_partial() and type(p) is not Partial for p in x.placements):
        # a masked partial sum (an embedding over a vocab-sharded table)
        # is reduced on its own first: DTensor cannot also split its dims
        x = x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                                for p in x.placements))
    return x.redistribute(x.device_mesh, to_placements(spec, mesh))


def gather_unless_divides(x, dim: int, n: int):
    """``x`` with ``dim`` gathered where the mesh dims that split it do not
    divide ``n``: a dim about to be reshaped into ``n`` groups (a
    projection into its heads), which DTensor cannot unflatten unevenly
    and GSPMD would reshard. A no-op off DTensors."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    prod = 1
    for i in split:
        prod *= x.device_mesh.size(i)
    if n % prod == 0:
        return x
    keep = tuple(Replicate() if i in split else p for i, p in enumerate(x.placements))
    return x.contiguous().redistribute(x.device_mesh, keep)


class _GatherGradUnlessDivides(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.n = dim, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_unless_divides(g, ctx.dim, ctx.n), None, None


def gather_grad_unless_divides(x, dim: int, n: int):
    """``x`` unchanged, its gradient gathered as :func:`gather_unless_divides`
    gathers: for heads merged into one dim (``(B, T, H, dh) -> (B, T, H *
    dh)``), whose gradient is split back into the H heads. A no-op off
    DTensors."""
    if not isinstance(x, DTensor):
        return x
    return _GatherGradUnlessDivides.apply(x, dim, n)


class _GradLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # a partial sum's gradient is replicated
        ctx.mesh = x.device_mesh
        ctx.places = tuple(Replicate() if q.is_partial() else q for q in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.places)


def grad_like(x):
    """``x`` unchanged, its gradient laid out as ``x`` is. Where a tensor
    has several uses (a tied embedding, a norm's input), torch 2.11's
    DTensor may fail to add their gradients (a split dim against a
    partial sum): each use taken through ``grad_like`` hands back one
    layout. A no-op off DTensors."""
    if not isinstance(x, DTensor):
        return x
    return _GradLike.apply(x)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None))) for e in s)


def spec_tree_to_shardings(spec_tree, shape_tree, mesh, rules: AxisRules | None = None):
    """Map a tree of logical-axis tuples (and the matching tree of shaped
    leaves, e.g. meta tensors from ``shape_tree``) to a tree of placement
    tuples on ``mesh``. Dicts, tuples and lists of specs are walked (the
    xLSTM's cache nests tuples of them); a leaf with no shape (a cache's
    "pos" int) is resolved with no divisibility guard."""
    rules = rules or DEFAULT_RULES

    def walk(spec, like):
        if _is_spec(spec):
            return to_placements(logical_to_pspec(spec, shape=getattr(like, "shape", None),
                                                  mesh=mesh, rules=rules), mesh)
        if isinstance(spec, dict):
            return {k: walk(v, like[k]) for k, v in spec.items()}
        return type(spec)(walk(v, w) for v, w in zip(spec, like))

    return walk(spec_tree, shape_tree)
