"""The kernels' wrappers under a mesh: placement rules for an opaque call.

The Hopper kernels are bound through ctypes, so a ``DTensor`` never
reaches a launch. A wrapper given DTensors runs its per-device body on
the local shards through ``local_map``: the plain version on the CPU,
the kernel on the card. The shards may stay split only along dims the
body treats independently; any other sharded input is gathered first,
as GSPMD lays out the operands of a custom call.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def any_dtensor(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def refuse_dtensor(name: str, *tensors):
    """Raise for a DTensor on the card, where the kernel has no caller
    under a mesh (serving runs on plain tensors). A DTensor that runs
    plain (meta or CPU shards, a FakeTensor: ``_build.runs_plain``) is let
    through: the wrapper's plain version then runs as DTensor ops, as the
    JAX package's plain path runs under GSPMD (the dry-run's decode cells)."""
    from repro_torch.kernels._build import runs_plain

    if any(isinstance(t, DTensor) and not runs_plain(t) for t in tensors):
        raise NotImplementedError(f"{name} takes no DTensor on the card: it has no "
                                  "caller under a mesh (serving runs on plain tensors)")


def mesh_of(*tensors):
    """The mesh of the first DTensor among ``tensors``."""
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def placement(t, i: int):
    """Mesh dim ``i``'s placement of ``t``; a plain tensor is replicated."""
    return t.placements[i] if isinstance(t, DTensor) else Replicate()


def common_shard(tensors, i: int, dims) -> Shard | None:
    """``Shard(d)`` where every tensor is sharded alike on mesh dim ``i``
    along a dim ``d`` in ``dims``, else None."""
    got = {placement(t, i) for t in tensors}
    p = got.pop() if len(got) == 1 else None
    return p if isinstance(p, Shard) and p.dim in dims else None


def kept_shards(tensors, mesh, dims) -> tuple:
    """One placement per mesh dim: the shard ``tensors`` share along a dim
    in ``dims`` (see :func:`common_shard`), else ``Replicate()``."""
    return tuple(common_shard(tensors, i, dims) or Replicate() for i in range(mesh.ndim))


def grad_partial(places) -> tuple:
    """A replicated operand's gradient placements where the others are
    ``places``: partial sums over each mesh dim that splits the work."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in places)


def on_local_shards(body, args, places, out_places, grad_places=None):
    """``body`` on the local shards of ``args`` through ``local_map``:
    each argument (a DTensor, a plain tensor taken as replicated, or None)
    is first laid out on its placements in ``places`` (a Partial sum
    reduced, a dim the body cannot split gathered), the way GSPMD lays
    out the operands of an opaque custom call; the outputs are DTensors
    on ``out_places``. ``grad_places`` are the placements of the
    arguments' gradients (default: their own). ``out_places`` is one
    output's placements, or a tuple of them for several. The body sees plain
    tensors, so it takes the plain version on the CPU and launches the
    kernel on the card."""
    mesh = mesh_of(*args)
    ins = []
    for a, pl in zip(args, places):
        if a is not None and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        if a is not None and tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        ins.append(a)
    in_places = tuple(None if a is None else tuple(pl) for a, pl in zip(ins, places))
    grads = in_places if grad_places is None else tuple(
        None if a is None else tuple(g) for a, g in zip(ins, grad_places))
    # local_map takes one output's placements as a list, several as a tuple of lists
    outs = (list(out_places) if all(isinstance(p, Placement) for p in out_places)
            else tuple(list(o) for o in out_places))
    return local_map(body, out_placements=outs, in_placements=in_places,
                     in_grad_placements=grads, device_mesh=mesh)(*ins)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands; on DTensors each device
    multiplies its own shards (``on_local_shards``). Per mesh dim: both
    split along one letter stay split (a batch letter splits the output,
    a contracted one leaves a partial sum; a replicated operand is split
    alike); else one split along a letter of its own stays split, the
    other operand gathered there; else both are gathered. DTensor's own
    rule folds the batch letters into one dim, which torch 2.11 cannot
    do where two of them are split."""
    if not any_dtensor(a, b):
        return torch.einsum(eq, a, b)
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = mesh_of(a, b)
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        sa, sb = placement(a, i), placement(b, i)
        ca = la[sa.dim] if isinstance(sa, Shard) else None
        cb = lb[sb.dim] if isinstance(sb, Shard) else None
        rep = Replicate()
        if ca is not None and cb is None and ca in lb and isinstance(sb, Replicate):
            cb, sb = ca, Shard(lb.index(ca))          # split b alike: no collective
        elif cb is not None and ca is None and cb in la and isinstance(sa, Replicate):
            ca, sa = cb, Shard(la.index(cb))
        if ca is not None and ca == cb:
            pa.append(sa), pb.append(sb)
            po.append(Shard(out.index(ca)) if ca in out else Partial())
        elif ca is not None and ca not in lb:
            pa.append(sa), pb.append(rep), po.append(Shard(out.index(ca)))
        elif cb is not None and cb not in la:
            pa.append(rep), pb.append(sb), po.append(Shard(out.index(cb)))
        else:
            pa.append(rep), pb.append(rep), po.append(rep)
    # a replicated operand's gradient is a partial sum over each mesh dim
    # that splits the other operand's letters it does not have
    ga = tuple(Partial() if isinstance(x, Replicate) and isinstance(y, Shard) else x
               for x, y in zip(pa, pb))
    gb = tuple(Partial() if isinstance(y, Replicate) and isinstance(x, Shard) else y
               for x, y in zip(pa, pb))
    return on_local_shards(lambda x, y: torch.einsum(eq, x, y), (a, b),
                           (tuple(pa), tuple(pb)), tuple(po), (ga, gb))
