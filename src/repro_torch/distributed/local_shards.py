"""The kernels' wrappers under a mesh: placement rules for an opaque call.

The Hopper kernels are bound through ctypes, so a ``DTensor`` never
reaches a launch. A wrapper given DTensors runs its per-device body on
the local shards through ``local_map``: the plain version on the CPU,
the kernel on the card. The shards may stay split only along dims the
body treats independently; any other sharded input is gathered first,
as GSPMD lays out the operands of a custom call.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def any_dtensor(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def refuse_dtensor(name: str, *tensors):
    """Raise for a kernel that has no caller under a mesh."""
    if any_dtensor(*tensors):
        raise NotImplementedError(f"{name} takes no DTensor: it has no caller under a "
                                  "mesh (serving runs on plain tensors)")


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
