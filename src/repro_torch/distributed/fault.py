"""Elastic restart: restore a checkpoint onto a DIFFERENT mesh (the JAX
package's ``distributed/fault.py``).

Restarts rarely come back with the same topology (failed hosts drained,
pods resized). Checkpoints here hold full logical arrays per leaf, so
elasticity reduces to recomputing placements against the new mesh and
distributing each leaf: this module does that from the logical-axis
rules in one call, with the rules' divisibility guard replicating a dim
that does not divide rather than failing mid-restore.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import DEFAULT_RULES, spec_tree_to_shardings
from repro_torch.models.common import shape_tree, spec_tree
from repro_torch.training.checkpoint import CheckpointManager


def shardings_for_mesh(model, mesh, rules=None, dtype=None):
    """The params' placements on ``mesh`` from the model's logical specs."""
    defs = model.param_defs()
    shapes = shape_tree(defs, dtype or model.cfg.pdtype())
    return spec_tree_to_shardings(spec_tree(defs), shapes, mesh, rules or DEFAULT_RULES)


def elastic_restore(ckpt: CheckpointManager, model, mesh, *, step=None, rules=None):
    """Load the latest (or given) checkpoint and lay it out on ``mesh``,
    whatever shape that mesh has. Returns (params, aux, step), the params
    DTensors."""
    like = shape_tree(model.param_defs(), model.cfg.pdtype())
    shardings = shardings_for_mesh(model, mesh, rules)
    tree, aux, step = ckpt.restore(step, {"params": like},
                                   shardings={"params": shardings}, mesh=mesh)
    return tree["params"], aux, step
