"""Train-step factory: loss -> grads -> AdamW, with optional microbatch
gradient accumulation (the JAX package's ``training/train.py``; the
accumulation is a Python loop where the JAX package scans).

The gradient is PyTorch autograd of ``model.loss``. On the card its
forward runs the Hopper kernels (``flash_attention``, ``rmsnorm``,
``ssd``); flash_attention's backward is a kernel of its own, rmsnorm's
and ssd's are autograd of their plain versions: the counterpart of the
JAX package, which trains through XLA's autodiff of the plain code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models.common import flatten, torch_dtype, tree_map, tree_unflatten
from repro_torch.serving.engine import resolve_device
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update


@dataclass
class TrainState:
    params: Any
    opt_state: Any


def make_train_step(model, oc: AdamWConfig, *, accum_steps: int = 1,
                    cast_params: str | None = None, grad_shardings=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place and returned.

    batch: {"tokens": (B, T) integer tensor, optional "loss_mask", optional
    "extra": {...} (the stub frames or patches, batch-major)}. With
    accum_steps > 1 every tensor of the batch, the extra ones included, is
    split along dim 0 into that many microbatches and their gradients
    averaged in float32.

    cast_params: cast the float32 masters to this dtype once at the top of
    the loss; gradients still reach the float32 leaves through the cast.

    Params may be DTensors on a mesh (``distributed.fault.elastic_restore``);
    call the step under ``distributed.sharding.use_mesh(mesh)``, which
    takes the batch's plain tensors as replicated, as JAX's ``with mesh:``
    does. The loss and metrics come back as plain tensors. grad_shardings:
    a tree of placements (the params' own, from ``shardings_for_mesh``)
    that each gradient, and the accumulator, is laid out on, as the JAX
    package constrains them.
    """

    def constrain(tree):
        if grad_shardings is None:
            return tree
        return tree_map(lambda g, pl: g.redistribute(g.device_mesh, pl), tree,
                        grad_shardings)

    def grads_of(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            used = live
            if cast_params is not None:
                dt = torch_dtype(cast_params)
                used = tree_map(lambda p: p.to(dt), live)
            loss, metrics = model.loss(used, batch)
            leaves = [t for _, t in flatten(live)]
            # a leaf the loss does not reach (the vision cross stack when a
            # batch brings no patches) gets a zero gradient, as under jax.grad
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        return (_plain(loss.detach()), {k: _plain(v.detach()) for k, v in metrics.items()},
                constrain(tree_unflatten(params, list(grads))))

    def apply(params, opt_state, parts):
        """The rest of the step after the gradients: ``parts`` yields
        ``grads_of``'s result for each microbatch (a generator, so that one
        microbatch's gradients are freed before the next is made); they
        are averaged in float32 where there are several, and AdamW
        applies them."""
        if accum_steps == 1:
            (loss, metrics, grads), = parts
        else:
            grads, losses, ms = None, [], []
            for loss_i, m_i, g in parts:
                losses.append(loss_i)
                ms.append(m_i)
                if grads is None:
                    grads = tree_map(lambda t: t.float(), g)
                else:
                    for (_, a), (_, b) in zip(flatten(grads), flatten(g)):
                        a.add_(b)
                del g
            for _, a in flatten(grads):
                a.div_(accum_steps)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, stats = adamw_update(grads, opt_state, params, oc)
        metrics = dict(metrics)
        metrics.update({k: _plain(v) for k, v in stats.items()})
        metrics["loss"] = loss
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        return apply(params, opt_state, (
            grads_of(params, microbatch(batch, i, accum_steps) if accum_steps > 1 else batch)
            for i in range(accum_steps)))

    # the step's two parts, for a caller that walks one microbatch and
    # counts it accum_steps times (launch/dryrun.py)
    train_step.grads_of, train_step.apply = grads_of, apply
    return train_step


def microbatch(batch, i: int, n: int):
    """Microbatch ``i`` of ``n``: rows [i * b, (i + 1) * b) of each tensor,
    b = rows / n. A DTensor split along its rows gives the i-th b / shards
    rows of each device's own shard instead, with no collective (a slice
    of a split dim would gather it whole): the n microbatches are then
    another partition of the same rows, so their averaged gradient is the
    same, as a data-parallel trainer accumulates each rank's own rows."""
    def one(x):
        b = x.shape[0] // n
        if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                          for p in x.placements):
            local = x.to_local()
            lb = local.shape[0] // n
            if lb * n == local.shape[0]:
                return DTensor.from_local(local[i * lb:(i + 1) * lb], x.device_mesh,
                                          x.placements, run_check=False,
                                          shape=(b,) + tuple(x.shape[1:]),
                                          stride=local[:lb].stride())
        return x[i * b:(i + 1) * b]

    return tree_map(one, batch)


def _plain(t):
    """A DTensor metric as the plain tensor it stands for."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def init_train_state(model, seed: int = 0, device=None):
    """Params from ``seed`` and fresh AdamW state, on ``device``: the CUDA
    card by default, which must be present (``device="cpu"`` for the CPU)."""
    params = model.init(seed, resolve_device(device))
    return params, adamw_init(params)
