"""AdamW with global-norm clipping, as functions on nested dicts of
tensors (the JAX package's ``training/optim.py``; no ``torch.optim``).

Moments are float32; params may be bfloat16 with float32 masters in the
optimizer state (``master_fp32``). Where the JAX package's functions are
pure, ``adamw_update`` works in place: each leaf of params, moments and
masters is updated with ``mul_``/``add_``/``addcmul_`` and the same
structures come back, and the gradients are consumed (clipped in place).
At minitron-8b width the embedding alone is 4.2 GB in float32, and a
functional update of the whole tree would hold several such copies at
once; in place, the largest transient is two of one leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.common import flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(step, oc: AdamWConfig):
    """Linear warmup then cosine decay to ``min_lr_ratio``; ``step`` an int
    or tensor, the math in float32 as in the JAX package -> a 0-dim
    float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.decay_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def adamw_init(params, *, master_fp32: bool = False):
    """Zero float32 moments, a 0-dim int32 ``step`` on the params' device,
    and with ``master_fp32`` float32 master copies of the params."""
    def zeros(p):               # a DTensor's moments are DTensors of its placements
        return torch.zeros_like(p, dtype=torch.float32)

    device = flatten(params)[0][1].device
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
          for _, t in flatten(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(grads, opt_state, params, oc: AdamWConfig):
    """Returns (params, opt_state, stats), the same structures updated in
    place. With a "master" entry in opt_state the update applies to the
    float32 masters and the live params take their cast."""
    step = opt_state["step"]
    step.add_(1)
    n = int(step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if oc.clip_norm else None)
    lr_t = schedule(n, oc)
    lr = float(lr_t)
    f32 = torch.float32
    b1c = float(1 - torch.tensor(oc.b1, dtype=f32) ** n)
    b2c = float(1 - torch.tensor(oc.b2, dtype=f32) ** n)
    masters = opt_state.get("master")
    leaves = zip(flatten(grads), flatten(opt_state["mu"]), flatten(opt_state["nu"]),
                 flatten(params), flatten(masters) if masters is not None else
                 flatten(params))
    for (_, g), (_, m), (_, v), (_, p), (_, base) in leaves:
        g = g.float()
        if scale is not None:
            g.mul_(scale)
        m.mul_(oc.b1).add_(g, alpha=1 - oc.b1)
        v.mul_(oc.b2).addcmul_(g, g, value=1 - oc.b2)
        del g
        work = base if base.dtype == f32 else base.float()
        denom = (v / b2c).sqrt_().add_(oc.eps)
        delta = (m / b1c).div_(denom)
        del denom
        if oc.weight_decay and p.ndim >= 2:       # as the JAX package: stacked (L, D) norms too
            delta.add_(work, alpha=oc.weight_decay)
        work.add_(delta, alpha=-lr)
        del delta
        if work is not p:
            p.copy_(work)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr_t}
