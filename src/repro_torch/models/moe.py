"""Top-k MoE with shared experts (DeepSeek-V2 / Grok-1 style): the JAX
package's ``models/moe.py`` for one device.

Dispatch is the capacity-bounded sorted-slot formulation of the
reference: each (token, k) unit gets a slot ``e * C + pos`` in its
expert's buffer of ``C`` rows, where ``pos`` is the unit's running
count over the flattened (T * K) units in token-major order; a unit past
capacity goes to the trash row ``E * C`` and is dropped. The buffers
are filled by gathering through the inverse index, the experts run as
batched matmuls over (E, C, D), and the outputs come back by gathering
each unit's slot, weighted by its gate. The reference computes all of
this outside any Pallas kernel, so here it is plain PyTorch too.

Param tree as the reference: ``router (D, E)``, ``w1/w3 (E, D, F)``,
``w2 (E, F, D)`` and, with shared experts, a gated MLP ``shared``.
``moe_dispatch="shard_map"`` under active rules and a ``DeviceMesh``
(``distributed.sharding.use_mesh``) takes :func:`moe_mlp_shard_map`, the
manual dispatch on each device's local shards; otherwise, as in the
reference, the plain path.
"""

from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (_active_mesh, _mesh_axis_sizes, current_rules,
                                              logical_to_pspec, shard_as, to_placements)
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, ParamDef


def moe_def(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None), init="scaled"),
        "w1": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"), init="scaled"),
        "w3": ParamDef((e, d, f), ("experts", "embed", "expert_ffn"), init="scaled"),
        "w2": ParamDef((e, f, d), ("experts", "expert_ffn", "embed"), init="scaled",
                       scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.n_shared_experts:
        defs["shared"] = layers.mlp_def(cfg, d_ff=(cfg.moe_d_ff or cfg.d_ff)
                                        * cfg.n_shared_experts)
    return defs


def _experts_ffn(xe, p, cfg: ModelConfig):
    """xe (E, C, D) -> (E, C, D), per-expert gated MLP."""
    dt = xe.dtype
    h1 = shard_as(torch.bmm(xe, p["w1"].to(dt)), "experts", "moe_cap", "expert_ffn")
    h3 = shard_as(torch.bmm(xe, p["w3"].to(dt)), "experts", "moe_cap", "expert_ffn")
    h = (F.silu(h1) if cfg.act == "silu" else F.gelu(h1, approximate="tanh")) * h3
    return shard_as(torch.bmm(h, p["w2"].to(dt)), "experts", "moe_cap", "embed")


def _route(xt, router, cfg: ModelConfig, K: int):
    """Float32 router logits, softmax, top-k: (gates (T, K), idx (T, K))."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)
    if cfg.router_renorm:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _slots(idx, E: int, C: int, K: int):
    """Capacity-bounded slot per (token, k) unit; E * C is the overflow
    (trash) row. Returns (slot (T * K,) int64, keep (T * K,) bool)."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos < C
    return torch.where(keep, flat_e * C + pos, E * C), keep


def _inverse_slots(slot, T: int, K: int, n: int):
    """(n,) int64: the token whose unit took each slot, -1 for an empty
    one (``slot`` (T * K,); the trash row ``n`` is cut off). Under a mesh
    the slot map is gathered and inverted on each device's copy, the
    result replicated: the scatter has no sharding rule in every torch
    release."""
    if isinstance(slot, DTensor):
        mesh = slot.device_mesh
        rep = (Replicate(),) * mesh.ndim
        inv = _inverse_slots(slot.redistribute(mesh, rep).to_local(), T, K, n)
        return DTensor.from_local(inv, mesh, rep, run_check=False)
    inv = torch.full((n + 1,), -1, dtype=torch.int64, device=slot.device)
    inv[slot] = torch.arange(T * K, device=slot.device) // K
    return inv[:n]


def _capacity(T: int, K: int, E: int, cf: float) -> int:
    """Rows of each expert's buffer: ceil(T K cf / E), at least 1, rounded
    up to a multiple of 8. T counts every token of the call, the idle
    slots of a decode tick too."""
    C = max(int(math.ceil(T * K * cf / E)), 1)
    return ((C + 7) // 8) * 8


class _SumOverModel(torch.autograd.Function):
    """The partial combine summed over the ``model`` group; the gradient
    of the sum reaches every partial unchanged."""

    @staticmethod
    def forward(ctx, y, group):
        y = funcol.all_reduce(y, "sum", group)
        # a meta tensor (the dry-run) comes back as it is, with nothing to wait for
        return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, y, s):
        ctx.s = s
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _a2a(t, group, n: int):
    """The tiled all-to-all over ``group`` (n ranks) along dim 0: chunk j
    of dim 0 goes to rank j; what comes back is stacked by source rank."""
    if n == 1:
        return t
    return funcol.all_to_all_single_autograd(t.contiguous(), None, None, group)


def moe_mlp_shard_map(x, p, cfg: ModelConfig, *, capacity_factor: float):
    """Manual expert dispatch on each device's local shards (the JAX
    package's shard_map dispatch): each data shard routes and scatters its
    LOCAL tokens into local expert buffers, with no cross-device scatter.
    Two regimes: expert-parallel when the experts divide over "model"
    (an all-to-all of expert blocks out and back, full d_ff local), else
    d_ff-parallel (each device's share of d_ff, the partial combine summed
    over "model"). The FSDP shards of the weights are gathered along the
    data axes first. Returns None (the caller takes the plain path) when
    the batch does not divide over the data axes, or without DTensors on
    a ``DeviceMesh``.

    Gradients: a rank's tokens are its own, so a weight replicated over
    the data axes gets a partial sum there; over "model" every rank routes
    the same tokens, so the replicated operands' gradients are partial
    sums over "model" too, with the copies' output gradients scaled by
    1 / |model| where no sum joins them."""
    mesh = _active_mesh()
    if not isinstance(mesh, DeviceMesh) or not isinstance(x, DTensor):
        return None
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    axes = _mesh_axis_sizes(mesh)
    dp = axes.get("data", 1) * axes.get("pod", 1)
    msize = axes.get("model", 1)
    if B % dp != 0:  # divisibility guard -> the plain path
        return None
    expert_parallel = (E % msize == 0) and msize > 1
    group = (mesh, mesh.mesh_dim_names.index("model")) if "model" in axes else None
    f_full = cfg.moe_d_ff or cfg.d_ff
    C = _capacity((B // dp) * S, K, E, capacity_factor)

    def local(xl, router, w1, w3, w2):
        f_is_sharded = w1.shape[2] != f_full
        xt = xl.reshape(-1, D)
        T = xt.shape[0]
        gates, idx = _route(xt, router, cfg, K)
        slot, keep = _slots(idx, E, C, K)
        x_units = xt[torch.arange(T * K, device=xt.device) // K]
        xe = xt.new_zeros(E * C + 1, D).index_add(0, slot, x_units)[:E * C].reshape(E, C, D)
        if expert_parallel:
            # every model shard routed the same tokens; exchange expert
            # blocks so shard m gets ALL capacity slices for its experts
            xe = _a2a(xe, group, msize).reshape(msize, E // msize, C, D)
            xe = xe.transpose(0, 1).reshape(E // msize, msize * C, D)
        dt = xe.dtype
        h1 = torch.bmm(xe, w1.to(dt))
        h3 = torch.bmm(xe, w3.to(dt))
        h = (F.silu(h1) if cfg.act == "silu" else F.gelu(h1, approximate="tanh")) * h3
        ye = torch.bmm(h, w2.to(dt))
        if expert_parallel:
            ye = ye.reshape(E // msize, msize, C, D).transpose(0, 1)
            ye = _a2a(ye, group, msize).reshape(E, C, D)
        # the combine is linear in ye, so it runs on the PARTIAL sums and
        # the (T, D) result is summed instead of the (E, C, D) buffers
        y_units = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)])[slot]
        gf = (gates.reshape(-1) * keep).to(y_units.dtype)
        y = (y_units * gf[:, None]).reshape(T, K, D).sum(dim=1)
        if f_is_sharded:
            y = _SumOverModel.apply(y, group)       # partial over the f shards
        elif msize > 1:
            y = _ScaleGrad.apply(y, 1.0 / msize)    # identical copies over "model"
        return y.reshape(xl.shape)

    def places(logical, shape, gathered):
        pl = to_placements(logical_to_pspec(logical, shape, mesh), mesh)
        # a weight's FSDP shards are gathered along the data axes
        return tuple(Replicate() if gathered and name in ("pod", "data") else q
                     for q, name in zip(pl, axes))

    ins = (x, p["router"], p["w1"], p["w3"], p["w2"])
    specs = ((("batch", None, None), False), (("embed", None), True),
             (("experts", "embed", "expert_ffn"), True),
             (("experts", "embed", "expert_ffn"), True),
             (("experts", "expert_ffn", "embed"), True))
    in_places = tuple(places(lg, t.shape, g) for t, (lg, g) in zip(ins, specs))
    grads = tuple(tuple(q if isinstance(q, Shard) else Partial() for q in pl)
                  for pl in in_places)
    ins = tuple(t.redistribute(mesh, pl) if tuple(t.placements) != pl else t
                for t, pl in zip(ins, in_places))
    out = local_map(local, out_placements=list(in_places[0]), in_placements=in_places,
                    in_grad_placements=grads, device_mesh=mesh)(*ins)
    if cfg.n_shared_experts:
        out = out + layers.mlp(x, p["shared"], cfg)
    return out


def moe_mlp(x, p, cfg: ModelConfig, *, capacity_factor: float | None = None):
    """x (B, S, D) -> (B, S, D). Token-choice top-k with capacity drop."""
    if cfg.moe_dispatch == "shard_map" and current_rules() is not None \
            and _active_mesh() is not None:
        cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
        y = moe_mlp_shard_map(x, p, cfg, capacity_factor=cf)
        if y is not None:
            return y
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    C = _capacity(T, K, E, cf)
    xt = shard_as(x.reshape(T, D), "batch", "embed")

    gates, idx = _route(xt, p["router"], cfg, K)
    slot, keep = _slots(idx, E, C, K)

    # dispatch: scatter the unit -> token index into the slots (the trash
    # row past E * C takes the overflow and is cut off), gather the rows
    inv = _inverse_slots(slot, T, K, E * C)
    filled = inv >= 0
    xe = torch.where(filled[:, None], xt[inv.clamp_min(0)], 0)
    # the JAX package lays the (E * C) rows out over "moe_cap" first and
    # GSPMD regroups them as (E, C) in place; DTensor cannot unflatten a
    # split dim into an E that the split does not divide, so the buffer
    # is laid out once regrouped
    xe = shard_as(xe.reshape(E, C, D), "experts", "moe_cap", "embed")

    ye = _experts_ffn(xe, p, cfg)
    if isinstance(ye, DTensor):     # torch 2.11 flattens (E, C) only where C is whole
        ye = ye.redistribute(ye.device_mesh, tuple(
            Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in ye.placements))
    ye = ye.reshape(E * C, D)

    # combine: each unit's slot row (zeros for a dropped unit), weighted
    y_units = torch.cat([ye, ye.new_zeros(1, D)])[slot]
    gates_flat = (gates.reshape(T * K) * keep).to(y_units.dtype)
    y = (y_units * gates_flat[:, None]).reshape(T, K, D).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + layers.mlp(x, p["shared"], cfg).reshape(T, D)
    return shard_as(y, "batch", "embed").reshape(B, S, D)


def load_balance_loss(logits, idx, cfg: ModelConfig):
    """Switch-style auxiliary load-balance loss (exposed for training)."""
    E = cfg.n_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, device=logits.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=logits.device)) / idx.numel()
    return E * torch.sum(me * ce)
