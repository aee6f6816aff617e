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
``moe_dispatch="shard_map"`` takes the plain path, as the reference
does with no mesh; its manual expert-parallel dispatch belongs to the
distributed port (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    h1 = torch.bmm(xe, p["w1"].to(dt))
    h3 = torch.bmm(xe, p["w3"].to(dt))
    h = (F.silu(h1) if cfg.act == "silu" else F.gelu(h1, approximate="tanh")) * h3
    return torch.bmm(h, p["w2"].to(dt))


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


def _capacity(T: int, K: int, E: int, cf: float) -> int:
    """Rows of each expert's buffer: ceil(T K cf / E), at least 1, rounded
    up to a multiple of 8. T counts every token of the call, the idle
    slots of a decode tick too."""
    C = max(int(math.ceil(T * K * cf / E)), 1)
    return ((C + 7) // 8) * 8


def moe_mlp(x, p, cfg: ModelConfig, *, capacity_factor: float | None = None):
    """x (B, S, D) -> (B, S, D). Token-choice top-k with capacity drop."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    C = _capacity(T, K, E, cf)
    xt = x.reshape(T, D)

    gates, idx = _route(xt, p["router"], cfg, K)
    slot, keep = _slots(idx, E, C, K)

    # dispatch: scatter the unit -> token index into the slots (the trash
    # row past E * C takes the overflow and is cut off), gather the rows
    token_of_unit = torch.arange(T * K, device=x.device) // K
    inv = torch.full((E * C + 1,), -1, dtype=torch.int64, device=x.device)
    inv[slot] = token_of_unit
    inv = inv[:E * C]
    filled = inv >= 0
    xe = torch.where(filled[:, None], xt[inv.clamp_min(0)], 0).reshape(E, C, D)

    ye = _experts_ffn(xe, p, cfg).reshape(E * C, D)

    # combine: each unit's slot row (zeros for a dropped unit), weighted
    y_units = torch.cat([ye, ye.new_zeros(1, D)])[slot]
    gates_flat = (gates.reshape(T * K) * keep).to(y_units.dtype)
    y = (y_units * gates_flat[:, None]).reshape(T, K, D).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + layers.mlp(x, p["shared"], cfg).reshape(T, D)
    return y.reshape(B, S, D)


def load_balance_loss(logits, idx, cfg: ModelConfig):
    """Switch-style auxiliary load-balance loss (exposed for training)."""
    E = cfg.n_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, device=logits.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=logits.device)) / idx.numel()
    return E * torch.sum(me * ce)
