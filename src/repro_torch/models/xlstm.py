"""xLSTM language model: mLSTM (matrix memory) + sLSTM (scalar memory)
blocks -- the JAX package's ``models/xlstm.py``, the reference's default
local tier (xlstm-125m).

Layout follows the xLSTM paper's 125M-scale recipe: mostly mLSTM blocks
with an sLSTM block every ``xlstm_slstm_every``-th layer. Both cells are
true recurrences with an O(1) decode state. The blocks are heterogeneous,
so params are per-layer dicts (``blocks/l{i}/...``, no stacking), with
the JAX package's key paths and ``(in, out)`` matmuls: a JAX tree carries
over by key path. The JAX package's ``lax.scan`` over time becomes a loop
over time steps; the cell math stays float32 and the states it hands
back are the reference's. States are returned as new tensors (as the
reference returns them), not written in place. The block norms run
``ops.rmsnorm`` (the Hopper kernel on the card); the cells and the
mLSTM ``out_norm`` are plain PyTorch, as they are plain array code in
the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (gather_grad_unless_divides,
                                              gather_unless_divides, grad_like, shard_as)
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, ParamDef, init_params, model_device
from repro_torch.models.lm import _lm_loss
from repro_torch.models.ssm import _causal_conv, _conv_step, _pad_time


def _pf_dim(cfg: ModelConfig) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


def mlstm_def(cfg: ModelConfig):
    d = cfg.d_model
    u = _pf_dim(cfg)
    H = cfg.n_heads
    return {
        "ln": layers.rmsnorm_def(d),
        "up": ParamDef((d, 2 * u), ("embed", "ffn"), init="scaled"),
        "conv_w": ParamDef((4, u), ("conv", "ffn"), init="scaled"),
        "conv_b": ParamDef((u,), ("ffn",), init="zeros"),
        "wq": ParamDef((u, u), ("ffn", "qkv"), init="scaled"),
        "wk": ParamDef((u, u), ("ffn", "qkv"), init="scaled"),
        "wv": ParamDef((u, u), ("ffn", "qkv"), init="scaled"),
        "wi": ParamDef((u, H), ("ffn", None), init="scaled"),
        "wf": ParamDef((u, H), ("ffn", None), init="scaled"),
        "fb": ParamDef((H,), (None,), init="ones"),     # forget-gate bias > 0
        "out_norm": ParamDef((u,), ("ffn",), init="ones"),
        "down": ParamDef((u, d), ("ffn", "embed"), init="scaled",
                         scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def slstm_def(cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    f = int(8 * d / 3)
    return {
        "ln": layers.rmsnorm_def(d),
        "wx": ParamDef((d, 4 * d), ("embed", "qkv"), init="scaled"),
        "r": ParamDef((H, dh, 4 * dh), (None, None, None), init="scaled"),
        "fb": ParamDef((H, dh), (None, None), init="ones"),
        "ln2": layers.rmsnorm_def(d),
        "up": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "gate": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "down": ParamDef((f, d), ("ffn", "embed"), init="scaled",
                         scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


# ---------------------------------------------------------------------------
# cells (single step, float32 state math)
# ---------------------------------------------------------------------------


class _LogSigmoidOfDTensor(torch.autograd.Function):
    """log sigmoid(x) with the gradient g * sigmoid(-x): DTensor has no
    sharding rule for ``log_sigmoid_backward``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.logsigmoid(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.sigmoid(-x)


def _logsigmoid(x):
    return _LogSigmoidOfDTensor.apply(x) if isinstance(x, DTensor) else F.logsigmoid(x)


def mlstm_cell_step(q, k, v, i_pre, f_pre, state):
    """q, k, v (B, H, dh); i_pre, f_pre (B, H); state = (C, n, m)."""
    C, n, m = state
    dh = q.shape[-1]
    log_f = _logsigmoid(f_pre.float())
    i_pre = i_pre.float()
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    kf = k.float() / math.sqrt(dh)
    vf = v.float()
    C_new = f_g[..., None, None] * C + i_g[..., None, None] * (vf[..., :, None] * kf[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", C_new, qf)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n_new, qf))
    h = num / torch.clamp_min(den, 1.0)[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def slstm_cell_step(preact, state):
    """preact (B, H, dh, 4) = [i, f, z, o] pre-activations; state = (c, n, h, m)."""
    c, n, h, m = state
    i_pre = preact[..., 0].float()
    f_pre = preact[..., 1].float()
    z = torch.tanh(preact[..., 2].float())
    o = torch.sigmoid(preact[..., 3].float())
    log_f = _logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, (c_new, n_new, h_new, m_new)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def mlstm_block(x, p, cfg: ModelConfig, state=None):
    """x (B, T, D). state = (conv_state (B, 3, u), C, n, m) or None (from
    zeros). Returns (y, new_state)."""
    B, T, D = x.shape
    u = _pf_dim(cfg)
    H = cfg.n_heads
    dh = u // H
    K = p["conv_w"].shape[0]

    resid = x
    xn = layers.rmsnorm(x, p["ln"], cfg)
    up = shard_as(xn @ p["up"].to(x.dtype), "batch", "seq", "ffn")
    uu, z = up[..., :u], up[..., u:]

    if state is None:
        C0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        conv_state, C0, n0, m0 = state

    if T == 1 and state is not None:
        c_out, new_conv = _conv_step(uu[:, 0], conv_state, p["conv_w"], p["conv_b"])
        c_out = F.silu(c_out)[:, None]
    elif state is not None:
        # scan continuation (chunked prefill): the causal conv is seeded
        # with the cached last K-1 inputs instead of zeros
        window = torch.cat([conv_state.to(uu.dtype), uu], dim=1)
        c_out = F.silu(_causal_conv(window, p["conv_w"], p["conv_b"])[:, -T:])
        new_conv = window[:, -(K - 1):, :]
    else:
        c_out = F.silu(_causal_conv(uu, p["conv_w"], p["conv_b"]))
        new_conv = _pad_time(uu, K - 1)[:, -(K - 1):, :]

    q = (c_out @ p["wq"].to(x.dtype)).reshape(B, T, H, dh)
    k = (c_out @ p["wk"].to(x.dtype)).reshape(B, T, H, dh)
    v = (uu @ p["wv"].to(x.dtype)).reshape(B, T, H, dh)
    i_pre = c_out @ p["wi"].to(x.dtype)                           # (B, T, H)
    f_pre = c_out @ p["wf"].to(x.dtype) + p["fb"].to(x.dtype)

    st, hs = (C0, n0, m0), []
    for t in range(T):
        h_t, st = mlstm_cell_step(q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t], st)
        hs.append(h_t)
    h = gather_grad_unless_divides(torch.stack(hs, dim=1).reshape(B, T, u), -1, H)

    hf = h.float()
    ha, hb = grad_like(hf), grad_like(hf)          # one gradient layout a use
    h = (ha * torch.rsqrt((hb * hb).mean(dim=-1, keepdim=True) + cfg.norm_eps)
         * p["out_norm"].float()).to(x.dtype)
    y = shard_as((h * F.silu(z)) @ p["down"].to(x.dtype), "batch", "seq", "embed")
    return resid + y, (new_conv, *st)


def slstm_block(x, p, cfg: ModelConfig, state=None):
    """x (B, T, D). state = (c, n, h, m), each (B, H, dh), or None."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H

    resid = x
    xn = layers.rmsnorm(x, p["ln"], cfg)
    # a projection split unevenly into its H heads is gathered first (DTensor)
    wx = gather_unless_divides(xn @ p["wx"].to(x.dtype), -1, H).reshape(B, T, H, dh, 4)

    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros,
                 torch.full((B, H, dh), -1e30, dtype=torch.float32, device=x.device))

    r = p["r"].float()
    fb = p["fb"].float()
    zero = torch.zeros_like(fb)
    fb4 = torch.stack((zero, fb, zero, zero), dim=-1)            # fb on the f gate
    hs = []
    for t in range(T):
        pre_r = torch.einsum("bhd,hdk->bhk", state[2], r).reshape(B, H, dh, 4)
        pre = wx[:, t].float() + pre_r + fb4
        h_t, state = slstm_cell_step(pre, state)
        hs.append(h_t)
    h = gather_grad_unless_divides(torch.stack(hs, dim=1).reshape(B, T, D), -1, H).to(x.dtype)
    x = resid + h

    # post-FFN (GLU)
    xn = layers.rmsnorm(x, p["ln2"], cfg)
    hh = F.silu(xn @ p["up"].to(x.dtype)) * (xn @ p["gate"].to(x.dtype))
    hh = shard_as(hh, "batch", "seq", "ffn")
    return x + shard_as(hh @ p["down"].to(x.dtype), "batch", "seq", "embed"), state


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class XLSTMLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        k = cfg.xlstm_slstm_every
        self.is_slstm = [k > 0 and (i % k) == (k - 1) for i in range(cfg.n_layers)]

    def param_defs(self):
        cfg = self.cfg
        blocks = {f"l{i}": slstm_def(cfg) if self.is_slstm[i] else mlstm_def(cfg)
                  for i in range(cfg.n_layers)}
        return {
            "embed": layers.embedding_def(cfg),
            "blocks": blocks,
            "ln_f": layers.rmsnorm_def(cfg.d_model),
            "lm_head": {"w": ParamDef((cfg.padded_vocab, cfg.d_model),
                                      ("vocab", "embed"), init="embed")},
        }

    def init(self, seed: int = 0, device=None):
        return init_params(self.param_defs(), seed, self.cfg.pdtype(), device)

    def _run_blocks(self, params, x, states=None):
        new_states = {}
        for i in range(self.cfg.n_layers):
            bp = params["blocks"][f"l{i}"]
            st = None if states is None else states[f"l{i}"]
            block = slstm_block if self.is_slstm[i] else mlstm_block
            x, new_states[f"l{i}"] = block(x, bp, self.cfg, st)
        return x, new_states

    def forward(self, params, tokens, extra=None):
        """Training forward from zero state: tokens (B, T) -> logits (B, T, V)."""
        x = layers.embed(tokens, params["embed"], self.cfg)
        x, _ = self._run_blocks(params, x)
        x = layers.rmsnorm(x, params["ln_f"], self.cfg)
        return layers.unembed(x, params["lm_head"], self.cfg)

    def loss(self, params, batch):
        return _lm_loss(self, params, batch)

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch, max_seq, device=None):
        """Per-layer recurrent state (no "kv_seq" axis, so ``max_seq`` is
        unused): mLSTM (conv window (B, 3, u) in the compute dtype, C, n,
        m float32), sLSTM (c, n, h, m float32); ``pos`` an int."""
        device = model_device(device)
        cfg = self.cfg
        u = _pf_dim(cfg)
        H = cfg.n_heads
        dh_m, dh_s = u // H, cfg.d_model // H
        f32 = dict(dtype=torch.float32, device=device)
        cache = {}
        for i in range(cfg.n_layers):
            if self.is_slstm[i]:
                cache[f"l{i}"] = (torch.zeros((batch, H, dh_s), **f32),
                                  torch.zeros((batch, H, dh_s), **f32),
                                  torch.zeros((batch, H, dh_s), **f32),
                                  torch.full((batch, H, dh_s), -1e30, **f32))
            else:
                cache[f"l{i}"] = (
                    torch.zeros((batch, 3, u), dtype=cfg.cdtype(), device=device),
                    torch.zeros((batch, H, dh_m, dh_m), **f32),
                    torch.zeros((batch, H, dh_m), **f32),
                    torch.full((batch, H), -1e30, **f32))
        return {"states": cache, "pos": 0}

    def cache_specs(self):
        cache = {}
        for i in range(self.cfg.n_layers):
            if self.is_slstm[i]:
                s = ("batch", "heads", None)
                cache[f"l{i}"] = (s, s, s, s)
            else:
                cache[f"l{i}"] = (("batch", None, "ffn"),
                                  ("batch", "heads", None, None),
                                  ("batch", "heads", None),
                                  ("batch", "heads"))
        return {"states": cache, "pos": ()}

    # ------------------------------------------------------------------ serving
    def prefill(self, params, tokens, cache, extra=None):
        """Continue the recurrence over ``tokens`` (B, T) from the cached
        state. Returns the last position's logits (B, V) and the cache
        with ``pos`` advanced by T."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], cfg)
        x, states = self._run_blocks(params, x, cache["states"])
        x = layers.rmsnorm(x, params["ln_f"], cfg)
        logits = layers.unembed(x[:, -1:], params["lm_head"], cfg)[:, 0]
        # the recurrent state carries all history: prefill is already a
        # continuation, and pos advances from wherever the cache left off
        return logits, {"states": states, "pos": cache["pos"] + tokens.shape[1]}

    # both cells are true recurrences, so a chunk is just another prefill
    prefill_chunk = prefill

    def decode_step(self, params, token, cache, extra=None):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int or
        a (B,) tensor. Returns logits (B, V) and the cache with ``pos``
        advanced."""
        cfg = self.cfg
        x = layers.embed(token, params["embed"], cfg)
        x, states = self._run_blocks(params, x, cache["states"])
        x = layers.rmsnorm(x, params["ln_f"], cfg)
        logits = layers.unembed(x, params["lm_head"], cfg)[:, 0]
        return logits, {"states": states, "pos": cache["pos"] + 1}
