"""Mamba-2 block and the Zamba2-style hybrid LM: the JAX package's
``models/ssm.py``, for serving and training.

Zamba2 is a backbone of Mamba-2 layers with ONE shared transformer block
(full attention + MLP) invoked every ``attn_every``-th layer, so the
shared block's KV cache has one entry per invocation: (n_invocations, B,
Hkv, S, Dh). Params keep the JAX package's layout (blocks stacked on a
leading layer axis, ``shared`` unstacked, ``(in, out)`` matmuls), so a
JAX tree carries over by key path. The JAX package's ``lax.scan`` over
layers becomes a Python loop, its ``lax.cond`` on ``idx % attn_every`` a
Python ``if``; the conv, SSM and shared-block K/V caches are written in
place. Chunked prefill runs the SSD scan (``ops.ssd``, the Hopper kernel
on the card) as a continuation from the cached state; decode the O(1)
``ops.ssd_step``. The training forward (``forward``, ``loss``) and the
whole-prompt ``prefill`` run the scan from zero state; the training
forward recomputes each layer in the backward pass when ``cfg.remat``
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``), and
``ops.ssd``'s gradient is autograd of its plain version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import shard_as
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, ParamDef, init_params, model_device
from repro_torch.models.lm import _layer, _lm_loss, _remat, _stack

# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def mamba2_def(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.n_ssm_heads
    conv_dim = di + 2 * N
    return {
        "ln": layers.rmsnorm_def(d, cfg.gemma_style),
        "in_proj": ParamDef((d, 2 * di + 2 * N + H), ("embed", "ffn"), init="scaled"),
        "conv_w": ParamDef((cfg.ssm_conv_kernel, conv_dim), ("conv", "ffn"), init="scaled"),
        "conv_b": ParamDef((conv_dim,), ("ffn",), init="zeros"),
        "dt_bias": ParamDef((H,), (None,), init="ssm_dt"),
        "A_log": ParamDef((H,), (None,), init="ssm_a"),
        "D": ParamDef((H,), (None,), init="ones"),
        "out_norm": ParamDef((di,), ("ffn",), init="ones"),
        "out_proj": ParamDef((di, d), ("ffn", "embed"), init="scaled",
                             scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def _pad_time(x, front: int, back: int = 0):
    """x (B, T, C) with zero rows before and after along T: ``F.pad``; on
    a DTensor a concatenation, as torch 2.11's padding rule drops a mesh
    dim from the placements (``mla._pad_v``)."""
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, front, back))
    B, _, C = x.shape
    parts = [x.new_zeros(B, front, C)] if front else []
    return torch.cat(parts + [x] + ([x.new_zeros(B, back, C)] if back else []), dim=1)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, T, C), w (K, C) -> (B, T, C)."""
    K, T = w.shape[0], x.shape[1]
    xp = _pad_time(x, K - 1)
    out = torch.zeros_like(x)
    for i in range(K):  # K is 4: unrolled adds, no conv primitive needed
        out = out + xp[:, i:i + T, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _conv_step(x_t, conv_state, w, b):
    """x_t (B, C), conv_state (B, K-1, C) -> (y_t, new_state)."""
    window = torch.cat([conv_state.to(x_t.dtype), x_t[:, None, :]], dim=1)   # (B, K, C)
    y = (window * w.to(x_t.dtype)).sum(dim=1) + b.to(x_t.dtype)
    return y, window[:, 1:, :]


def _split_inproj(h, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    return h[..., :di], h[..., di:2 * di + 2 * N], h[..., 2 * di + 2 * N:]


def _scan(xs, Bm, Cm, dt, A, D, cfg: ModelConfig, h0=None):
    """Pad the time axis to whole SSD chunks (pad steps carry dt = 0, so
    they leave the state unchanged) and run the chunked scan. xs
    (B, T, di) -> y (B, T, di), final state (B, H, P, N) float32."""
    B, T, _ = xs.shape
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    pad = (-T) % cfg.ssm_chunk
    if pad:
        xs, Bm, Cm, dt = (_pad_time(t, 0, pad) for t in (xs, Bm, Cm, dt))
    y, h_last = ops.ssd(xs.reshape(B, T + pad, H, P).contiguous(),
                        dt.reshape(B, T + pad, H).contiguous(), A, Bm.contiguous(),
                        Cm.contiguous(), D, chunk=cfg.ssm_chunk, h0=h0)
    return y[:, :T].reshape(B, T, -1), h_last


def mamba2_block(x, p, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                 chunk_states=None):
    """x (B, T, D). With ``ssm_state`` and T == 1 runs the recurrent step
    from (``conv_state``, ``ssm_state``); with ``chunk_states=(conv (B,
    K-1, C), ssm (B, H, P, N))`` the SSD scan as a continuation from those
    states (chunked prefill: the causal conv is seeded with the previous
    K-1 inputs and the scan with h0); otherwise the scan from zero state
    (training, whole-prompt prefill). Returns (y, new_conv_state,
    new_ssm_state); the from-zero scan returns the conv state only when
    ``conv_state`` is given (any value: the JAX package's sentinel)."""
    B, T, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    K = cfg.ssm_conv_kernel

    resid = x
    xn = layers.rmsnorm(x, p["ln"], cfg)
    h = xn @ p["in_proj"].to(x.dtype)                                  # (B, T, 2di+2N+H)
    h = shard_as(h, "batch", "seq", "ffn")
    z, xbc, dt = _split_inproj(h, cfg)
    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    Dh = p["D"].float()

    if ssm_state is not None and T == 1:
        c_out, new_conv = _conv_step(xbc[:, 0], conv_state, p["conv_w"], p["conv_b"])
        c_out = F.silu(c_out)
        xs, Bm, Cm = c_out[:, :di], c_out[:, di:di + N], c_out[:, di + N:]
        y, new_ssm = ops.ssd_step(xs.reshape(B, H, P), dt[:, 0], A, Bm, Cm, Dh, ssm_state)
        y = y.reshape(B, 1, di)
    elif chunk_states is not None:       # scan continuation (chunked prefill)
        conv_prev, h0 = chunk_states
        window = torch.cat([conv_prev.to(xbc.dtype), xbc], dim=1)
        c_out = F.silu(_causal_conv(window, p["conv_w"], p["conv_b"])[:, -T:])
        y, new_ssm = _scan(c_out[..., :di], c_out[..., di:di + N], c_out[..., di + N:],
                           dt, A, Dh, cfg, h0=h0)
        new_conv = window[:, -(K - 1):, :]
    else:
        c_out = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        y, new_ssm = _scan(c_out[..., :di], c_out[..., di:di + N], c_out[..., di + N:],
                           dt, A, Dh, cfg)
        new_conv = None if conv_state is None else _prefill_conv_state(xbc, cfg)

    y = y * F.silu(z.to(y.dtype))
    yf = y.float()
    y = (yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + cfg.norm_eps)
         * p["out_norm"].float()).to(x.dtype)
    out = shard_as(resid + y @ p["out_proj"].to(x.dtype), "batch", "seq", "embed")
    return out, new_conv, new_ssm


def _prefill_conv_state(xbc, cfg: ModelConfig):
    """Last K-1 inputs of the conv, for continuing in decode."""
    K, T = cfg.ssm_conv_kernel, xbc.shape[1]
    if T >= K - 1:
        return xbc[:, T - (K - 1):, :]
    return _pad_time(xbc, K - 1 - T)


# ---------------------------------------------------------------------------
# Zamba2 hybrid LM
# ---------------------------------------------------------------------------


class HybridLM:
    """Mamba-2 backbone + shared attention/MLP block every k layers."""

    def __init__(self, cfg: ModelConfig):
        if cfg.attn_every <= 0:
            raise ValueError(f"{cfg.name}: a hybrid model needs attn_every > 0")
        self.cfg = cfg
        self.n_invocations = cfg.n_layers // cfg.attn_every

    # ------------------------------------------------------------------ params
    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": layers.embedding_def(cfg),
            "blocks": _stack(mamba2_def(cfg), cfg.n_layers),
            "shared": {
                "ln1": layers.rmsnorm_def(cfg.d_model),
                "attn": layers.attention_def(cfg),
                "ln2": layers.rmsnorm_def(cfg.d_model),
                "mlp": layers.mlp_def(cfg),
            },
            "ln_f": layers.rmsnorm_def(cfg.d_model, cfg.gemma_style),
            "lm_head": {"w": ParamDef((cfg.padded_vocab, cfg.d_model),
                                      ("vocab", "embed"), init="embed")},
        }

    def init(self, seed: int = 0, device=None):
        return init_params(self.param_defs(), seed, self.cfg.pdtype(), device)

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch, max_seq, device=None):
        device = model_device(device)
        cfg = self.cfg
        L, K = cfg.n_layers, cfg.ssm_conv_kernel
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        dt = cfg.cdtype()
        kv = (self.n_invocations, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {
            "conv": torch.zeros((L, batch, K - 1, conv_dim), dtype=dt, device=device),
            "ssm": torch.zeros((L, batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32, device=device),
            "attn_k": torch.zeros(kv, dtype=dt, device=device),
            "attn_v": torch.zeros(kv, dtype=dt, device=device),
            "pos": 0,
        }

    def cache_specs(self):
        return {
            "conv": ("layers", "batch", None, "ffn"),
            "ssm": ("layers", "batch", "heads", None, None),
            "attn_k": (None, "batch", "kv_heads", "kv_seq", None),
            "attn_v": (None, "batch", "kv_heads", "kv_seq", None),
            "pos": (),
        }

    # ------------------------------------------------------------------ blocks
    def _shared_block(self, x, sp, *, positions, cache=None, inv: int = 0, pos=0,
                      chunked=False, kv_len=None):
        """The shared block's invocation ``inv``: attention writes its K/V
        in place into that invocation's slice of ``attn_k``/``attn_v``;
        without a cache (training) it is causal attention over x."""
        cfg = self.cfg
        h = layers.rmsnorm(x, sp["ln1"], cfg)
        kv = None if cache is None else (cache["attn_k"][inv], cache["attn_v"][inv])
        a = layers.attention(h, sp["attn"], cfg, positions=positions, cache=kv,
                             cache_index=pos, chunked=chunked, kv_len=kv_len)
        x = x + a
        return x + layers.mlp(layers.rmsnorm(x, sp["ln2"], cfg), sp["mlp"], cfg)

    def _run(self, params, x, cache, *, positions, pos, chunked):
        """The layer loop shared by prefill and decode: each Mamba-2 layer
        continues from (decode: steps) its cached conv/SSM state and
        writes the new state back in place. A one-token window (a decode
        step, or a one-token prefill piece) attends through the decode
        kernel, whose KV length is made once here for every invocation."""
        cfg, k = self.cfg, self.cfg.attn_every
        kv_len = (layers.decode_kv_len(pos, x.shape[0], x.device)
                  if x.shape[1] == 1 else None)
        for i in range(cfg.n_layers):
            conv, ssm = cache["conv"][i], cache["ssm"][i]
            if chunked:
                x, new_conv, new_ssm = mamba2_block(x, _layer(params["blocks"], i), cfg,
                                                    chunk_states=(conv, ssm))
            else:
                x, new_conv, new_ssm = mamba2_block(x, _layer(params["blocks"], i), cfg,
                                                    conv_state=conv, ssm_state=ssm)
            conv.copy_(new_conv)
            ssm.copy_(new_ssm)
            if i % k == k - 1:
                x = self._shared_block(x, params["shared"], positions=positions,
                                       cache=cache, inv=i // k, pos=pos,
                                       chunked=chunked, kv_len=kv_len)
        return layers.rmsnorm(x, params["ln_f"], cfg)

    # ------------------------------------------------------------------ training
    def forward(self, params, tokens, extra=None):
        """Training forward (no cache): tokens (B, T) -> logits (B, T, V)
        in the compute dtype. Each Mamba-2 layer scans from zero state and
        every ``attn_every``-th is followed by the shared block."""
        cfg, k = self.cfg, self.cfg.attn_every
        x = layers.embed(tokens, params["embed"], cfg)
        positions = torch.arange(tokens.shape[1], device=tokens.device)

        def body(x, bp, shared):
            x = mamba2_block(x, bp, cfg)[0]
            if shared:
                x = self._shared_block(x, params["shared"], positions=positions)
            return x

        for i in range(cfg.n_layers):
            x = _remat(cfg, body, x, _layer(params["blocks"], i), i % k == k - 1)
        x = layers.rmsnorm(x, params["ln_f"], cfg)
        return layers.unembed(x, params["lm_head"], cfg)

    def loss(self, params, batch):
        return _lm_loss(self, params, batch)

    # ------------------------------------------------------------------ serving
    def prefill(self, params, tokens, cache, extra=None):
        """Whole-prompt prefill into a fresh cache: every Mamba-2 layer
        scans the prompt from zero state and writes its final SSM state
        and its last K-1 conv inputs in place; the shared block writes
        its K/V at 0 (causal ``ops.flash_attention``). Returns the last
        position's logits (B, V) and the cache with ``pos`` = T."""
        cfg, k = self.cfg, self.cfg.attn_every
        T = tokens.shape[1]
        x = layers.embed(tokens, params["embed"], cfg)
        positions = torch.arange(T, device=tokens.device)
        for i in range(cfg.n_layers):
            conv = cache["conv"][i]
            x, new_conv, new_ssm = mamba2_block(x, _layer(params["blocks"], i), cfg,
                                                conv_state=conv)
            conv.copy_(new_conv)
            cache["ssm"][i].copy_(new_ssm)
            if i % k == k - 1:
                x = self._shared_block(x, params["shared"], positions=positions,
                                       cache=cache, inv=i // k, pos=0)
        x = layers.rmsnorm(x, params["ln_f"], cfg)
        logits = layers.unembed(x[:, -1:], params["lm_head"], cfg)[:, 0]
        return logits, {**cache, "pos": T}

    def prefill_chunk(self, params, tokens, cache):
        """Prefill continuation from ``cache["pos"]`` (an int): every Mamba
        layer's SSD scan resumes from its cached (conv, ssm) state and the
        shared block's K/V chunk is written at the position offset.
        Returns the last position's logits (B, V) and the cache with
        ``pos`` advanced."""
        B, T = tokens.shape
        pos = int(cache["pos"])
        x = layers.embed(tokens, params["embed"], self.cfg)
        positions = torch.arange(pos, pos + T, device=tokens.device)
        x = self._run(params, x, cache, positions=positions, pos=pos, chunked=True)
        logits = layers.unembed(x[:, -1:], params["lm_head"], self.cfg)[:, 0]
        return logits, {**cache, "pos": pos + T}

    def decode_step(self, params, token, cache):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int or
        a (B,) int32 tensor of per-slot positions. Returns logits (B, V)
        and the cache with ``pos`` advanced."""
        pos = cache["pos"]
        x = layers.embed(token, params["embed"], self.cfg)
        positions = (pos[:, None] if torch.is_tensor(pos)
                     else torch.tensor([pos], device=token.device))
        x = self._run(params, x, cache, positions=positions, pos=pos, chunked=False)
        logits = layers.unembed(x, params["lm_head"], self.cfg)[:, 0]
        return logits, {**cache, "pos": pos + 1}
