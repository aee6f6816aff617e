"""Whisper-style encoder-decoder (the JAX package's ``models/encdec.py``),
for serving.

The audio frontend (mel + strided conv stem) is a stub, as in the JAX
package: ``extra={"frames": (B, encoder_seq_len, d_model)}`` carries
precomputed frame embeddings. Downstream of it everything is real: a
bidirectional encoder, a causal decoder with cross-attention in every
layer, tied unembedding, sinusoidal positions and pre-LN LayerNorm.

The JAX package scans the stacked ``(L, ...)`` block params; here a
Python loop walks them, and each decoder layer's self-attention cache is
a view of the ``(L, ...)`` cache leaves ``k``/``v``, written in place.
The cross K/V of every decoder layer are computed once from the encoder
output and kept in the cache leaves ``cross_k``/``cross_v`` (L, B, Hkv,
encoder_seq_len, D), state leaves the page pool snapshots. ``prefill``
needs the frames; ``prefill_chunk`` runs the encoder only when a chunk
brings them, and later chunks and ``decode_step`` attend the cross
leaves as they find them (zeros in a fresh cache: the serving engine
passes no extras, as in the JAX package).

Attention goes through ``ops.flash_attention`` (the encoder and every
cross-attention, non-causal; the whole-prompt prefill, causal) and
``ops.decode_attention`` (the decoder's self-attention, one token a
slot). Training (``loss``) is not ported: the flash backward is not
built for whisper's D = 64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, ParamDef, init_params
from repro_torch.models.lm import _layer, _stack


def layernorm_def(d):
    return {"w": ParamDef((d,), ("embed",), init="ones"),
            "b": ParamDef((d,), ("embed",), init="zeros")}


def layernorm(x, p, eps=1e-5):
    """LayerNorm in float32, returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def plain_mlp_def(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamDef((d, f), ("embed", "ffn"), init="scaled"),
        "b1": ParamDef((f,), ("ffn",), init="zeros"),
        "w2": ParamDef((f, d), ("ffn", "embed"), init="scaled",
                       scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
        "b2": ParamDef((d,), ("embed",), init="zeros"),
    }


def plain_mlp(x, p):
    """Ungated MLP with tanh-approximated GELU."""
    h = F.gelu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


def sinusoid(positions, d_model):
    """positions (S,) -> (S, d_model) float32: sines, then cosines."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM:
    """The serving protocol of TransformerLM: ``prefill`` /
    ``prefill_chunk`` / ``decode_step``, plus ``forward`` and ``encode``.
    ``extra`` carries {"frames": (B, Senc, d_model)}."""

    def __init__(self, cfg: ModelConfig):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self._acfg = cfg.replace(use_rope=False)    # no rope anywhere: sinusoids

    # ---------------------------------------------------------------- params
    def _enc_block_def(self):
        cfg = self.cfg
        return {"ln1": layernorm_def(cfg.d_model),
                "attn": layers.attention_def(cfg),
                "ln2": layernorm_def(cfg.d_model),
                "mlp": plain_mlp_def(cfg)}

    def _dec_block_def(self):
        cfg = self.cfg
        return {"ln1": layernorm_def(cfg.d_model),
                "self_attn": layers.attention_def(cfg),
                "ln_x": layernorm_def(cfg.d_model),
                "cross_attn": layers.attention_def(cfg),
                "ln2": layernorm_def(cfg.d_model),
                "mlp": plain_mlp_def(cfg)}

    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": layers.embedding_def(cfg),
            "enc_blocks": _stack(self._enc_block_def(), cfg.n_encoder_layers),
            "enc_ln": layernorm_def(cfg.d_model),
            "dec_blocks": _stack(self._dec_block_def(), cfg.n_layers),
            "dec_ln": layernorm_def(cfg.d_model),
        }

    def init(self, seed: int = 0, device="cpu"):
        return init_params(self.param_defs(), seed, self.cfg.pdtype(), device)

    # ---------------------------------------------------------------- encoder
    def encode(self, params, frames):
        """frames (B, Senc, d_model) -> encoder output, same shape, in the
        compute dtype: bidirectional self-attention (non-causal flash)."""
        cfg, dt = self.cfg, self.cfg.cdtype()
        S, D = frames.shape[1], frames.shape[2]
        positions = torch.arange(S, device=frames.device)
        x = frames.to(dt) + sinusoid(positions, D).to(dt)
        for i in range(cfg.n_encoder_layers):
            bp = _layer(params["enc_blocks"], i)
            h = layernorm(x, bp["ln1"])
            x = x + layers.attention(h, bp["attn"], self._acfg, positions=positions,
                                     context=h)
            x = x + plain_mlp(layernorm(x, bp["ln2"]), bp["mlp"])
        return layernorm(x, params["enc_ln"])

    @staticmethod
    def _frames(extra):
        frames = (extra or {}).get("frames")
        if frames is None:
            raise ValueError("the encoder needs extra={'frames': (B, encoder_seq_len, "
                             "d_model)}")
        return frames

    # ---------------------------------------------------------------- decoder
    def _dec_block(self, x, bp, *, positions, cache=None, cache_index=None,
                   enc_out=None, cross_kv=None, chunked=False, kv_len=None):
        h = layernorm(x, bp["ln1"])
        x = x + layers.attention(h, bp["self_attn"], self._acfg, positions=positions,
                                 cache=cache, cache_index=cache_index, chunked=chunked,
                                 kv_len=kv_len)
        h = layernorm(x, bp["ln_x"])
        if cross_kv is not None:
            a = layers.cross_attention(h, bp["cross_attn"], self._acfg, *cross_kv)
        else:
            a = layers.attention(h, bp["cross_attn"], self._acfg, positions=positions,
                                 context=enc_out)
        x = x + a
        return x + plain_mlp(layernorm(x, bp["ln2"]), bp["mlp"])

    def _embed_dec(self, tokens, params, positions):
        x = layers.embed(tokens, params["embed"], self.cfg)
        return x + sinusoid(positions, self.cfg.d_model).to(x.dtype)[None]

    def _head(self, params, x):
        return layers.unembed(layernorm(x, params["dec_ln"]), params["embed"], self.cfg)

    def forward(self, params, tokens, extra=None):
        """Teacher-forced forward: tokens (B, T), extra["frames"] -> logits
        (B, T, V) in the compute dtype."""
        enc_out = self.encode(params, self._frames(extra))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed_dec(tokens, params, positions)
        for i in range(self.cfg.n_layers):
            x = self._dec_block(x, _layer(params["dec_blocks"], i), positions=positions,
                                enc_out=enc_out)
        return self._head(params, x)

    def loss(self, params, batch):
        raise NotImplementedError(
            "training of the encoder-decoder family is not ported yet: the flash "
            "backward kernel is not built for its D = 64")

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch, max_seq, device="cpu"):
        cfg, dt = self.cfg, self.cfg.cdtype()
        self_kv = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.encoder_seq_len, cfg.head_dim)
        return {"pos": 0,
                **{n: torch.zeros(s, dtype=dt, device=device)
                   for n, s in (("k", self_kv), ("v", self_kv),
                                ("cross_k", cross), ("cross_v", cross))}}

    def cache_specs(self):
        return {
            "k": ("layers", "batch", "kv_heads", "kv_seq", None),
            "v": ("layers", "batch", "kv_heads", "kv_seq", None),
            "cross_k": ("layers", "batch", "kv_heads", None, None),
            "cross_v": ("layers", "batch", "kv_heads", None, None),
            "pos": (),
        }

    def _cross_kv_all(self, params, enc_out):
        """(k, v) of every decoder layer's cross-attention over ``enc_out``:
        (L, B, Hkv, Senc, D) each."""
        ca = params["dec_blocks"]["cross_attn"]
        ks, vs = zip(*(layers.cross_kv(enc_out, _layer(ca, i), self.cfg)
                       for i in range(self.cfg.n_layers)))
        return torch.stack(ks), torch.stack(vs)

    def _take_frames(self, params, cache, frames):
        k, v = self._cross_kv_all(params, self.encode(params, frames))
        cache["cross_k"].copy_(k)
        cache["cross_v"].copy_(v)

    def _run_cached(self, params, x, positions, cache, cache_index, chunked=False):
        # one token a slot (decode, or a one-token chunk): the decode
        # kernel's KV length, made once for every layer
        kv_len = (layers.decode_kv_len(cache_index, x.shape[0], x.device)
                  if x.shape[1] == 1 else None)
        for i in range(self.cfg.n_layers):
            x = self._dec_block(x, _layer(params["dec_blocks"], i), positions=positions,
                                cache=(cache["k"][i], cache["v"][i]),
                                cache_index=cache_index, chunked=chunked, kv_len=kv_len,
                                cross_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        return x

    def prefill(self, params, tokens, cache, extra=None):
        """Whole-prompt prefill into a fresh contiguous cache: runs the
        encoder over extra["frames"], fills the cross leaves and writes
        the prompt's K/V at 0 (causal flash). Returns the last position's
        logits (B, V) and the cache with ``pos`` = T."""
        self._take_frames(params, cache, self._frames(extra))
        T = tokens.shape[1]
        positions = torch.arange(T, device=tokens.device)
        x = self._embed_dec(tokens, params, positions)
        x = self._run_cached(params, x, positions, cache, cache_index=0)
        return self._head(params, x[:, -1:])[:, 0], {**cache, "pos": T}

    def prefill_chunk(self, params, tokens, cache, extra=None):
        """Prefill continuation from ``cache["pos"]`` (an int). The encoder
        runs only when the chunk brings extra["frames"] (the first chunk of
        a prompt); later chunks reuse the cached cross K/V."""
        frames = (extra or {}).get("frames")
        if frames is not None:
            self._take_frames(params, cache, frames)
        start = int(cache["pos"])
        T = tokens.shape[1]
        positions = torch.arange(start, start + T, device=tokens.device)
        x = self._embed_dec(tokens, params, positions)
        x = self._run_cached(params, x, positions, cache, cache_index=start, chunked=True)
        return self._head(params, x[:, -1:])[:, 0], {**cache, "pos": start + T}

    def decode_step(self, params, token, cache, extra=None):
        """One token per slot: ``token`` (B, 1); ``cache["pos"]`` an int or
        a (B,) int32 tensor of per-slot positions (the splice path).
        Returns logits (B, V) and the cache with ``pos`` advanced."""
        pos = cache["pos"]
        x = layers.embed(token, params["embed"], self.cfg)
        if torch.is_tensor(pos):
            x = x + sinusoid(pos, self.cfg.d_model).to(x.dtype)[:, None]
            positions = pos[:, None]
        else:
            positions = torch.tensor([pos], device=token.device)
            x = x + sinusoid(positions, self.cfg.d_model).to(x.dtype)[None]
        x = self._run_cached(params, x, positions, cache, cache_index=pos)
        return self._head(params, x)[:, 0], {**cache, "pos": pos + 1}
