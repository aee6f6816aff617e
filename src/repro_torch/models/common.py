"""Shared model-config dataclass and the ParamDef mini-framework.

Parameters are plain nested dicts of tensors, with the JAX package's key
paths and layouts: matmul weights are ``(in, out)``, block weights are
stacked on a leading ``(L, ...)`` layer axis. Models declare a nested
dict of ``ParamDef`` (shape + logical axes + initializer) and
``init_params`` materializes it on a device.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; choose from {sorted(_DTYPES)}")
    return _DTYPES[name]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0        # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 512
    act: str = "silu"        # silu (swiglu) | gelu (geglu)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    gemma_style: bool = False   # (1+w) rmsnorm scale + sqrt(d) embed scaling
    max_seq_len: int = 4096

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    first_dense_layers: int = 0
    router_renorm: bool = True
    moe_dispatch: str = "gspmd"

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    mla_absorbed_decode: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM / hybrid (mamba2, zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0

    # --- xLSTM ---
    xlstm_slstm_every: int = 0
    xlstm_proj_factor: float = 2.0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # --- vision (llama-3.2-vision) ---
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    vision_dim: int = 0

    # --- numerics / execution ---
    # use_kernels, remat and scan_layers are the JAX package's execution
    # switches; the port keeps the fields so configs compare field for
    # field, and chooses kernels by device instead (kernels/ops.py).
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    use_kernels: bool = False
    remat: bool = True
    scan_layers: bool = True
    vocab_pad_to: int = 2048

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def n_param_estimate(self) -> int:
        """0, as the JAX package's placeholder returns: ``count_params`` of
        a model's ``param_defs()`` is the count."""
        return 0

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape, logical axes, initializer."""
    shape: tuple
    logical: tuple            # logical axis name (or None) per dim
    init: str = "normal"      # normal | zeros | ones | embed | scaled | ssm_a | ssm_dt
    scale: float = 1.0
    dtype: Any = None         # override param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def flatten(tree, prefix=()):
    """Nested dict -> [(key path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """The nested dict of ``like``'s structure whose leaves are ``leaves``,
    given in :func:`flatten`'s sorted key-path order."""
    out: dict = {}
    pairs = flatten(like)
    if len(pairs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(pairs)}")
    if not isinstance(like, dict):
        return leaves[0]
    for (path, _), leaf in zip(pairs, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``, which share its dict structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def model_device(device=None) -> torch.device:
    """``serving.engine.resolve_device``: ``None`` is the CUDA card, which
    must be present. Imported when called, as the engine imports the
    models."""
    from repro_torch.serving.engine import resolve_device
    return resolve_device(device)


def init_params(defs, seed: int, param_dtype=torch.float32, device=None):
    """Materialize a ParamDef tree. Each leaf is drawn on ``device`` (the
    CUDA card by default, which must be present; ``"cpu"`` for the CPU)
    directly in its dtype from a generator of its own (``seed`` plus the
    leaf's index in sorted key-path order), so a full-width model never
    exists as float32 anywhere."""
    device = model_device(device)
    out: dict = {}
    for i, (path, d) in enumerate(flatten(defs)):
        dt = torch_dtype(d.dtype or param_dtype)
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init in ("normal", "embed", "scaled"):
            if d.init == "scaled":  # 1/sqrt(fan_in)
                fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[0]
                std = d.scale / math.sqrt(max(fan, 1))
            else:
                std = 0.02 * d.scale
            g = torch.Generator(device=device).manual_seed(seed * 100_003 + i)
            t = torch.empty(d.shape, dtype=dt, device=device).normal_(
                0.0, std, generator=g)
        elif d.init in ("ssm_a", "ssm_dt"):
            # mamba A_log = log U(1, 16); dt bias = softplus^-1 of U(1e-3, 1e-1)
            lo, hi = (1.0, 16.0) if d.init == "ssm_a" else (1e-3, 1e-1)
            g = torch.Generator(device=device).manual_seed(seed * 100_003 + i)
            u = torch.empty(d.shape, dtype=torch.float32, device=device).uniform_(
                lo, hi, generator=g)
            t = (torch.log(u) if d.init == "ssm_a" else torch.log(torch.expm1(u))).to(dt)
        else:
            raise ValueError(f"unknown init {d.init}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def shape_tree(defs, param_dtype=torch.float32):
    """ParamDef tree -> tree of ``meta`` tensors of each leaf's shape and
    dtype: nothing is allocated (the counterpart of ``ShapeDtypeStruct``)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype or param_dtype),
                                          device="meta"), defs)


def spec_tree(defs):
    """ParamDef tree -> logical-axes tree (same structure, tuple leaves)."""
    return tree_map(lambda d: d.logical, defs)


def count_params(defs) -> int:
    return int(sum(math.prod(d.shape) for _, d in flatten(defs)))


def cast_tree(params, dtype):
    """The tree with each floating leaf cast to ``dtype``."""
    dt = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, params)


# ---------------------------------------------------------------------------
# cache-layout introspection (the cache_specs() contract)
# ---------------------------------------------------------------------------
# cache_specs() maps each cache key to a tuple of logical axis names.
# "batch" is the decode-slot axis, "kv_seq" a growing sequence axis.


@dataclass(frozen=True)
class LeafLayout:
    """Page-granular layout of one cache leaf, as the KV page pool sees
    it: ``paged`` leaves have a "kv_seq" axis and pool page by page;
    ``state`` leaves have a batch axis but no "kv_seq" axis; leaves with
    neither (the "pos" scalar) are not pooled."""
    batch_axis: int        # -1 when absent
    seq_axis: int          # -1 when absent

    @property
    def paged(self) -> bool:
        return self.seq_axis >= 0

    @property
    def state(self) -> bool:
        return self.batch_axis >= 0 and self.seq_axis < 0

    def pool_shape(self, leaf_shape, page: int, n_pages: int) -> tuple:
        """The pool buffer backing this leaf: the batch axis becomes the
        pool-page axis (``n_pages`` entries) and the "kv_seq" axis is
        clipped to one ``page`` -- k ``(L, B, Hkv, S, D)`` pools as
        ``(L, P, Hkv, page, D)``, so a layer slice of the pool has the
        rank and axis order of a layer slice of a contiguous cache."""
        if not (self.paged and self.batch_axis < self.seq_axis):
            raise ValueError(f"leaf {self} has no pageable layout")
        s = list(leaf_shape)
        s[self.batch_axis] = n_pages
        s[self.seq_axis] = page
        return tuple(s)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None))) for e in s)


def cache_axes(specs):
    """cache_specs() tree -> (batch_axes, seq_axes): same-structure trees of
    axis indices, -1 where the leaf lacks the axis (a -1 sentinel, as the
    JAX package's, whose leaves must survive pytree flattening)."""

    def axis(name):
        def one(spec):
            if not _is_spec(spec):
                return -1
            return spec.index(name) if name in spec else -1
        return one

    def walk(node, fn):
        if isinstance(node, dict):
            return {k: walk(v, fn) for k, v in node.items()}
        if not _is_spec(node) and isinstance(node, (tuple, list)):
            return type(node)(walk(v, fn) for v in node)
        return fn(node)

    return walk(specs, axis("batch")), walk(specs, axis("kv_seq"))


def cache_layout(specs: dict) -> dict:
    """cache_specs() -> {key: LeafLayout}, one entry per leaf. A top-level
    leaf keeps its name; a leaf of a nested spec tree (xLSTM's
    ``{"states": {"l0": (spec, ...)}, "pos": ()}``) is keyed by its path
    tuple, e.g. ``("states", "l0", 1)``. :func:`cache_leaf` reads either."""
    out = {}

    def walk(node, path):
        if _is_spec(node):
            out[path[0] if len(path) == 1 else path] = LeafLayout(
                node.index("batch") if "batch" in node else -1,
                node.index("kv_seq") if "kv_seq" in node else -1)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:                       # a tuple or list of specs
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(specs, ())
    return out


def cache_leaf(cache, key):
    """The leaf of ``cache`` at a :func:`cache_layout` key (a top-level
    name or a path tuple)."""
    if not isinstance(key, tuple):
        return cache[key]
    for k in key:
        cache = cache[k]
    return cache


def has_state_leaves(layout: dict) -> bool:
    """True when the model carries per-slot state outside the paged KV
    axis (recurrent states, cross K/V)."""
    return any(l.state for l in layout.values())
