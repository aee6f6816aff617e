"""Step analyzer and roofline terms (the JAX package's
``launch/analysis.py``).

The JAX package re-derives trip-count-correct totals from a compiled HLO
module (``analyze_hlo``). Here a step is plain Python that PyTorch runs
op by op, so :func:`analyze_step` runs it under a dispatch mode and
counts what it does, loops included:

  * matmul FLOPs (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
    ``dot``: 2 * output elements * contraction), as the JAX package
    counts dots only -- a recomputed forward (``torch.utils.checkpoint``)
    and the backward are counted where the step runs them;
  * collectives by kind, from the ``_c10d_functional`` and ``_dtensor``
    ops that DTensor's redistribution and the MoE dispatch issue: output
    bytes per device, an all-reduce counted twice (reduce-scatter +
    all-gather).

On DTensors the mode lets DTensor run first and counts the local ops and
collectives it issues in an op's place, so the totals are per device, as
in the partitioned HLO. DTensor's shape propagation runs on FakeTensors:
ops on FakeTensors count only where the step itself was given some.

The Hopper kernels are ctypes calls that no dispatch mode sees. So a step
is analysed on ``meta`` tensors (or FakeTensors), where every kernel
wrapper takes its plain version: its matmuls stand in for the kernel's
work, and nothing is computed or allocated.

The memory (HBM traffic) term is computed analytically per cell --
params read once per step + KV-cache traffic + activation rw; formulas
in analytic_costs().
"""

from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

# (namespace, op) -> collective kind: the functional collectives, the
# autograd all-to-all (``funcol.all_to_all_single_autograd``; its own
# namespace in older torch releases), and DTensor's Shard-to-Shard
# redistribution on a "cuda" mesh, one all-to-all
_COLLECTIVES = {("_c10d_functional", "all_gather_into_tensor"): "all-gather",
                ("_c10d_functional", "all_reduce"): "all-reduce",
                ("_c10d_functional", "all_reduce_"): "all-reduce",
                ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
                ("_c10d_functional", "all_to_all_single"): "all-to-all",
                ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
                ("_dtensor", "shard_dim_alltoall"): "all-to-all"}


def _contraction(name, args) -> int:
    """The contraction length of a matmul op, or 0 for another op."""
    if name in ("mm", "bmm", "mv", "dot"):
        return args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return args[1].shape[-1]
    return 0


class _StepCounter(TorchDispatchMode):
    def __init__(self, count_fake: bool):
        super().__init__()
        self.count_fake = count_fake
        self.flops = 0
        self.coll_bytes = {k: 0 for k in COLL_KINDS}
        self.coll_counts = {k: 0 for k in COLL_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor first; its local ops come back here
        out = func(*args, **(kwargs or {}))
        if not self.count_fake and any(issubclass(t, FakeTensor) for t in types):
            return out                     # DTensor's shape propagation
        ns, name = func.namespace, func.__name__.split(".")[0]
        if ns == "aten":
            k = _contraction(name, args)
            if k:
                self.flops += 2 * out.numel() * k
        elif (ns, name) in _COLLECTIVES:
            kind = _COLLECTIVES[ns, name]
            self.coll_bytes[kind] += out.numel() * out.element_size() * (
                2 if kind == "all-reduce" else 1)
            self.coll_counts[kind] += 1
        return out


def analyze_step(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once and return its per-device matmul FLOPs
    and collective bytes and counts by kind (the keys of the JAX package's
    ``analyze_hlo``). Pass meta tensors (or FakeTensors) to analyse a
    step that runs Hopper kernels: their plain versions stand in."""
    fake = any(isinstance(t, FakeTensor) for t in tree_leaves((args, kw)))
    with _StepCounter(count_fake=fake) as c:
        fn(*args, **kw)
    return {
        "flops": float(c.flops),
        "collective_bytes": dict(c.coll_bytes),
        "collective_bytes_total": int(sum(c.coll_bytes.values())),
        "collective_op_counts": dict(c.coll_counts),
    }


# ---------------------------------------------------------------------------
# analytic model costs (MODEL_FLOPS + HBM-traffic term)
# ---------------------------------------------------------------------------


def analytic_costs(cfg, cell) -> dict:
    """Closed-form per-step totals (GLOBAL, all devices):

      * model_flops — 6*N*D for train (dense N; MoE uses active params),
        2*N_active per generated/prefilled token for inference, plus the
        attention term 2*S*kv per token where applicable;
      * hbm_bytes — params read once + KV cache traffic + activation rw
        estimate (the classic inference/training byte model).
    """
    B, S = cell.global_batch, cell.seq_len
    d, L = cfg.d_model, cfg.n_layers
    V = cfg.padded_vocab

    # ---- parameter counts ----
    if cfg.use_mla:
        attn_p = d * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        attn_p += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        attn_p += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        attn_p += cfg.n_heads * cfg.v_head_dim * d
    else:
        attn_p = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    if cfg.n_experts:
        expert_p = 3 * d * (cfg.moe_d_ff or cfg.d_ff)
        mlp_total = cfg.n_experts * expert_p + cfg.n_shared_experts * expert_p
        mlp_active = (cfg.top_k + cfg.n_shared_experts) * expert_p
    elif cfg.family == "ssm":
        u = int(cfg.xlstm_proj_factor * d)
        mlp_total = mlp_active = 2 * d * u + 3 * u * u + u * d   # mLSTM approx
    elif cfg.family == "hybrid":
        di = cfg.d_inner
        mlp_total = mlp_active = d * (2 * di + 2 * cfg.ssm_state + cfg.n_ssm_heads) + di * d
    else:
        mlp_total = mlp_active = 3 * d * cfg.d_ff

    if cfg.family == "hybrid":
        n_attn_blocks = cfg.n_layers // cfg.attn_every
        shared = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d + 3 * d * cfg.d_ff
        layer_total = mlp_total            # per mamba layer
        body_total = L * layer_total + shared
        body_active = body_total           # all active; shared reused n_attn_blocks times
        flops_layers = L * mlp_total + n_attn_blocks * shared  # weight reuse counts each use
    elif cfg.family == "ssm":
        body_total = body_active = L * mlp_total
        flops_layers = L * mlp_total
    else:
        enc = 0
        if cfg.is_encoder_decoder:
            enc = cfg.n_encoder_layers * (attn_p + mlp_total) + cfg.n_encoder_layers * attn_p
        body_total = L * (attn_p + mlp_total) + enc
        body_active = L * (attn_p + mlp_active) + enc
        flops_layers = body_active

    embed_p = V * d * (1 if cfg.tie_embeddings else 2)
    n_total = body_total + embed_p
    n_active = body_active + V * d     # unembed always active

    # ---- flops ----
    n_attn_layers = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                     else (cfg.n_layers + cfg.n_encoder_layers if cfg.is_encoder_decoder
                           else cfg.n_layers))
    if cell.kind == "train":
        tokens = B * S
        model_flops = 6.0 * (flops_layers + V * d) * tokens
        if not cfg.use_mla and cfg.family != "ssm":
            # causal attention: QK^T + AV = 2 matmuls * 2 flops * q_dim * S/2
            # per token per attention layer; x3 for fwd+bwd
            model_flops += 3.0 * 2.0 * 2.0 * cfg.q_dim * (S / 2) * tokens * n_attn_layers
    elif cell.kind == "prefill":
        tokens = B * S
        model_flops = 2.0 * (flops_layers + V * d) * tokens
        if not cfg.use_mla and cfg.family != "ssm":
            model_flops += 2.0 * 2.0 * cfg.q_dim * (S / 2) * tokens * n_attn_layers
    else:  # decode: one token per sequence
        tokens = B
        model_flops = 2.0 * (flops_layers + V * d) * tokens
        if cfg.family not in ("ssm", "hybrid"):
            kv_read = S * (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.use_mla
                           else 2 * cfg.kv_dim)
            model_flops += 2.0 * cfg.q_dim * S * 2 * tokens * (L if not cfg.is_encoder_decoder else L)

    # ---- hbm bytes (per step, global) ----
    pb = 2  # bf16 serving; fp32 training handled below
    if cell.kind == "train":
        # fp32 params + grads + 2 moments touched once each + bf16 activations
        param_traffic = n_total * (4 + 4 + 8 + 8)
        act = tokens * d * L * 2 * 6      # rough rw of activations w/ remat
        hbm = param_traffic + act
    elif cell.kind == "prefill":
        kv_write = (B * S * L * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * pb
                    if cfg.use_mla else B * S * L * 2 * cfg.kv_dim * pb)
        hbm = n_total * pb + tokens * d * L * 2 * 4 + kv_write
    else:
        if cfg.family == "ssm":
            state = B * L * (cfg.n_heads * (d // max(cfg.n_heads, 1)) ** 2) * 4
            kv_traffic = 2 * state
        elif cfg.family == "hybrid":
            ssm_state = B * L * cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            n_inv = L // cfg.attn_every
            attn_kv = B * S * n_inv * 2 * cfg.kv_dim * pb
            kv_traffic = 2 * ssm_state + attn_kv
        elif cfg.use_mla:
            kv_traffic = B * S * L * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * pb
        else:
            kv_traffic = B * S * L * 2 * cfg.kv_dim * pb
            if cfg.is_encoder_decoder:
                kv_traffic += B * cfg.encoder_seq_len * L * 2 * cfg.kv_dim * pb
        hbm = n_total * pb + kv_traffic + tokens * d * L * 2 * 4

    return {
        "n_params_total": float(n_total),
        "n_params_active": float(n_active),
        "model_flops_global": float(model_flops),
        "hbm_bytes_global": float(hbm),
        "tokens_per_step": float(tokens),
    }


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), data sheet, dense rates
PEAK_FLOPS = 989e12       # bf16 FLOP/s per GPU (H100 SXM5)
HBM_BW = 3.35e12          # bytes/s per GPU (H100 SXM5 HBM3)
LINK_BW = 450e9           # bytes/s per direction per GPU (H100 SXM5, NVLink 4)


def roofline_terms(rec: dict, n_devices: int) -> dict:
    """Per-device seconds for each roofline term + the bottleneck."""
    flops_dev = rec["hlo_flops_per_device"]
    hbm_dev = rec["hbm_bytes_global"] / n_devices
    coll_dev = rec["collective_bytes_total_per_device"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = hbm_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {**terms, "bottleneck": bottleneck, "step_time_bound_s": step_s,
            "model_flops_ratio": (rec["model_flops_global"] / n_devices) / max(flops_dev, 1.0),
            "mfu_bound": (rec["model_flops_global"] / n_devices / PEAK_FLOPS) / max(step_s, 1e-12)}
