"""Plain float32 reference of the MoE family the port serves
(deepseek-v2-lite-16b: MLA and shared experts after one dense layer;
grok-1-314b: GQA): the port's model equations, written again in plain
PyTorch from the configuration's numbers. It imports nothing of the
program and takes no tensor the program made: weights come from
:class:`stream_bench.weights.Weights`, made anew here block by block.

The equations (pre-norm blocks, rotate-half rope from position 0, MLA
with the latent's own RMS norm and a shared rope key, top-k softmax
routing in float32 with shared experts added) are the port's. Every
routed unit is kept, as in the published models: the harness serves the
port with an expert capacity at which none is dropped.

``control=True`` runs a second track beside the float32 one: every
product's operands rounded to fp8 e4m3 (one scale per row of the
activation and per output column of the weight; q, k, v per row), the
router and softmax kept in float32 as in the program. It is the lower
precision that the harness's control puts in the program's place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def padded_vocab(m: dict) -> int:
    p = int(m.get("vocab_pad_to", 2048))
    return -(-int(m["vocab_size"]) // p) * p


def layout(m: dict) -> dict:
    """name -> (shape, mean, std) of every parameter, in the port's
    names: ``embed.w``, ``lm_head.w``, ``ln_f.w``, ``dense{i}.*``
    (unstacked leading dense blocks) and ``blocks.*`` (stacked over the
    MoE layers; experts ``(L, E, ...)``)."""
    D, V, L = m["d_model"], padded_vocab(m), m["n_layers"]
    nd = m.get("first_dense_layers", 0)
    n_moe = L - nd
    out_scale = 1.0 / math.sqrt(2 * L)
    defs = {"embed.w": ((V, D), "embed"), "ln_f.w": ((D,), "norm"),
            "lm_head.w": ((V, D), "head")}

    def attn(prefix, lead):
        H = m["n_heads"]
        if m.get("use_mla"):
            r, dn, dr, dv = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                             m["qk_rope_head_dim"], m["v_head_dim"])
            shapes = {"wq": (D, H * (dn + dr)), "wdkv": (D, r), "wkr": (D, dr),
                      "kv_norm": (r,), "wuk": (r, H * dn), "wuv": (r, H * dv),
                      "wo": (H * dv, D)}
        else:
            hd, Hkv = m["head_dim"], m["n_kv_heads"]
            shapes = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
                      "wo": (H * hd, D)}
        for k, s in shapes.items():
            defs[f"{prefix}.attn.{k}"] = (lead + s, "norm" if k == "kv_norm" else k)

    def mlp(prefix, lead, f):
        defs[f"{prefix}.w1"] = (lead + (D, f), "w1")
        defs[f"{prefix}.w3"] = (lead + (D, f), "w3")
        defs[f"{prefix}.w2"] = (lead + (f, D), "w2")

    for i in range(nd):
        defs[f"dense{i}.ln1.w"] = ((D,), "norm")
        defs[f"dense{i}.ln2.w"] = ((D,), "norm")
        attn(f"dense{i}", ())
        mlp(f"dense{i}.mlp", (), m["d_ff"])
    lead = (n_moe,)
    defs["blocks.ln1.w"] = (lead + (D,), "norm")
    defs["blocks.ln2.w"] = (lead + (D,), "norm")
    attn("blocks", lead)
    E, f = m["n_experts"], m.get("moe_d_ff") or m["d_ff"]
    defs["blocks.mlp.router"] = (lead + (D, E), "router")
    mlp("blocks.mlp", lead + (E,), f)
    if m.get("n_shared_experts"):
        mlp("blocks.mlp.shared", lead, f * m["n_shared_experts"])

    out = {}
    for name, (shape, kind) in defs.items():
        if kind == "norm":
            mean, std = 1.0, 0.1
        elif kind == "embed":
            mean, std = 0.0, 1.0
        elif kind == "head":
            mean, std = 0.0, 1.0 / math.sqrt(shape[-1])
        else:   # an (in, out) projection
            mean, std = 0.0, 1.0 / math.sqrt(shape[-2])
            if kind in ("wo", "w2"):
                std *= out_scale
        out[name] = (tuple(shape), mean, std)
    return out


# ---------------------------------------------------------------- pieces
def q8(t, dim):
    """fp8 e4m3 round trip, one scale per slice along ``dim``."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (..., S, d), positions 0..S-1, rotate-half."""
    S, d = x.shape[-2], x.shape[-1]
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Track:
    """One precision's arithmetic: float32, or fp8 operands."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, w):            # a weight (in, out), once per fetch
        return q8(w, 0) if self.fp8 else w

    def a(self, x):            # an activation, per row
        return q8(x, -1) if self.fp8 else x

    def lin(self, x, w):       # w already passed through self.w
        return self.a(x) @ w


def _causal_attend(q, k, v, scale):
    """q (H, S, d), k (H, S, d), v (H, S, dv) -> (S, H * dv)."""
    S = q.shape[1]
    s = (q @ k.transpose(1, 2)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(torch.where(mask, s, float("-inf")), dim=-1)
    return (p @ v).transpose(0, 1).reshape(S, -1)


def _attention(tr, m, W, prefix, idx, h, spans):
    """Self-attention of each sequence (rows ``spans``) of h (T, D)."""
    H = m["n_heads"]
    g = lambda k: W.get(f"{prefix}.attn.{k}", idx)
    out = torch.empty(h.shape[0], W.layout[f"{prefix}.attn.wo"][0][-2],
                      device=h.device)
    theta = float(m.get("rope_theta", 10000.0))
    if m.get("use_mla"):
        dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
        wq, wdkv, wkr = tr.w(g("wq")), tr.w(g("wdkv")), tr.w(g("wkr"))
        wuk, wuv, kvn = tr.w(g("wuk")), tr.w(g("wuv")), g("kv_norm")
        for a, b in spans:
            x = h[a:b]
            S = b - a
            q = tr.lin(x, wq).reshape(S, H, dn + dr).transpose(0, 1)
            q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
            ckv = rmsnorm(tr.lin(x, wdkv), kvn, m["norm_eps"])
            kr = rope(tr.lin(x, wkr), theta)
            kn = tr.lin(ckv, wuk).reshape(S, H, dn).transpose(0, 1)
            v = tr.lin(ckv, wuv).reshape(S, H, dv).transpose(0, 1)
            k = torch.cat([kn, kr[None].expand(H, S, dr)], dim=-1)
            out[a:b] = _causal_attend(tr.a(q), tr.a(k), tr.a(v), 1.0 / math.sqrt(dn + dr))
    else:
        hd, Hkv = m["head_dim"], m["n_kv_heads"]
        wq, wk, wv = tr.w(g("wq")), tr.w(g("wk")), tr.w(g("wv"))
        for a, b in spans:
            x = h[a:b]
            S = b - a
            q = rope(tr.lin(x, wq).reshape(S, H, hd).transpose(0, 1), theta)
            k = rope(tr.lin(x, wk).reshape(S, Hkv, hd).transpose(0, 1), theta)
            v = tr.lin(x, wv).reshape(S, Hkv, hd).transpose(0, 1)
            k = k.repeat_interleave(H // Hkv, dim=0)     # query head j reads kv head j // G
            v = v.repeat_interleave(H // Hkv, dim=0)
            out[a:b] = _causal_attend(tr.a(q), tr.a(k), tr.a(v), 1.0 / math.sqrt(hd))
    return tr.lin(out, tr.w(g("wo")))


def _mlp(tr, w1, w3, w2, x):
    return tr.lin(F.silu(tr.lin(x, w1)) * tr.lin(x, w3), w2)


def _moe(tracks, m, W, i, hs):
    """The routed experts (no capacity) plus the shared ones, for each
    track's normed hidden state in ``hs``."""
    E, K = m["n_experts"], m["top_k"]
    router = W.get("blocks.mlp.router", (i,))
    routes = []
    for h in hs:
        probs = torch.softmax(h @ router, dim=-1)
        gates, idx = torch.topk(probs, K, dim=-1)
        if m.get("router_renorm", True):
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        routes.append((gates, idx))
    ys = [torch.zeros_like(h) for h in hs]
    for e in range(E):
        fetched = None
        for tr, h, y, (gates, idx) in zip(tracks, hs, ys, routes):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            if fetched is None:
                fetched = [W.get(f"blocks.mlp.{k}", (i, e)) for k in ("w1", "w3", "w2")]
            ye = _mlp(tr, *(tr.w(t) for t in fetched), h[rows])
            y.index_add_(0, rows, ye * gates[rows, slot][:, None])
        del fetched
    if m.get("n_shared_experts"):
        sw = [W.get(f"blocks.mlp.shared.{k}", (i,)) for k in ("w1", "w3", "w2")]
        for tr, h, y in zip(tracks, hs, ys):
            y += _mlp(tr, *(tr.w(t) for t in sw), h)
    return ys


@torch.no_grad()
def judge(m: dict, W, seqs: list, served: list, *, control: bool = False):
    """Score served tokens against the float32 reference.

    ``seqs[j]`` is request j's prompt ids followed by every served token
    but the last; ``served[j]`` its served token ids (the reference reads
    them only to judge them). Returns, per request, the gap of each
    served token: the reference's best logit at that position less the
    served token's logit; with ``control``, also the gap of the token the
    fp8 track puts first at each position."""
    dev = W.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracks = [_Track(False)] + ([_Track(True)] if control else [])
    eps = m["norm_eps"]
    spans, rows, a = [], [], 0
    for s, t in zip(seqs, served):
        b = a + len(s)
        spans.append((a, b))
        n_prompt = len(s) - (len(t) - 1)
        rows.append(torch.arange(a + n_prompt - 1, b, device=dev))
        a = b
    toks = torch.tensor([x for s in seqs for x in s], dtype=torch.long, device=dev)
    emb = W.get("embed.w")
    xs = [tr.a(emb[toks]) for tr in tracks]
    del emb
    nd = m.get("first_dense_layers", 0)
    layers = [(f"dense{i}", (), None) for i in range(nd)]
    layers += [("blocks", (i,), i) for i in range(m["n_layers"] - nd)]
    for prefix, idx, moe_i in layers:
        ln1, ln2 = W.get(f"{prefix}.ln1.w", idx), W.get(f"{prefix}.ln2.w", idx)
        xs = [x + _attention(tr, m, W, prefix, idx, rmsnorm(x, ln1, eps), spans)
              for tr, x in zip(tracks, xs)]
        hs = [rmsnorm(x, ln2, eps) for x in xs]
        if moe_i is None:
            w = [W.get(f"{prefix}.mlp.{k}") for k in ("w1", "w3", "w2")]
            ys = [_mlp(tr, *(tr.w(t) for t in w), h) for tr, h in zip(tracks, hs)]
        else:
            ys = _moe(tracks, m, W, moe_i, hs)
        xs = [x + y for x, y in zip(xs, ys)]
    lnf, head = W.get("ln_f.w"), W.get("lm_head.w")
    want = torch.cat(rows)
    logits = []
    for tr, x in zip(tracks, xs):
        hw = head if not tr.fp8 else q8(head, -1)
        logits.append(tr.a(rmsnorm(x[want], lnf, eps)) @ hw.t())
    del head
    V = int(m["vocab_size"])
    ref = logits[0][:, :V]
    best = ref.max(dim=-1).values
    tok = torch.tensor([x for t in served for x in t], dtype=torch.long, device=dev)
    gaps = best - ref.gather(1, tok[:, None])[:, 0]
    out = {"gap": gaps}
    if control:
        pick = logits[1][:, :V].argmax(dim=-1)
        out["control_gap"] = best - ref.gather(1, pick[:, None])[:, 0]
    sizes = [len(t) for t in served]
    return {k: list(torch.split(v.cpu(), sizes)) for k, v in out.items()}
