"""The port's quantized HPC tier against the JAX package: int8/fp8 KV
pages and W4A16 (AWQ) weights, on shared numpy inputs and with the
reference's (quantized) weights carried over.

Tolerances: quantized KV codes and scales, and AWQ ``qw``/scales/zeros,
bit-identical (the same float32 operations, each correctly rounded,
round-half-even); attention and AWQ matmul outputs in float32 within
1e-5 absolute (the frameworks sum in different orders; outputs are
O(1), matmul outputs O(10) at K=256 and get 1e-5 relative too); model
logits within 1e-4; greedy streams token-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.awq_matmul import awq_matmul as pallas_awq  # noqa: E402
from repro.kernels.paged_attention import paged_attention as pallas_paged  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving import quantize as jquant  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import TRASH_PAGE, ContinuousBatcher, Request, ServingEngine  # noqa: E402
from repro_torch.serving import quantize as quant  # noqa: E402
from repro_torch.serving.pagepool import chunk_plan  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
DTYPES = {"int8": (torch.int8, jnp.int8), "fp8_e4m3": (torch.float8_e4m3fn,
                                                      jnp.float8_e4m3fn)}
PAGE, MAX_SEQ = 16, 64
PROMPTS = ["hello paged world", "a prompt that runs past one sixteen-token page, "
           "and then some more", "x", "hello paged world"]


def both(a):
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


def codes(t):
    """Port codes -> numpy bits (float8 viewed as uint8)."""
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def jcodes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def close(t, j, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------ KV quant
@pytest.mark.parametrize("kv", sorted(DTYPES))
def test_quantize_kv_bit_identical(kv):
    tdt, jdt = DTYPES[kv]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 3, 7, 32)) * rng.uniform(0.01, 50, size=(4, 3, 7, 1))
         ).astype(np.float32)
    x[1, 2, 3] = 0.0                               # all-zero vectors: scale 0
    x[0, 0, 0, 5] = 1e-30
    xt, xj = both(x)
    q, s = ref.quantize_kv(xt, tdt)
    jq, js = jref.quantize_kv(xj, jdt)
    assert q.dtype == tdt and s.dtype == torch.float32 and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(codes(q), jcodes(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 2, 3] == 0 and not codes(q)[1, 2, 3].any()
    np.testing.assert_array_equal(ref.dequantize_kv(q, s).numpy(),
                                  np.asarray(jref.dequantize_kv(jq, js)))
    assert ref.kv_qmax(tdt) == jref.kv_qmax(jdt) and ref.kv_qmax(torch.float32) is None


def _quant_pools(rng, kv, *, P=32, Hkv=2, page=16, D=32):
    tdt, jdt = DTYPES[kv]
    pools = []
    for _ in range(2):
        x = rng.normal(size=(P, Hkv, page, D)).astype(np.float32)
        q, s = jref.quantize_kv(jnp.asarray(x), jdt)
        pools.append((np.array(q), np.array(s)))
    return pools


def _port_pool(q, s, kv):
    tdt = DTYPES[kv][0]
    qt = (torch.from_numpy(q.view(np.uint8)).view(tdt) if tdt == torch.float8_e4m3fn
          else torch.from_numpy(q))
    return qt, torch.from_numpy(s.copy())


@pytest.mark.parametrize("kv", sorted(DTYPES))
def test_gather_dequant_kv_pages_equal(kv):
    rng = np.random.default_rng(1)
    (kq, ks), _ = _quant_pools(rng, kv)
    bt = rng.permutation(np.arange(1, 32))[:12].reshape(3, 4).astype(np.int32)
    qt, st = _port_pool(kq, ks, kv)
    got = ref.gather_dequant_kv_pages(qt, st, torch.from_numpy(bt))
    want = jref.gather_dequant_kv_pages(jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 64, 32)


QPAGED_CASES = {
    "ragged": dict(kv_len=[1, 37, 96]),
    "pos_offset": dict(kv_len=[36, 80, 96], pos_offset=[16, 32, 64]),
    "shared_pages": dict(kv_len=[40, 48, 9], share=True),
}


@pytest.mark.parametrize("kv", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(QPAGED_CASES))
def test_quant_paged_attention_plain_matches_reference_and_pallas(case, kv):
    """Scales of 1e6 (and saturated codes) in page 0 and in every page
    past a slot's live tail must not reach the output."""
    c = QPAGED_CASES[case]
    rng = np.random.default_rng(2)
    B, Hq, Hkv, D, page, n = 3, 8, 2, 32, 16, 6
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    (kq, ks), (vq, vs) = _quant_pools(rng, kv)
    bt = rng.permutation(np.arange(1, 32))[:B * n].reshape(B, n).astype(np.int32)
    if c.get("share"):
        bt[1, :2] = bt[0, :2]                       # slots 0 and 1 share a prefix
    kv_len = np.asarray(c["kv_len"], np.int32)
    poff = np.asarray(c.get("pos_offset", [0] * B), np.int32)
    live = -(-(kv_len - poff) // page)
    for b in range(B):
        bt[b, live[b]:] = 0                          # padding -> trash page
        tail = set(bt[b, live[b]:].tolist()) | {0}
        for pid in tail - {int(p) for r in range(B) for p in bt[r, :live[r]]}:
            ks[pid], vs[pid] = 1e6, 1e6
    kw = dict(block_tables=bt, kv_len=kv_len, pos_offset=poff)
    want_ref = jref.paged_attention(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                                    k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    want_pl = pallas_paged(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                           k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
                           interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    kt, kst = _port_pool(kq, ks, kv)
    vt, vst = _port_pool(vq, vs, kv)
    got = ops.paged_attention(torch.from_numpy(q), kt, vt, k_scales=kst, v_scales=vst,
                              **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (B, Hq, 1, D) and bool(got.isfinite().all())
    close(got, want_ref)
    close(got, want_pl)


# ------------------------------------------------------------------ AWQ
@pytest.mark.parametrize("shape", [(256, 96), (3, 128, 64)])
def test_quantize_weight_bit_identical(shape):
    rng = np.random.default_rng(3)
    w = (0.05 * rng.normal(size=shape)).astype(np.float32)
    w[..., :64, 0] = 0.0                           # a constant group: scale clamps to 1e-8
    for g in (64, 128):
        got = quant.quantize_weight(torch.from_numpy(w), group_size=g)
        want = jquant.quantize_weight(jnp.asarray(w), group_size=g)
        for k in ("qw", "scales", "zeros"):
            assert got[k].dtype == {"qw": torch.int32}.get(k, torch.float32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("M", [1, 5, 16])
def test_awq_matmul_plain_matches_reference_and_pallas(M, group):
    rng = np.random.default_rng(4)
    K, N = 256, 256
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = quant.quantize_weight(torch.from_numpy(
        (0.05 * rng.normal(size=(K, N))).astype(np.float32)), group_size=group)
    qw, s, z = (w[k].numpy() for k in ("qw", "scales", "zeros"))
    np.testing.assert_array_equal(ref.awq_unpack(w["qw"]).numpy(),
                                  np.asarray(jref.awq_unpack(jnp.asarray(qw))))
    np.testing.assert_array_equal(ref.awq_pack(ref.awq_unpack(w["qw"])).numpy(), qw)
    got = ops.awq_matmul(torch.from_numpy(x), w["qw"], w["scales"], w["zeros"],
                         group_size=group)
    args = [jnp.asarray(a) for a in (x, qw, s, z)]
    close(got, jref.awq_matmul(*args, group_size=group), rtol=1e-5)
    close(got, pallas_awq(*args, group_size=group, block_k=group, interpret=True),
          rtol=1e-5)
    assert got.shape == (M, N) and got.dtype == torch.float32


def test_quantize_mlp_tree_and_weight_bytes_match_reference():
    cfg = ref_smoke("minitron-8b").replace(**KW)
    jp = ref_build(cfg).init(jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    for g in (64, 128):
        jq = jquant.quantize_mlp_tree(jp, group_size=g)
        pq = quant.quantize_mlp_tree(pp, group_size=g)
        jpaths = {tuple(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(jq)[0]}
        assert {p for p, _ in flatten(pq)} == jpaths
        quantized = {p[:-1] for p, _ in flatten(pq) if p[-1] == "qw"}
        assert quantized == {p[:-1] for p in jpaths if p[-1] == "qw"}
        # smoke widths: d_model 64, d_ff 128, so group 128 fits w2 only
        assert {p[-1] for p in quantized} == ({"w1", "w2", "w3", "wo"} if g == 64
                                              else {"w2"})
        for path, t in flatten(pq):
            want = jq
            for k in path:
                want = want[k]
            np.testing.assert_array_equal(t.numpy(), np.asarray(want))
        assert quant.weight_bytes(pq) == jquant.weight_bytes(jq)
    assert quant.weight_bytes(pp) == jquant.weight_bytes(jp)


def test_quantize_mlp_tree_in_place_frees_each_dense_stack(monkeypatch):
    """build_system's mode: the same tree as the copying mode, and each
    dense stack is gone before the next one is quantized, so building a
    W4A16 tier never holds a dense tree and its quantized copy at once."""
    import weakref

    from repro_torch.models.common import tree_map
    dense = build_model(get_smoke_config("minitron-8b").replace(**KW)).init(0, "cpu")
    want = quant.quantize_mlp_tree(dense, group_size=64)
    params = tree_map(lambda t: t.clone(), dense)
    seen, real = [], quant.quantize_weight

    def spy(w, **kw):
        assert all(r() is None for r in seen), "a dense stack outlived its quantized copy"
        seen.append(weakref.ref(w))
        return real(w, **kw)

    monkeypatch.setattr(quant, "quantize_weight", spy)
    got = quant.quantize_mlp_tree(params, group_size=64, in_place=True)
    assert got is params and len(seen) == 4 and all(r() is None for r in seen)
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (_, a), (_, b) in zip(flatten(got), flatten(want)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ model
DENSE = ["minitron-8b", "gemma-7b", "granite-20b", "deepseek-67b"]   # family "dense"


@pytest.fixture(scope="module", params=DENSE)
def qmodels(request):
    jm = ref_build(ref_smoke(request.param).replace(**KW))
    jp = jquant.quantize_mlp_tree(jm.init(jax.random.PRNGKey(0)), group_size=64)
    pm = build_model(get_smoke_config(request.param).replace(**KW))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), dtype="float32")
    return jm, jp, pm, pp


@pytest.mark.parametrize("kv", sorted(DTYPES))
def test_quantized_model_logits_match_reference(qmodels, kv):
    """W4A16 params over an int8/fp8 pool: two slots prefill through
    their own block-table rows, then decode together. Logits within 1e-4;
    the pool's scales within 1e-6 (the K/V they quantize come out of two
    frameworks' matmuls, so codes can differ where a value sits on a
    rounding boundary)."""
    jm, jp, pm, pp = qmodels
    tdt, jdt = DTYPES[kv]
    cfg = pm.cfg
    # W4A16 where group 64 divides the contraction (gemma's smoke d_model
    # of 48 leaves w1 and w3 dense, deepseek's d_ff of 160 w2, as the
    # reference's quantizer does)
    codes = [p for p, _ in flatten(jax.tree.map(np.asarray, jp)) if p[-1] == "qw"]
    assert any(p[:2] == ("blocks", "mlp") for p in codes)
    assert all(t.dtype == torch.int32 for p, t in flatten(pp) if p in codes)
    prompts = [np.random.default_rng(s).integers(3, 259, size=n).tolist()
               for s, n in ((1, 21), (2, 7))]
    rows = np.zeros((2, MAX_SEQ // PAGE), np.int32)
    rows[0, :2], rows[1, :1] = [3, 5], [7]
    shape = (cfg.n_layers, 12, cfg.n_kv_heads, PAGE, cfg.head_dim)
    jc = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt),
          "k_qscale": jnp.zeros(shape[:-1]), "v_qscale": jnp.zeros(shape[:-1])}
    pc = {"k": torch.zeros(shape, dtype=tdt), "v": torch.zeros(shape, dtype=tdt),
          "k_qscale": torch.zeros(shape[:-1]), "v_qscale": torch.zeros(shape[:-1])}
    toks = []
    for b, ids in enumerate(prompts):
        jcache = {**jc, "pos": jnp.asarray(0, jnp.int32),
                  "pos_offset": jnp.zeros((), jnp.int32),
                  "block_tables": jnp.asarray(rows[b:b + 1])}
        pcache = {**pc, "pos": 0, "block_tables": torch.from_numpy(rows[b:b + 1])}
        off = 0
        for n in chunk_plan(0, len(ids), PAGE):
            jl, jcache = jm.prefill_chunk(jp, jnp.asarray([ids[off:off + n]]), jcache)
            with torch.inference_mode():
                pl, pcache = pm.prefill_chunk(pp, torch.tensor([ids[off:off + n]]), pcache)
            off += n
        close(pl, jl, 1e-4)
        jc = {k: jcache[k] for k in jc}
        toks.append(int(np.argmax(np.asarray(jl)[0])))
    for k in ("k_qscale", "v_qscale"):   # K/V come out of two frameworks' matmuls
        close(pc[k], jc[k], 1e-6)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    jcache = {**jc, "pos": jnp.asarray(pos), "pos_offset": jnp.zeros(2, jnp.int32),
              "block_tables": jnp.asarray(rows)}
    pcache = {**pc, "pos": torch.from_numpy(pos),
              "pos_offset": torch.zeros(2, dtype=torch.int32),
              "block_tables": torch.from_numpy(rows)}
    tok = np.asarray(toks)
    for _ in range(4):
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok[:, None]), jcache)
        with torch.inference_mode():
            pl, pcache = pm.decode_step(pp, torch.from_numpy(tok[:, None]).long(), pcache)
        close(pl, jl, 1e-4)
        tok = np.argmax(np.asarray(jl), axis=-1)
    assert pcache["k"].data_ptr() == pc["k"].data_ptr()


def test_quantized_pool_refuses_what_it_does_not_take(qmodels):
    _, _, pm, pp = qmodels
    cfg = pm.cfg
    shape = (cfg.n_layers, 4, cfg.n_kv_heads, PAGE, cfg.head_dim)
    base = {"pos": torch.tensor([3], dtype=torch.int32),
            "pos_offset": torch.zeros(1, dtype=torch.int32),
            "block_tables": torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)}
    narrow = {"k": torch.zeros(shape, dtype=torch.int8),
              "v": torch.zeros(shape, dtype=torch.int8)}
    with pytest.raises(TypeError, match="compute dtype"):   # int8 pages, no scales
        pm.decode_step(pp, torch.tensor([[5]]), {**base, **narrow})
    wide = {"k": torch.zeros(shape), "v": torch.zeros(shape),
            "k_qscale": torch.zeros(shape[:-1]), "v_qscale": torch.zeros(shape[:-1])}
    with pytest.raises(TypeError, match="quantized page pools only"):
        pm.decode_step(pp, torch.tensor([[5]]), {**base, **wide})


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module", params=sorted(DTYPES))
def qengines(request):
    kv = request.param
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96, kv_dtype=kv,
                    params=jquant.quantize_mlp_tree(
                        ref_build(ref_smoke("minitron-8b").replace(**KW)).init(
                            jax.random.PRNGKey(0)), group_size=64))
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         device="cpu", kv_dtype=kv,
                         params=params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    yield kv, ref, port
    ref.shutdown()
    port.shutdown()


def test_quantized_submit_streams_token_identical(qengines):
    """Greedy streams through submit -> broker -> paged batcher over a
    quantized pool with W4A16 weights, including a prefix-cache hit."""
    kv, ref, port = qengines
    outs = []
    for eng in (ref, port):
        res = [h.result(timeout=120) for h in
               [eng.submit(p, max_new_tokens=10) for p in PROMPTS[:3]]]
        res.append(eng.submit(PROMPTS[3], max_new_tokens=10).result(timeout=120))
        outs.append(res)
    for r, p in zip(*outs):
        assert p.tokens == r.tokens and len(p.tokens) == 10
        assert p.prefix_hit_tokens == r.prefix_hit_tokens
    assert outs[1][3].prefix_hit_tokens > 0
    b = port.scheduler.batcher
    assert b.pool.kv_dtype == kv and b.cache["k"].dtype == DTYPES[kv][0]
    assert b.bytes_copied_per_admission() == 0.0
    assert port.generate(PROMPTS[1], max_new_tokens=8).tokens == \
        ref.generate(PROMPTS[1], max_new_tokens=8).tokens


def test_quantized_pool_invariants(qengines):
    """Sidecars shaped like the pool minus its last axis, finite; the
    trash page never handed out; garbage codes and scales in page 0
    change no token; pool bytes equal the reference's, at (D + 4) / 4D
    of the float32 pool."""
    kv, ref, port = qengines

    def serve(garbage):
        cb = ContinuousBatcher(port, slots=3, max_seq=96, prefix_pages=32)
        if garbage:
            for key in ("k_qscale", "v_qscale"):
                cb.cache[key][:, TRASH_PAGE] = 1e6
        seen, out = set(), {}
        for i, p in enumerate(PROMPTS[:3]):
            cb.submit(Request(rid=str(i), prompt_ids=port.tokenizer.encode(p),
                              max_new_tokens=7,
                              on_done=lambda r: out.update({r.rid: r.output_ids})))
        while cb.step():
            for r in cb.active:
                if r is not None:
                    seen.update(r._pages)
        return cb, seen, out

    _, _, clean = serve(False)
    cb, seen, dirty = serve(True)
    assert dirty == clean and TRASH_PAGE not in seen
    assert cb.bytes_copied_per_admission() == 0.0
    for name in ("k", "v"):
        buf, sc = cb.cache[name], cb.cache[f"{name}_qscale"]
        assert sc.dtype == torch.float32 and sc.shape == buf.shape[:-1]
        assert bool(sc[:, 1:].isfinite().all()) and bool(sc[:, 1:].any())
    from repro.serving.scheduler import ContinuousBatcher as RefBatcher
    rcb = RefBatcher(ref, slots=3, max_seq=96, prefix_pages=32)
    assert cb.pool.pool_bytes == rcb.pool.pool_bytes
    fp32 = ContinuousBatcher(ServingEngine(port.cfg, params=port.params, max_seq=96,
                                           device="cpu"), slots=3, prefix_pages=32)
    D = port.cfg.head_dim
    assert cb.pool.pool_bytes * 4 * D == fp32.pool.pool_bytes * (D + 4)
