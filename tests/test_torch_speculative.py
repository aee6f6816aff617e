"""Port's speculative decoding (n-gram and model drafting, the
propose_k/verify_chunk contract, ``speculative_accept``) against its own
plain decode and against the JAX package.

Speculation must never change WHAT is emitted, only how fast: every
serving case asserts literal token equality with plain decode -- greedy
and seeded, paged and contiguous, over float32 pages and over int8 pages
with W4A16 weights, for every drafter, with acceptance forced to 100%,
0% and a mid-window rejection through the batcher's ``draft_hook``. The
cases of the JAX package's ``tests/test_speculative.py`` and
``tests/test_speculative_props.py`` run here for the families the port
has (dense minitron-8b and gemma-7b; the MLA member, deepseek-v2-lite,
is in ``tests/test_torch_moe_speculative.py``).

Against the JAX package, at the same weights and inputs, ``verify_chunk``
logits agree within 1e-4 (float32; the paged window through
``layers.attention`` as well). ``speculative_accept`` (its hypothesis
properties, and its draws against the reference's) is in
``tests/test_torch_speculative_props.py``, the serving streams against
the reference engine's in ``tests/test_torch_speculative_streams.py``.
Smoke configs at float32 compute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.common import cache_layout  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import _layer  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams,  # noqa: E402
                                 NgramDrafter, Request, ServingEngine, prng)
from repro_torch.serving.pagepool import SlotSplicer  # noqa: E402
from repro_torch.serving.quantize import quantize_mlp_tree  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PROMPT = "speculative parity prompt"
SEEDED = GenerationParams(max_tokens=12, temperature=0.9, seed=42)
# (arch, paged, kv_dtype): kv_dtype "int8" also serves W4A16 weights
FAMS = [("minitron-8b", True, "fp32"), ("minitron-8b", False, "fp32"),
        ("gemma-7b", True, "fp32"), ("gemma-7b", False, "fp32"),
        ("minitron-8b", True, "int8")]


def _id(f):
    arch, paged, kv = f
    return f"{arch}-{'paged' if paged else 'contig'}-{kv}"


def run_one(cb, engine, prompt, max_new=12, params=None, rid="r"):
    req = Request(rid=rid, prompt_ids=engine.tokenizer.encode(prompt),
                  max_new_tokens=max_new, params=params)
    cb.submit(req)
    cb.run_until_drained()
    assert req.done, req
    return req.output_ids


def replay_hook(ref, k):
    """Drafts that replay the plain run's own continuation: 100% acceptance."""
    def hook(slot, req):
        pos = len(req.output_ids)
        return list(ref[pos:pos + k])
    return hook


def corrupt_hook(ref, k, at):
    """Replay drafts with position ``at`` flipped (``"all"``: every one)."""
    def hook(slot, req):
        pos = len(req.output_ids)
        d = list(ref[pos:pos + k])
        if at == "all":
            d = [(t + 1) % 300 for t in d]
        elif len(d) > at:
            d[at] = (d[at] + 1) % 300
        return d
    return hook


def _batcher(eng, mode="off", slots=2, cls=ContinuousBatcher):
    eng.speculative = mode
    cb = cls(eng, slots=slots, max_seq=96, page=16, prefix_pages=24)
    eng.speculative = "off"
    return cb


def spec_cb(eng, mode="ngram", slots=2):
    cb = _batcher(eng, mode, slots)
    assert cb.spec and cb.spec_mode == mode
    return cb


def _port_engine(arch, paged, kv, params=None):
    cfg = get_smoke_config(arch).replace(**KW)
    if params is None:
        params = build_model(cfg).init(0, device="cpu")
        if kv != "fp32":
            params = quantize_mlp_tree(params, group_size=64)
    return ServingEngine(cfg, max_seq=96, paged_kv=paged, kv_dtype=kv, device="cpu",
                         params=params)


@pytest.fixture(scope="module", params=FAMS, ids=_id)
def fam(request):
    """One engine per (family, path, pages), shared across tests, with the
    plain greedy and seeded references; each test builds its own batcher."""
    arch, paged, kv = request.param
    eng = _port_engine(arch, paged, kv)
    cb = _batcher(eng)
    assert not cb.spec               # engine default: speculation off
    assert cb.paged == paged
    ref = {"plain": run_one(cb, eng, PROMPT),
           "seeded": run_one(cb, eng, "seeded spec", params=SEEDED)}
    yield arch, paged, eng, ref
    eng.shutdown()


# ------------------------------------------------- forced acceptance rates
def test_full_acceptance_fast_path(fam):
    arch, paged, eng, ref = fam
    cb = spec_cb(eng)
    cb.draft_hook = replay_hook(ref["plain"], cb.spec_k)
    assert run_one(cb, eng, PROMPT) == ref["plain"]
    st = cb.spec_stats
    assert st.acceptance_rate > 0.9, st
    assert st.tokens_per_tick > cb.spec_k, st


def test_zero_acceptance_degrades_to_plain(fam):
    """Every draft wrong: acceptance 0, one token a tick, and still the
    plain tokens -- rejected positions roll back by position alone."""
    arch, paged, eng, ref = fam
    cb = spec_cb(eng)
    cb.draft_hook = corrupt_hook(ref["plain"], cb.spec_k, "all")
    assert run_one(cb, eng, PROMPT) == ref["plain"]
    st = cb.spec_stats
    assert st.accepted == 0, st
    assert st.emitted == len(ref["plain"]) - 1 - st.plain_ticks, st
    assert st.tokens_per_tick == pytest.approx(1.0), st


def test_mid_chunk_rejection(fam):
    arch, paged, eng, ref = fam
    cb = spec_cb(eng)
    cb.draft_hook = corrupt_hook(ref["plain"], cb.spec_k, 2)
    assert run_one(cb, eng, PROMPT) == ref["plain"]
    st = cb.spec_stats
    assert 0 < st.acceptance_rate < 1.0, st


def test_seeded_identity(fam):
    arch, paged, eng, ref = fam
    cb = spec_cb(eng)
    cb.draft_hook = replay_hook(ref["seeded"], cb.spec_k)
    assert run_one(cb, eng, "seeded spec", params=SEEDED) == ref["seeded"]
    assert cb.spec_stats.acceptance_rate > 0.9


def test_ngram_self_draft_identity(fam):
    arch, paged, eng, ref = fam
    cb = spec_cb(eng)
    assert run_one(cb, eng, PROMPT) == ref["plain"]
    assert cb.spec_stats.spec_ticks + cb.spec_stats.plain_ticks > 0


def test_mixed_batch_seeded_stream_invariance(fam):
    """A speculating slot and a plain slot (no drafts) share a batch;
    both streams equal their solo seeded references."""
    arch, paged, eng, ref = fam
    spec_ref = ref["seeded"]
    plain_ref = run_one(_batcher(eng), eng, PROMPT, params=SEEDED)
    cb2 = spec_cb(eng)

    def hook(slot, req):
        if req.rid != "spec":
            return []
        pos = len(req.output_ids)
        return list(spec_ref[pos:pos + cb2.spec_k])

    cb2.draft_hook = hook
    a = Request(rid="spec", prompt_ids=eng.tokenizer.encode("seeded spec"),
                max_new_tokens=12, params=SEEDED)
    b = Request(rid="plain", prompt_ids=eng.tokenizer.encode(PROMPT),
                max_new_tokens=12, params=SEEDED)
    cb2.submit(a)
    cb2.submit(b)
    cb2.run_until_drained()
    assert a.output_ids == spec_ref
    assert b.output_ids == plain_ref
    assert cb2.spec_stats.accepted > 0


# ------------------------------------------------------ cross-tier drafter
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_model_drafter_pairings(paged):
    """A dense verifier with (a) a different small drafter -- identity must
    hold -- and (b) itself as drafter -- acceptance 1.0, which pins the
    drafter cache's coverage of the k-th draft."""
    big = get_smoke_config("minitron-8b").replace(**KW)
    small = get_smoke_config("gemma-7b").replace(**KW)
    eng0 = _port_engine("minitron-8b", paged, "fp32")
    plain = run_one(_batcher(eng0), eng0, "cross tier drafting")

    eng = ServingEngine(big, max_seq=96, paged_kv=paged, drafter_cfg=small,
                        params=eng0.params, device="cpu")
    assert eng.speculative == "model"
    cb = ContinuousBatcher(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
    assert cb.spec_mode == "model"
    assert run_one(cb, eng, "cross tier drafting") == plain
    assert cb._drafter.bytes_copied > 0
    assert cb.pool.bytes_copied + cb._splicer.bytes_copied == 0 or not paged
    eng.shutdown()

    eng2 = ServingEngine(big, max_seq=96, paged_kv=paged, drafter_cfg=big,
                         drafter_params=eng0.params, params=eng0.params, device="cpu")
    cb2 = ContinuousBatcher(eng2, slots=2, max_seq=96, page=16, prefix_pages=24)
    assert run_one(cb2, eng2, "cross tier drafting") == plain
    assert cb2.spec_stats.acceptance_rate == pytest.approx(1.0), cb2.spec_stats
    eng2.shutdown()
    eng0.shutdown()


def test_model_drafter_seed_derivation():
    """Without drafter_params the drafter is drawn from the second word of
    fold_in(PRNGKey(seed), 7) (the JAX package draws from fold_in(rng, 7))."""
    big = get_smoke_config("minitron-8b").replace(**KW)
    eng = ServingEngine(big, max_seq=96, drafter_cfg=big, seed=3, device="cpu")
    want = build_model(big).init(prng.fold_in(prng.PRNGKey(3), 7)[1], device="cpu")
    assert torch.equal(eng.drafter.params["embed"]["w"], want["embed"]["w"])
    assert not torch.equal(eng.drafter.params["embed"]["w"], eng.params["embed"]["w"])


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_recurrent_family_declines_and_falls_back(arch):
    """Families without a rollback-able state lack the contract; asking
    for speculation runs plain decode, as in the JAX package."""
    cfg = get_smoke_config(arch).replace(**KW)
    eng = ServingEngine(cfg, max_seq=96, speculative="ngram", device="cpu")
    ref = eng.generate("recurrent fallback", max_new_tokens=6).tokens
    cb = ContinuousBatcher(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
    assert not cb.spec and cb.spec_mode == "off"
    assert run_one(cb, eng, "recurrent fallback", max_new=6) == ref
    eng.shutdown()


def test_model_drafter_requires_shared_vocab():
    big = get_smoke_config("minitron-8b").replace(**KW)
    other = get_smoke_config("gemma-7b").replace(vocab_size=320, vocab_pad_to=64)
    with pytest.raises(AssertionError):
        ServingEngine(big, max_seq=96, drafter_cfg=other, device="cpu")


def test_model_mode_without_drafter_runs_plain():
    eng = _port_engine("minitron-8b", True, "fp32")
    cb = _batcher(eng, "model")
    assert not cb.spec and cb.spec_mode == "off"


# -------------------------------------------------- model-layer contract
@pytest.fixture(scope="module", params=["minitron-8b", "gemma-7b"])
def model(request):
    jm = ref_build(ref_smoke(request.param).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_smoke_config(request.param).replace(**KW))
    return request.param, m.cfg, m, params_from_numpy(jax.tree.map(np.asarray, jp)), jm, jp


def _prefilled(m, p, ids, batch_cache=None):
    c = m.init_cache(1, 96, device="cpu")
    with torch.inference_mode():
        _, c = m.prefill_chunk(p, torch.tensor([ids]), c)
    return c


def _copy(c):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in c.items()}


def test_verify_chunk_bitwise_equals_prefill_chunk(model):
    """verify_chunk reuses the chunked-prefill machinery: its last
    position's logits are prefill_chunk's, bit for bit, and pos is left
    for the caller."""
    arch, cfg, m, p, _, _ = model
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 300, size=24).tolist()
    win = rng.randint(0, 300, size=5).tolist()
    c1 = _prefilled(m, p, ids)
    with torch.inference_mode():
        vlog, c2 = m.verify_chunk(p, torch.tensor([win]), _copy(c1))
        plog, _ = m.prefill_chunk(p, torch.tensor([win]), _copy(c1))
    assert vlog.shape == (1, 5, cfg.padded_vocab)
    assert c2["pos"] == len(ids)
    assert torch.equal(vlog[:, -1], plog)


def test_verify_chunk_matches_sequential_decode(model):
    """All W positions of one verify == W decode steps feeding the same
    tokens (float32: 1e-4)."""
    arch, cfg, m, p, _, _ = model
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 300, size=24).tolist()
    win = rng.randint(0, 300, size=5).tolist()
    c1 = _prefilled(m, p, ids)
    with torch.inference_mode():
        vlog, _ = m.verify_chunk(p, torch.tensor([win]), _copy(c1))
        c, seq = _copy(c1), []
        for t in win:
            lgd, c = m.decode_step(p, torch.tensor([[t]]), c)
            seq.append(lgd)
    torch.testing.assert_close(torch.stack(seq, 1), vlog, atol=1e-4, rtol=0)


def test_verify_chunk_vector_positions(model):
    """Per-slot (B,) positions score each lane as a batch-1 verify would."""
    arch, cfg, m, p, _, _ = model
    rng = np.random.RandomState(3)
    ids = [rng.randint(0, 300, size=n).tolist() for n in (24, 17)]
    win = [rng.randint(0, 300, size=5).tolist() for _ in range(2)]
    solo = []
    with torch.inference_mode():
        for s, w in zip(ids, win):
            v, _ = m.verify_chunk(p, torch.tensor([w]), _prefilled(m, p, s))
            solo.append(v[0])
        cb = m.init_cache(2, 96, device="cpu")
        cb["pos"] = torch.zeros(2, dtype=torch.int32)
        sp = SlotSplicer(cache_layout(m.cache_specs()))
        for i, s in enumerate(ids):
            sp(cb, _prefilled(m, p, s), i, 96)
        vb, c2 = m.verify_chunk(p, torch.tensor(win), cb)
    assert c2["pos"].tolist() == [24, 17]
    for i in range(2):
        torch.testing.assert_close(vb[i], solo[i], atol=2e-4, rtol=2e-4)


def test_verify_chunk_matches_reference(model):
    """The contiguous verify at vector positions against the JAX package's."""
    arch, cfg, m, p, jm, jp = model
    rng = np.random.RandomState(4)
    ids = [rng.randint(0, 300, size=n).tolist() for n in (24, 17)]
    win = rng.randint(0, 300, size=(2, 5))
    jc = jm.init_cache(2, 96)
    pc = m.init_cache(2, 96, device="cpu")
    jc["pos"] = jnp.zeros((2,), jnp.int32)
    pc["pos"] = torch.zeros(2, dtype=torch.int32)
    from repro.models.common import cache_layout as jlayout
    from repro.serving.pagepool import SlotSplicer as JSplicer
    jsp, sp = JSplicer(jlayout(jm.cache_specs())), SlotSplicer(cache_layout(m.cache_specs()))
    for i, s in enumerate(ids):
        one = jm.init_cache(1, 96)
        _, one = jm.prefill_chunk(jp, jnp.asarray([s]), one)
        jc = jsp(jc, one, i, 96)
        sp(pc, _prefilled(m, p, s), i, 96)
    jl, _ = jm.verify_chunk(jp, jnp.asarray(win, jnp.int32), jc)
    with torch.inference_mode():
        pl, _ = m.verify_chunk(p, torch.from_numpy(win), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_paged_verify_window_matches_reference(kv):
    """layers.attention's paged verify window against the JAX package's:
    slot 0's window crosses a page boundary; slot 1's runs past the
    table's last page, and those positions go to the trash page 0.
    Output within 1e-4; every page but the trash page equal (int8 codes
    and their scales bit for bit); the trash page written."""
    cfg = get_smoke_config("minitron-8b").replace(**KW)
    jp = ref_build(ref_smoke("minitron-8b").replace(**KW)).init(jax.random.PRNGKey(0))
    attn = _layer(params_from_numpy(jax.tree.map(np.asarray, jp))["blocks"], 0)["attn"]
    jattn = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    r = np.random.default_rng(7)
    B, S, P, page = 2, 5, 9, 16
    x = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    shape = (P, cfg.n_kv_heads, page, cfg.head_dim)
    pages = [jnp.asarray(r.standard_normal(shape).astype(np.float32)) for _ in "kv"]
    bt = np.array([[3, 4], [5, 6]], np.int32)
    pos = np.array([14, 29], np.int32)
    positions = pos[:, None] + np.arange(S)[None, :]
    if kv == "int8":
        from repro.kernels.ref import quantize_kv as jq
        (kq, ksc), (vq, vsc) = (jq(a, jnp.int8) for a in pages)
        jcache = (kq, vq, ksc, vsc)
    else:
        jcache = tuple(pages)
    before = [np.array(a) for a in jcache]
    pcache = tuple(torch.from_numpy(a.copy()) for a in before)
    jy, jnew = jlayers.attention(jnp.asarray(x), jattn, cfg, positions=jnp.asarray(positions),
                                 cache=jcache, cache_index=jnp.asarray(pos), chunked=True,
                                 block_tables=jnp.asarray(bt))
    with torch.inference_mode():
        y = layers.attention(torch.from_numpy(x), attn, cfg,
                             positions=torch.from_numpy(positions), cache=pcache,
                             cache_index=torch.from_numpy(pos), chunked=True,
                             block_tables=torch.from_numpy(bt))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    for t, j, b in zip(pcache, jnew, before):
        if kv == "int8":
            np.testing.assert_array_equal(t[1:].numpy(), np.asarray(j)[1:])
        else:
            np.testing.assert_allclose(t[1:].numpy(), np.asarray(j)[1:], atol=1e-5, rtol=0)
        assert not np.array_equal(t[0].numpy(), b[0])         # the trash page took writes
        assert np.array_equal(t[[1, 2, 7, 8]].numpy(), b[[1, 2, 7, 8]])   # unmapped pages


def test_propose_k_greedy_chain(model):
    """Drafts equal the greedy chain of decode steps and the JAX package's
    propose_k; pos advances k + 1."""
    arch, cfg, m, p, jm, jp = model
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 300, size=24).tolist()
    c1 = _prefilled(m, p, ids)
    t0 = int(rng.randint(0, 300))
    with torch.inference_mode():
        drafts, c2 = m.propose_k(p, torch.tensor([[t0]]), _copy(c1), 4)
        c, tok, seq = _copy(c1), torch.tensor([[t0]]), []
        for _ in range(4):
            lgd, c = m.decode_step(p, tok, c)
            lgd = torch.where(torch.arange(lgd.shape[-1]) < 300, lgd, -1e30)
            tok = torch.argmax(lgd, -1)[:, None]
            seq.append(int(tok[0, 0]))
    assert c2["pos"] == len(ids) + 5
    assert drafts[0].tolist() == seq
    jc = jm.init_cache(1, 96)
    _, jc = jm.prefill_chunk(jp, jnp.asarray([ids]), jc)
    jd, _ = jm.propose_k(jp, jnp.asarray([[t0]], jnp.int32), jc, 4)
    assert np.asarray(jd)[0].tolist() == seq


def test_recurrent_models_do_not_implement_contract():
    for arch in ("xlstm-125m", "zamba2-7b"):
        m = build_model(get_smoke_config(arch).replace(**KW))
        assert not hasattr(m, "verify_chunk")
        assert not hasattr(m, "propose_k")


def test_ngram_drafter_prompt_lookup():
    d = NgramDrafter(k=3, ngrams=(3, 2, 1))
    assert d.propose([5, 6, 7, 8, 9, 5, 6, 7]) == [8, 9, 5]   # longest tail n-gram
    assert d.propose([1, 2, 3]) == []                          # no earlier occurrence
    assert d.propose([4, 4]) == [4]                            # unigram fallback
