"""The contiguous splice path of the port's serving stack against the JAX
package's: ``SlotSplicer`` and the pool's ``store_pages`` /
``store_state`` / ``load`` move the same values and count the same
bytes; ``ContinuousBatcher`` serves what the paged path cannot (a
stateful model, ``prefix_pages=0``, an unaligned ``max_seq``,
``paged_kv=False``) with greedy streams token-identical to the paged
path, to ``generate`` and across prefix hits; ``generate_batch`` equals
per-prompt ``generate``. Smoke configs, float32 compute; pool and
splice contents are compared exactly (they are copies).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.common import cache_layout as ref_layout  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving.pagepool import PagePool as RefPool  # noqa: E402
from repro.serving.pagepool import SlotSplicer as RefSplicer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import cache_layout  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request, ServingEngine  # noqa: E402
from repro_torch.serving.pagepool import PagePool, SlotSplicer  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PAGE = 16
PROMPT = "hello prefix world, this is a longer shared prompt for caching!"
PROMPTS = ["hello contiguous world", "a prompt that runs past one sixteen-token "
           "page, and then some more", "x"]


def _random_cache(model, batch, max_seq, seed):
    """A port cache and the same values as a JAX cache."""
    r = np.random.default_rng(seed)
    cache = model.init_cache(batch, max_seq, device="cpu")
    arrays = {k: r.standard_normal(tuple(v.shape)).astype(np.float32)
              for k, v in cache.items() if k != "pos"}
    port = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    port["pos"] = 0
    return port, {**{k: jnp.asarray(a) for k, a in arrays.items()},
                  "pos": jnp.zeros((), jnp.int32)}


@pytest.mark.parametrize("arch", ["minitron-8b", "zamba2-7b"])
def test_slot_splicer_matches_reference(arch):
    cfg = get_smoke_config(arch).replace(**KW)
    pm, jm = build_model(cfg), ref_build(ref_smoke(arch).replace(**KW))
    cache, jcache = _random_cache(pm, 3, 64, 0)
    one, jone = _random_cache(pm, 1, 64, 1)
    cache["pos"], jcache["pos"] = torch.zeros(3, dtype=torch.int32), jnp.zeros(3, jnp.int32)
    one["pos"], jone["pos"] = 21, jnp.asarray(21, jnp.int32)
    sp = SlotSplicer(cache_layout(pm.cache_specs()))
    jsp = RefSplicer(ref_layout(jm.cache_specs()))
    sp(cache, one, 1, 32)
    jcache = jsp(jcache, jone, 1, 32)
    for k in cache:
        assert np.array_equal(cache[k].numpy(), np.asarray(jcache[k])), k
    assert cache["pos"].tolist() == [0, 21, 0]
    assert sp.bytes_copied == jsp.bytes_copied > 0


@pytest.mark.parametrize("arch", ["minitron-8b", "zamba2-7b"])
def test_pool_store_and_load_match_reference(arch):
    """store_pages of slot 1's pages 1..2 into pool pages [5, 2],
    store_state at page 2 (stateful pools), then load pages [5, 2] and
    the snapshot into slot 0 of a fresh cache: pool buffers, loaded cache
    and bytes_copied all equal the JAX package's."""
    cfg = get_smoke_config(arch).replace(**KW)
    pm, jm = build_model(cfg), ref_build(ref_smoke(arch).replace(**KW))
    pool, jpool = PagePool(pm, page=PAGE, capacity=6), RefPool(jm, page=PAGE, capacity=6)
    assert pool.stateful == jpool.stateful == (arch == "zamba2-7b")
    assert pool.pool_bytes == jpool.pool_bytes
    cache, jcache = _random_cache(pm, 2, 64, 2)
    pool.store_pages(cache, 1, 1, [5, 2])
    jpool.store_pages(jcache, 1, 1, [5, 2])
    pool.store_state(cache, 1, 2)
    jpool.store_state(jcache, 1, 2)
    for name, buf in zip(jpool._leaf_names, jpool._paged):
        if buf is not None:
            assert np.array_equal(pool._paged[name].numpy(), np.asarray(buf)), name
    for name, buf in zip(jpool._leaf_names, jpool._state):
        if buf is not None:
            assert np.array_equal(pool._state[name].numpy(), np.asarray(buf)), name
    fresh = pm.init_cache(1, 64, device="cpu")
    got = pool.load(fresh, 0, [5, 2], state_pid=2 if pool.stateful else None)
    want = jpool.load(jm.init_cache(1, 64), 0, [5, 2],
                      state_pid=2 if pool.stateful else None)
    assert got is fresh and got["pos"] == int(want["pos"]) == 2 * PAGE
    for k in got:
        if k != "pos":
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert pool.bytes_copied == jpool.bytes_copied > 0


@pytest.fixture(scope="module")
def minitron():
    cfg = get_smoke_config("minitron-8b").replace(**KW)
    e = ServingEngine(cfg, max_seq=96, device="cpu")
    yield e
    e.shutdown()


def run_one(cb, engine, prompt, max_new=6):
    out = {}
    cb.submit(Request(rid="r", prompt_ids=engine.tokenizer.encode(prompt),
                      max_new_tokens=max_new,
                      on_done=lambda r: out.update(tokens=r.output_ids,
                                                   hit=r.prefix_hit_tokens)))
    cb.run_until_drained()
    return out


def _serve(cb, engine, prompts, max_new=8):
    out = {}
    for i, p in enumerate(prompts):
        cb.submit(Request(rid=str(i), prompt_ids=engine.tokenizer.encode(p),
                          max_new_tokens=max_new,
                          on_done=lambda r: out.update({r.rid: r.output_ids})))
    cb.run_until_drained()
    return [out[str(i)] for i in range(len(prompts))]


def test_contiguous_minitron_token_identical_to_paged(minitron):
    """paged_kv=False pins the splice path: the same greedy streams as
    the paged path, at a cost the paged path does not pay."""
    paged = ContinuousBatcher(minitron, slots=2, max_seq=96, prefix_pages=32)
    minitron.paged_kv = False
    try:
        contig = ContinuousBatcher(minitron, slots=2, max_seq=96, prefix_pages=32)
    finally:
        minitron.paged_kv = True
    assert paged.paged and not contig.paged
    prompts = PROMPTS + [PROMPTS[1]]                   # the repeat hits the cache
    assert _serve(contig, minitron, prompts) == _serve(paged, minitron, prompts)
    assert contig.prefix.stats.hits == paged.prefix.stats.hits > 0
    assert paged.bytes_copied_per_admission() == 0.0
    assert contig.bytes_copied_per_admission() > 0
    assert contig.transfers > 0 and contig.adm_transfers == contig.admissions == 4


@pytest.mark.parametrize("max_seq,prefix_pages", [(96, 0), (90, 32)])
def test_splice_path_serves_what_paged_cannot(minitron, max_seq, prefix_pages):
    """No pool at all, and an unaligned max_seq: served, not refused, with
    each stream equal to a solo generate()."""
    cb = ContinuousBatcher(minitron, slots=2, max_seq=max_seq, prefix_pages=prefix_pages)
    assert not cb.paged and (cb.pool is None) == (prefix_pages == 0)
    solo = ServingEngine(minitron.cfg, params=minitron.params, max_seq=max_seq,
                         device="cpu")
    want = [solo.generate(p, max_new_tokens=8).tokens for p in PROMPTS]
    assert _serve(cb, minitron, PROMPTS) == want
    if prefix_pages == 0:
        assert cb.pool_stats() is None and cb.bytes_copied_per_admission() > 0


def test_bytes_copied_per_admission_matches_reference():
    """The splice + store/load traffic per admission, byte for byte."""
    ref_e = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96,
                      paged_kv=False)
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         device="cpu", paged_kv=False,
                         params=params_from_numpy(jax.tree.map(np.asarray, ref_e.params)))
    from repro.serving import ContinuousBatcher as RefBatcher
    from repro.serving import Request as RefRequest
    rb = RefBatcher(ref_e, slots=2, max_seq=96, prefix_pages=32)
    pb = ContinuousBatcher(port, slots=2, max_seq=96, prefix_pages=32)
    outs = []
    for cb, eng, R in ((rb, ref_e, RefRequest), (pb, port, Request)):
        done = {}
        for i, p in enumerate([PROMPT, PROMPT]):
            cb.submit(R(rid=str(i), prompt_ids=eng.tokenizer.encode(p), max_new_tokens=5,
                        on_done=lambda r: done.update({r.rid: r.output_ids})))
            cb.run_until_drained()
        outs.append(done)
    assert outs[0] == outs[1]
    assert pb.bytes_copied_per_admission() == rb.bytes_copied_per_admission() > 0


def test_zamba2_prefix_hit_identity():
    """Hybrid SSM: a prefix hit (K/V pages and the state snapshot loaded
    from the pool) decodes token-identically to cold prefill and to a
    solo generate()."""
    cfg = get_smoke_config("zamba2-7b").replace(**KW)
    e = ServingEngine(cfg, max_seq=96, device="cpu")
    solo = e.generate(PROMPT, max_new_tokens=5)
    cb = ContinuousBatcher(e, slots=2, max_seq=96, prefix_pages=64)
    assert not cb.paged and cb.pool.stateful
    cold = run_one(cb, e, PROMPT, max_new=5)
    warm = run_one(cb, e, PROMPT, max_new=5)
    assert cold["tokens"] == solo.tokens
    assert warm["tokens"] == solo.tokens
    assert cold["hit"] == 0 and warm["hit"] > 0
    # the cold prefill published a snapshot at each completed page
    assert cb.prefix.stats.published_pages >= len(e.tokenizer.encode(PROMPT)) // PAGE


def test_zamba2_cancel_mid_prefill_keeps_published_pages():
    """A stateful admission publishes page by page while it prefills:
    cancelled mid-prefill, its completed pages stay in the tree and a
    later session resumes from them."""
    cfg = get_smoke_config("zamba2-7b").replace(**KW)
    e = ServingEngine(cfg, max_seq=128, device="cpu")
    cb = ContinuousBatcher(e, slots=2, max_seq=128, prefix_pages=64, prefill_chunk=16)
    long = PROMPT + " and a tail that keeps the prefill going for a while"
    busy = Request(rid="busy", prompt_ids=e.tokenizer.encode("x"), max_new_tokens=40)
    cb.submit(busy)
    cb.step()                                  # busy decodes; prefill is now paced
    victim = Request(rid="v", prompt_ids=e.tokenizer.encode(long), max_new_tokens=4)
    cb.submit(victim)
    cb.step()
    cb.step()
    assert cb._adm is not None and cb._adm.req is victim and cb._adm.pos >= 2 * PAGE
    assert cb.cancel(victim) and victim.cancelled
    assert cb.prefix.n_nodes() >= 2
    warm = run_one(cb, e, long, max_new=4)
    assert warm["hit"] >= 2 * PAGE
    assert warm["tokens"] == e.generate(long, max_new_tokens=4).tokens


@pytest.mark.parametrize("arch", ["minitron-8b", "zamba2-7b"])
def test_generate_batch_equals_generate(arch):
    cfg = get_smoke_config(arch).replace(**KW)
    e = ServingEngine(cfg, max_seq=160, device="cpu")
    texts, outs = e.generate_batch(PROMPTS, max_new_tokens=6)
    assert len(texts) == len(outs) == 3
    for p, o in zip(PROMPTS, outs):
        assert o == e.generate(p, max_new_tokens=6).tokens


def test_generate_batch_matches_reference():
    ref_e = RefEngine(ref_smoke("zamba2-7b").replace(**KW), max_seq=160)
    port = ServingEngine(get_smoke_config("zamba2-7b").replace(**KW), max_seq=160,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref_e.params)))
    assert port.generate_batch(PROMPTS, max_new_tokens=6)[1] == \
        ref_e.generate_batch(PROMPTS, max_new_tokens=6)[1]


def test_per_slot_cache_writes_and_chunk_attention():
    """update_cache_at with an int and with a (B,) index equals the JAX
    package's; a chunk at per-slot positions attends as each slot alone
    at its own int position."""
    from repro.models.layers import update_cache_at as ref_update
    from repro_torch.models import layers

    r = np.random.default_rng(5)
    buf = r.standard_normal((3, 2, 16, 4)).astype(np.float32)
    new = r.standard_normal((3, 2, 5, 4)).astype(np.float32)
    for idx in (4, np.asarray([0, 7, 11], np.int32)):
        got = layers.update_cache_at(torch.from_numpy(buf.copy()), torch.from_numpy(new),
                                     torch.from_numpy(idx) if isinstance(idx, np.ndarray)
                                     else idx, axis=2)
        want = ref_update(jnp.asarray(buf), jnp.asarray(new), idx, axis=2)
        assert np.array_equal(got.numpy(), np.asarray(want))

    cfg = get_smoke_config("minitron-8b").replace(**KW)
    p = {k: v[0] for k, v in
         build_model(cfg).init(seed=2, device="cpu")["blocks"]["attn"].items()}
    x = torch.from_numpy(r.standard_normal((2, 3, cfg.d_model)).astype(np.float32))
    shape = (2, cfg.n_kv_heads, 32, cfg.head_dim)
    ck = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    cv = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    pos = torch.tensor([5, 17], dtype=torch.int32)
    k2, v2 = ck.clone(), cv.clone()
    out = layers.attention(x, p, cfg, positions=pos[:, None] + torch.arange(3),
                           cache=(k2, v2), cache_index=pos, chunked=True)
    for b in range(2):
        kb, vb = ck[b:b + 1].clone(), cv[b:b + 1].clone()
        o = layers.attention(x[b:b + 1], p, cfg, positions=torch.arange(3) + int(pos[b]),
                             cache=(kb, vb), cache_index=int(pos[b]), chunked=True)
        torch.testing.assert_close(out[b:b + 1], o, atol=1e-6, rtol=0)
        assert torch.equal(k2[b:b + 1], kb) and torch.equal(v2[b:b + 1], vb)
