"""Rolling paged KV windows in the port (attention sinks, in-place page
rolls, async span summarization) against the JAX package's.

The contract, as in ``tests/test_rolling_window.py``: a slot under a
:class:`WindowPolicy` decodes without end at a flat ``cap_pages`` pages;
a roll evicts the oldest non-sink pages, hands their span to the
:class:`SpanSummarizer`, re-rotates the kept window's keys in place and
bumps ``pos_offset``. Sessions that fit the window equal the no-policy
path, and speculation clamps its verify windows at the roll boundary.
Here the port also meets the reference: ``rope_shift`` within 1e-6,
``_shift_pages`` over int8 pages bit for bit against the reference
batcher's math run op by op (within one code step of its XLA-fused
form), and greedy and seeded
rolling streams (float32 and int8 pages) token-identical, with the same
roll counts, pool high-water and spans handed to the summarizer. Smoke
minitron-8b at float32 compute with the reference's weights (the MLA
family's rolling test waits for the MLA port).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models.layers import rope_shift as ref_rope_shift  # noqa: E402
from repro.serving import ContinuousBatcher as RefBatcher  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving import WindowPolicy as RefPolicy  # noqa: E402
from repro.serving import quantize as jquant  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.layers import rope_freqs, apply_rope, rope_shift  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams, Request,  # noqa: E402
                                 ServingEngine, SessionBroker, WindowPolicy)

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
POLICY = WindowPolicy(sink_pages=1, window_pages=2, roll_pages=1)  # cap 4
REF_POLICY = RefPolicy(sink_pages=1, window_pages=2, roll_pages=1)
PROMPT = "rolling window prompt with enough text to cross the sinks!"


def _cfg():
    return get_smoke_config("minitron-8b").replace(**KW)


def _ref_params(kv="fp32"):
    jp = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96).params
    return jquant.quantize_mlp_tree(jp, group_size=64) if kv != "fp32" else jp


@pytest.fixture(scope="module")
def engine():
    e = ServingEngine(_cfg(), max_seq=96, window_policy=POLICY, device="cpu",
                      params=params_from_numpy(jax.tree.map(np.asarray, _ref_params())))
    e.warmup()
    yield e
    e.shutdown()


def run_one(cb, engine, prompt, max_new=6, params=None, rid="r"):
    out = {}
    ids = (engine.tokenizer.encode(prompt) if isinstance(prompt, str)
           else list(prompt))
    req = Request(rid=rid, prompt_ids=ids, max_new_tokens=max_new, params=params,
                  on_done=lambda r: out.update(tokens=r.output_ids,
                                               hit=r.prefix_hit_tokens,
                                               rolls=r._rolls,
                                               reason=r.finish_reason))
    cb.submit(req)
    cb.run_until_drained()
    return out


def _plain_batcher(engine, **kw):
    """A no-policy batcher over the policy engine: the attribute is
    flipped for construction only (the batcher reads it once)."""
    pol, engine.window_policy = engine.window_policy, None
    try:
        cb = ContinuousBatcher(engine, slots=2, max_seq=96, **kw)
    finally:
        engine.window_policy = pol
    assert cb.window is None
    return cb


# ------------------------------------------------------------ gating
def test_policy_active_on_paged_path(engine):
    cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    assert cb.paged and cb.window is POLICY
    assert "pos_offset" in cb.cache
    assert engine.span_summarizer is not None
    assert [k for k, _ in cb._rope_leaves] == ["k"]


def test_policy_declined_by_recurrent_family():
    """SSM state has no page address: the policy is declined, not half
    applied: append-only KV, no pos_offset in play."""
    cfg = get_smoke_config("zamba2-7b").replace(vocab_size=300, vocab_pad_to=64)
    e = ServingEngine(cfg, max_seq=96, window_policy=POLICY, device="cpu")
    cb = ContinuousBatcher(e, slots=2, max_seq=96, prefix_pages=64)
    assert not cb.paged and cb.window is None
    e.shutdown()


def test_policy_declined_on_contiguous_path():
    e = ServingEngine(_cfg(), max_seq=96, paged_kv=False, window_policy=POLICY,
                      device="cpu")
    cb = ContinuousBatcher(e, slots=2, max_seq=96, prefix_pages=64)
    assert not cb.paged and cb.window is None
    e.shutdown()


def test_policy_declined_when_cap_exceeds_table(engine):
    """cap_pages > n_pages could never map a whole window: the batcher
    keeps the bounded append-only contract."""
    big = WindowPolicy(sink_pages=2, window_pages=8)        # cap 11 > 6
    pol, engine.window_policy = engine.window_policy, big
    try:
        cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    finally:
        engine.window_policy = pol
    assert cb.window is None


# ------------------------------------------------ window-fitting identity
def test_window_fitting_token_identity(engine):
    """A session under the roll trigger ((cap_pages - 1) * page tokens)
    takes no roll and decodes the no-policy tokens, greedy and seeded:
    pos_offset stays 0."""
    short = "fits in the window"              # 19 tokens + 6 new < 48
    seeded = GenerationParams(max_tokens=6, temperature=0.8, seed=1234)
    outs = {}
    for mode, make in (("policy", lambda: ContinuousBatcher(
                            engine, slots=2, max_seq=96, prefix_pages=64)),
                       ("plain", lambda: _plain_batcher(engine, prefix_pages=64))):
        cb = make()
        outs[mode] = {"greedy": run_one(cb, engine, short, max_new=6),
                      "seeded": run_one(cb, engine, short + " y", max_new=6,
                                        params=seeded)}
    assert outs["policy"]["greedy"]["rolls"] == 0
    for kind in ("greedy", "seeded"):
        assert outs["policy"][kind]["tokens"] == outs["plain"][kind]["tokens"]


# --------------------------------------------------- rolling past the cap
def test_rolls_keep_occupancy_flat(engine):
    """Far past the window the session rolls, the pool's high-water stays
    at the cap (free, then allocate: no net allocation a roll) and two
    identical runs give identical tokens and rolls."""
    runs = []
    for _ in range(2):
        cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
        out = run_one(cb, engine, PROMPT, max_new=90)
        st = cb.pool_stats()
        runs.append((out["tokens"], out["rolls"]))
        assert out["rolls"] >= 2 and len(out["tokens"]) == 90
        assert st.high_water <= POLICY.cap_pages
        # finish released the window; only the published sinks remain
        assert st.occupancy <= POLICY.sink_pages
    assert runs[0] == runs[1]


def test_prompt_longer_than_window_rolls_in_prefill(engine):
    """A prompt past sinks + window rolls DURING chunked prefill (no
    clip_prompt for a policy session) and decodes at flat occupancy."""
    ids = list(range(2, 2 + 150))            # 150 tokens >> the 64-token cap
    cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    out = run_one(cb, engine, ids, max_new=8)
    assert len(out["tokens"]) == 8 or out["reason"] == "stop"
    assert out["rolls"] >= 5                 # (150 - 64) / 16 rolls at least
    assert cb.pool_stats().high_water <= POLICY.cap_pages


def test_summarizer_receives_rolled_spans(engine):
    """Every rolled span lands in the session's append-only summary:
    roll_pages * page tokens a roll, the first span right after the
    sinks verbatim at the head."""
    sink = engine.span_summarizer
    cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    out = run_one(cb, engine, PROMPT, max_new=90, rid="span-test")
    assert out["rolls"] >= 2
    assert sink.flush(timeout=30.0)
    assert sink.rolled_tokens("span-test") == out["rolls"] * POLICY.roll_pages * cb.page
    summary = sink.summary("span-test")
    assert summary
    full = engine.tokenizer.encode(PROMPT) + out["tokens"]
    lo = POLICY.sink_pages * cb.page
    assert summary.startswith(engine.tokenizer.decode(full[lo:lo + cb.page]))
    sink.drop("span-test")


def test_roll_never_frees_tree_pages(engine):
    """Sink pages published to the tree are shared: a later session's
    rolls recycle only its private window pages, it publishes nothing
    more, and a third session still hits the sinks."""
    cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    run_one(cb, engine, PROMPT, max_new=90, rid="seed")      # publishes the sinks
    tree_pids = set(cb.prefix._pids)
    assert tree_pids
    req = Request(rid="warm", prompt_ids=engine.tokenizer.encode(PROMPT),
                  max_new_tokens=90)
    cb.submit(req)
    while not req.done:
        cb.step()
        assert not (tree_pids & set(cb.pool._free))
    assert req._rolls >= 2
    assert req.prefix_hit_tokens > 0
    assert set(cb.prefix._pids) == tree_pids
    assert run_one(cb, engine, PROMPT, max_new=4, rid="third")["hit"] > 0


# ------------------------------------------------- speculation + rolling
def test_spec_roll_identity(engine):
    """With the draft cap clamped at the roll boundary, speculative decode
    under a rolling window is plain decode under it: same tokens, same
    rolls, at least two rolls mid-stream."""
    plain = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    ref = run_one(plain, engine, PROMPT, max_new=80, rid="plain")
    assert ref["rolls"] >= 2
    engine.speculative = "ngram"
    try:
        spec = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    finally:
        engine.speculative = "off"
    assert spec.spec and spec.window is POLICY
    out = run_one(spec, engine, PROMPT, max_new=80, rid="spec")
    assert spec.spec_stats.spec_ticks > 0
    assert out["tokens"] == ref["tokens"]
    assert out["rolls"] == ref["rolls"]


def test_draft_cap_clamped_at_roll_boundary(engine):
    """A full draft offered at every tick: the verify window is clamped at
    the boundary, never past it."""
    engine.speculative = "ngram"
    try:
        cb = ContinuousBatcher(engine, slots=2, max_seq=96, prefix_pages=64)
    finally:
        engine.speculative = "off"
    bnd = (POLICY.cap_pages - 1) * cb.page
    seen = []

    def hook(slot, req):
        seen.append(bnd - (int(cb._pos[slot]) - int(cb._poff[slot])))
        return [5] * cb.spec_k

    cb.draft_hook = hook
    run_one(cb, engine, PROMPT, max_new=80)
    assert any(room <= cb.spec_k for room in seen)
    assert all(room >= 0 for room in seen)


# ------------------------------------------------------------ broker
def test_broker_reports_rolls_and_pool_meta(engine):
    """Rolling sessions are not clipped, SessionResult carries the roll
    count, and on_meta has the pool's occupancy, high-water and
    capacity."""
    broker = SessionBroker(engine, slots=2, max_seq=96, prefix_pages=64)
    meta = {}
    res = broker.submit(PROMPT, max_new_tokens=90, on_meta=meta.update).result(timeout=300)
    broker.shutdown()
    assert res.rolls >= 2
    assert res.n_generated == 90
    assert meta["pool_capacity"] == 64
    assert 0 < meta["pool_occupancy"] <= meta["pool_capacity"]
    assert meta["pool_high_water"] >= meta["pool_occupancy"]


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("delta", [-16, -48, -64, 5])
def test_rope_shift_matches_reference(delta):
    """rope_shift against the reference's within 1e-6, and a key roped at
    p and shifted by delta is the key roped at p + delta."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    got = rope_shift(torch.from_numpy(x), delta, 10000.0)
    want = np.asarray(ref_rope_shift(jnp.asarray(x), delta, 10000.0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    pos = torch.arange(64, 80)
    roped = apply_rope(torch.from_numpy(x), *rope_freqs(pos, 16, 10000.0))
    again = apply_rope(torch.from_numpy(x), *rope_freqs(pos + delta, 16, 10000.0))
    torch.testing.assert_close(rope_shift(roped, delta, 10000.0), again,
                               atol=2e-5, rtol=0)


def test_shift_pages_int8_matches_reference_bitwise():
    """One roll's re-rotation over an int8 pool with scale sidecars: the
    same codes and scales in, the reference batcher's codes and scales
    out. Bit for bit against its ``_shift_pages`` run op by op
    (``jax.disable_jit``: the same dequantize, rope_shift and quantize
    math); against its jitted form, where XLA fuses the rotation into
    fused multiply-adds and evaluates sin its own way, the codes are
    within one step and the scales within 2e-7 relative. Pages outside
    the roll stay untouched."""
    jp = _ref_params("int8")
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96, params=jp,
                    kv_dtype="int8", window_policy=REF_POLICY)
    port = ServingEngine(_cfg(), max_seq=96, kv_dtype="int8", window_policy=POLICY,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    rb = RefBatcher(ref, slots=2, max_seq=96, prefix_pages=24)
    pb = ContinuousBatcher(port, slots=2, max_seq=96, prefix_pages=24)
    rng = np.random.default_rng(1)
    for key in ("k", "v"):
        shape = tuple(rb.cache[key].shape)
        codes = rng.integers(-127, 128, size=shape, dtype=np.int8)
        scales = (rng.random(shape[:-1]) * 0.05).astype(np.float32)
        rb.cache[key] = jnp.asarray(codes)
        rb.cache[f"{key}_qscale"] = jnp.asarray(scales)
        pb.cache[key].copy_(torch.from_numpy(codes))
        pb.cache[f"{key}_qscale"].copy_(torch.from_numpy(scales))
    before = {key: np.asarray(rb.cache[key]) for key in ("k", "k_qscale", "v", "v_qscale")}
    pids = [3, 7, 8, 20]
    pb._shift_pages(pids, 16)
    with jax.disable_jit():
        rb._shift_pages(pids, 16)
    eager = {key: np.asarray(rb.cache[key]) for key in before}
    for key in before:
        rb.cache[key] = jnp.asarray(before[key])
    rb._shift_pages(pids, 16)
    others = [p for p in range(rb.cache["k"].shape[1]) if p not in pids]
    for key in before:
        got = pb.cache[key].numpy()
        np.testing.assert_array_equal(got, eager[key])
        np.testing.assert_array_equal(got[:, others], before[key][:, others])
        jitted = np.asarray(rb.cache[key])
        if key.endswith("qscale"):
            np.testing.assert_allclose(got, jitted, rtol=2e-7, atol=0)
        else:
            assert np.abs(got.astype(np.int32) - jitted.astype(np.int32)).max() <= 1
    assert not np.array_equal(eager["k"], before["k"])
    np.testing.assert_array_equal(eager["v"], before["v"])       # V is never rotated
    ref.shutdown()
    port.shutdown()


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_rolling_streams_match_reference(kv):
    """Greedy and seeded rolling streams (a prompt that rolls in prefill,
    and one that rolls while decoding), served together: the port's
    tokens, roll counts, pool high-water and the spans handed to the
    summarizer equal the JAX engine's."""
    jp = _ref_params(kv)
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96, params=jp,
                    kv_dtype=kv, window_policy=REF_POLICY)
    port = ServingEngine(_cfg(), max_seq=96, kv_dtype=kv, window_policy=POLICY,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    seeded = GenerationParams(max_tokens=70, temperature=0.9, seed=7)
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        spans = []
        submit = eng.span_summarizer.submit
        eng.span_summarizer.submit = lambda rid, ids, f=submit: (
            spans.append((rid, [int(i) for i in ids])), f(rid, ids))
        cb = cls(eng, slots=2, max_seq=96, prefix_pages=24)
        done = {}
        for rid, ids, params in (("greedy", list(range(2, 2 + 100)), None),
                                 ("seeded", eng.tokenizer.encode(PROMPT), seeded)):
            cb.submit(Request(rid=rid, prompt_ids=ids, max_new_tokens=70, params=params,
                              on_done=lambda r: done.update(
                                  {r.rid: (list(r.output_ids), r._rolls)})))
        cb.run_until_drained()
        outs.append((done, cb.rolls, cb.pool_stats().high_water, sorted(spans)))
    assert outs[0] == outs[1]
    done = outs[1][0]
    assert done["greedy"][1] >= 3 and done["seeded"][1] >= 2
    assert len(done["greedy"][0]) == 70 and len(done["seeded"][0]) == 70
    ref.shutdown()
    port.shutdown()
