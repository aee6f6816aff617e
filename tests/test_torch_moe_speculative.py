"""Speculative decoding and rolling windows over an MLA verifier (the
deepseek-v2-lite smoke config as the HPC engine) against plain decode
and against the JAX package's engine at the same weights: n-gram
drafting with forced 100% and mid-window acceptance (paged and
contiguous), grok-1's smoke model drafting for it, and a rolling window
that re-rotates only ``k_rope`` with streams, roll counts and summarizer
spans equal to the reference's. The MLA members of the JAX package's
``tests/test_speculative.py`` and ``tests/test_rolling_window.py``.
Float32 compute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving import ContinuousBatcher as RefBatcher  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving import WindowPolicy as RefPolicy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams,  # noqa: E402
                                 Request, ServingEngine, WindowPolicy)

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
ARCH = "deepseek-v2-lite-16b"
PROMPT = "hello paged latent world, across more than one sixteen-token page"
SEEDED = GenerationParams(max_tokens=8, temperature=0.9, seed=77)


def _cfg(arch=ARCH):
    return get_smoke_config(arch).replace(**KW)


def run_one(cb, engine, prompt, max_new=8, params=None, rid="r"):
    out = {}
    ids = engine.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
    cb.submit(Request(rid=rid, prompt_ids=ids, max_new_tokens=max_new, params=params,
                      on_done=lambda r: out.update(tokens=list(r.output_ids),
                                                   hit=r.prefix_hit_tokens,
                                                   rolls=r._rolls)))
    cb.run_until_drained()
    return out


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(ref_smoke(ARCH).replace(**KW), max_seq=96)
    port = ServingEngine(_cfg(), max_seq=96, device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    yield ref, port
    ref.shutdown()
    port.shutdown()


def _batcher(eng, paged=True, cls=ContinuousBatcher, spec="off", **kw):
    """A batcher of ``eng`` on the paged or contiguous path with speculation
    ``spec``: the engine's switches are set for construction only (the
    batcher reads them once)."""
    was = eng.paged_kv, eng.speculative
    eng.paged_kv, eng.speculative = paged, spec
    try:
        cb = cls(eng, slots=2, max_seq=96, page=16, prefix_pages=24, **kw)
    finally:
        eng.paged_kv, eng.speculative = was
    assert cb.paged is paged
    return cb


def _replay(ref, k, at=None):
    def hook(slot, req):
        pos = len(req.output_ids)
        d = list(ref[pos:pos + k])
        for i in range(len(d)):
            if at == "all" or i == at:
                d[i] = (d[i] + 1) % 300
        return d
    return hook


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_ngram_speculation_equals_plain_and_reference(engines, paged):
    """n-gram drafting over the MLA verifier, and forced 100% / mid-window
    acceptance: the plain stream, and the reference's counts."""
    ref, port = engines
    plain = run_one(_batcher(port, paged), port, PROMPT, max_new=12)["tokens"]
    for name, hook in (("ngram", None), ("full", lambda k: _replay(plain, k)),
                       ("mid", lambda k: _replay(plain, k, 2))):
        stats = []
        for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
            cb = _batcher(eng, paged, cls, spec="ngram")
            assert cb.spec_mode == "ngram"
            if hook is not None:
                cb.draft_hook = hook(cb.spec_k)
            assert run_one(cb, eng, PROMPT, max_new=12)["tokens"] == plain, name
            s = cb.spec_stats
            stats.append((s.proposed, s.accepted, s.spec_ticks, s.plain_ticks))
        assert stats[0] == stats[1], name
        if name == "full":
            assert stats[1][1] > 0


def test_model_drafting_equals_plain_and_reference():
    """The grok smoke (MoE over GQA) drafting for the deepseek-v2-lite smoke
    (MLA): the plain stream, and the reference engine's tokens and counts."""
    big, small = ref_smoke(ARCH).replace(**KW), ref_smoke("grok-1-314b").replace(**KW)
    jp = ref_build(big).init(jax.random.PRNGKey(0))
    jd = ref_build(small).init(jax.random.PRNGKey(1))
    ref = RefEngine(big, max_seq=96, params=jp, drafter_cfg=small, drafter_params=jd)
    port = ServingEngine(_cfg(), max_seq=96, device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, jp)),
                         drafter_cfg=_cfg("grok-1-314b"),
                         drafter_params=params_from_numpy(jax.tree.map(np.asarray, jd)))
    plain = run_one(_batcher(port), port, "cross tier drafting", max_new=12)["tokens"]
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        cb = cls(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
        assert cb.spec_mode == "model"
        toks = run_one(cb, eng, "cross tier drafting", max_new=12)["tokens"]
        s = cb.spec_stats
        outs.append((toks, s.proposed, s.accepted, s.spec_ticks))
    assert outs[0] == outs[1] and outs[1][0] == plain
    ref.shutdown()
    port.shutdown()


def test_rolling_window_rotates_only_k_rope_and_matches_reference(engines):
    """Under a window (1 sink + 2 pages, cap 4) the MLA pool rolls: only
    ``k_rope`` and ``dense0_krope`` are re-rotated (the latent c_kv is
    position-free), and greedy and seeded rolling streams, roll counts
    and summarizer spans equal the reference engine's."""
    ref0, port0 = engines
    pol = dict(sink_pages=1, window_pages=2, roll_pages=1)
    ref = RefEngine(ref_smoke(ARCH).replace(**KW), max_seq=96, params=ref0.params,
                    window_policy=RefPolicy(**pol))
    port = ServingEngine(_cfg(), max_seq=96, device="cpu", params=port0.params,
                         window_policy=WindowPolicy(**pol))
    cb = ContinuousBatcher(port, slots=2, max_seq=96, prefix_pages=24)
    assert cb.window is not None
    assert sorted(k for k, _ in cb._rope_leaves) == ["dense0_krope", "k_rope"]
    pids = [3, 5]
    cb.cache["c_kv"][:, pids] = 1.0
    cb.cache["k_rope"][:, pids] = 1.0
    before = {k: cb.cache[k].clone() for k in ("c_kv", "k_rope", "dense0_ckv")}
    cb._shift_pages(pids, 16)
    assert torch.equal(cb.cache["c_kv"], before["c_kv"])
    assert torch.equal(cb.cache["dense0_ckv"], before["dense0_ckv"])
    assert not torch.equal(cb.cache["k_rope"][:, pids], before["k_rope"][:, pids])
    seeded = GenerationParams(max_tokens=40, temperature=0.9, seed=7)
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        spans = []
        submit = eng.span_summarizer.submit
        eng.span_summarizer.submit = lambda rid, ids, f=submit: (
            spans.append((rid, [int(i) for i in ids])), f(rid, ids))
        b = cls(eng, slots=2, max_seq=96, prefix_pages=24)
        done = {}
        for rid, ids, params in (("greedy", list(range(2, 2 + 80)), None),
                                 ("seeded", eng.tokenizer.encode(PROMPT), seeded)):
            b.submit(Request(rid=rid, prompt_ids=ids, max_new_tokens=40, params=params,
                             on_done=lambda r: done.update(
                                 {r.rid: (list(r.output_ids), r._rolls)})))
        b.run_until_drained()
        outs.append((done, b.rolls, sorted(spans)))
    assert outs[0] == outs[1]
    assert outs[1][0]["greedy"][1] >= 2
    ref.shutdown()
    port.shutdown()


