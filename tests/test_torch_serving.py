"""Port serving stack (ServingEngine.submit -> SessionBroker -> paged
ContinuousBatcher) against the JAX package's, with the reference's
weights: greedy streams token-identical, zero bytes copied per
admission, one packed host read per tick, and the page-pool invariants
(trash page 0 never handed out nor read unmasked, free guards).
Smoke config, float32 compute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving.pagepool import chunk_plan as ref_chunk_plan  # noqa: E402
from repro.serving.scheduler import clip_prompt as ref_clip_prompt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (TRASH_PAGE, ContinuousBatcher, GenerationParams,  # noqa: E402
                                 Request, SamplerConfig, ServingEngine, chunk_plan)
from repro_torch.serving.sampler import sample_slots  # noqa: E402
from repro_torch.serving.scheduler import clip_prompt  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PROMPTS = ["hello paged world", "a prompt that runs past one sixteen-token page, "
           "and then some more", "x", "hello paged world"]


@pytest.fixture(scope="module")
def engines():
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96)
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    yield ref, port
    ref.shutdown()
    port.shutdown()


def test_submit_streams_token_identical_to_reference(engines):
    ref, port = engines
    outs = []
    for eng in (ref, port):
        handles = [eng.submit(p, max_new_tokens=10) for p in PROMPTS[:3]]
        res = [h.result(timeout=120) for h in handles]
        # the repeat runs after its twin finished: a prefix-cache hit
        res.append(eng.submit(PROMPTS[3], max_new_tokens=10).result(timeout=120))
        outs.append(res)
    for r, p in zip(*outs):
        assert p.tokens == r.tokens
        assert p.finish_reason == r.finish_reason
        assert p.prefix_hit_tokens == r.prefix_hit_tokens
    assert outs[1][3].prefix_hit_tokens > 0
    b = port.scheduler.batcher
    assert b.bytes_copied_per_admission() == 0.0
    assert b.adm_transfers == b.admissions == 4


def test_generate_matches_reference_and_batcher(engines):
    ref, port = engines
    for p in PROMPTS[:3]:
        solo = port.generate(p, max_new_tokens=8).tokens
        assert solo == ref.generate(p, max_new_tokens=8).tokens
        assert solo == port.submit(p, max_new_tokens=8).result(timeout=120).tokens


def test_one_packed_transfer_per_tick(engines):
    _, port = engines
    cb = ContinuousBatcher(port, slots=3, max_seq=96, prefix_pages=32)
    ticks = []
    fused = cb._fused
    cb._fused = lambda: ticks.append(1) or fused()
    done = []
    for i, p in enumerate(PROMPTS[:3]):
        cb.submit(Request(rid=str(i), prompt_ids=port.tokenizer.encode(p),
                          max_new_tokens=6, on_done=done.append))
    cb.run_until_drained()
    assert len(done) == 3 and all(len(r.output_ids) == 6 for r in done)
    assert cb.transfers == len(ticks) > 0
    assert cb.adm_transfers == 3
    assert cb.bytes_copied_per_admission() == 0.0


def test_trash_page_never_allocated_nor_read_unmasked(engines):
    """Page 0 takes every parked slot's writes and pads every table row,
    yet is never handed out, and garbage in it cannot change a token."""
    _, port = engines

    def serve(garbage):
        cb = ContinuousBatcher(port, slots=4, max_seq=96, prefix_pages=32)
        if garbage:
            for key in ("k", "v"):
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
    assert dirty == clean
    assert TRASH_PAGE not in seen
    assert TRASH_PAGE not in cb.pool._free_set and TRASH_PAGE not in cb.prefix._pids
    with pytest.raises(AssertionError, match="trash page"):
        cb.pool.free(TRASH_PAGE)


def test_free_guards(engines):
    _, port = engines
    cb = ContinuousBatcher(port, slots=2, max_seq=96, prefix_pages=32)
    pid = cb.pool.alloc()
    cb.pool.free(pid)
    with pytest.raises(AssertionError, match="double free"):
        cb.pool.free(pid)
    cb.submit(Request(rid="a", prompt_ids=port.tokenizer.encode(PROMPTS[1]),
                      max_new_tokens=4))
    cb.run_until_drained()
    tree_page = next(iter(cb.prefix._pids))       # published at finish
    with pytest.raises(AssertionError, match="release-ordering"):
        cb.pool.free(tree_page)


def test_unported_paths_refuse(engines):
    _, port = engines
    with pytest.raises(NotImplementedError, match="contiguous splice"):
        ContinuousBatcher(port, slots=2, max_seq=90, prefix_pages=32)
    with pytest.raises(NotImplementedError, match="contiguous splice"):
        ContinuousBatcher(port, slots=2, max_seq=96, prefix_pages=0)
    with pytest.raises(NotImplementedError, match="kv_dtype"):
        ContinuousBatcher(ServingEngine(port.cfg, params=port.params, max_seq=96,
                                        device="cpu", kv_dtype="int8"), slots=2)


def test_chunk_plan_and_clip_prompt_match_reference():
    for page in (4, 16):
        for n_cached in range(0, 49, page):
            for n_total in range(n_cached, 70):
                assert chunk_plan(n_cached, n_total, page) == \
                    ref_chunk_plan(n_cached, n_total, page)
    for n in (0, 1, 15, 16, 17, 60, 200):
        for max_new in (1, 8, 64, 300):
            for max_seq in (64, 96, 256):
                assert clip_prompt(list(range(n)), max_new, max_seq) == \
                    ref_clip_prompt(list(range(n)), max_new, max_seq)


def test_sampler_greedy_masks_padded_vocab():
    logits = torch.zeros(2, 64)
    logits[:, 50] = 10.0                          # beyond vocab_size: masked
    logits[0, 7], logits[1, 9] = 1.0, 2.0
    sc = SamplerConfig(vocab_size=48)
    out = sample_slots(logits, torch.Generator(), sc, np.zeros(2, np.float32),
                       np.ones(2, np.float32), np.full(2, -1), np.zeros(2, np.int32))
    assert out.tolist() == [7, 9]


def test_seeded_stream_independent_of_batch(engines):
    """Seeded slots draw from a stream keyed on (seed, step), so a seeded
    request gives the same tokens alone and next to other sessions. (Not
    the JAX package's threefry bits: parity with those streams is not
    part of this port slice.)"""
    _, port = engines
    gp = GenerationParams(max_tokens=8, temperature=0.9, seed=21)
    alone = port.submit(PROMPTS[1], params=gp).result(timeout=120).tokens
    others = [port.submit(p, max_new_tokens=8,
                          params=GenerationParams(max_tokens=8, temperature=1.0))
              for p in PROMPTS[:2]]
    mixed = port.submit(PROMPTS[1], params=gp)
    assert mixed.result(timeout=120).tokens == alone
    for h in others:
        assert len(h.result(timeout=120).tokens) == 8
