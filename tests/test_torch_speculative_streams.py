"""Port's speculative serving streams against the JAX package's, at the
same weights: n-gram drafting (greedy and seeded) and forced 100% / 0% /
mid-window acceptance over float32 pages, int8 pages with W4A16 weights
and the contiguous path; the cross-tier model drafter; and
``build_system(speculative=True)`` beside the default xLSTM local tier
(n-gram drafts) and a dense one (model drafting). Tokens and
acceptance counts must be identical. Smoke configs at float32 compute.
(The port-only cases and the kernel-level parity are in
``tests/test_torch_speculative.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving import ContinuousBatcher as RefBatcher  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro.serving import quantize as jquant  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams,  # noqa: E402
                                 Request, ServingEngine)

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PROMPT = "speculative parity prompt"
SEEDED = GenerationParams(max_tokens=12, temperature=0.9, seed=42)


def run_one(cb, engine, prompt, max_new=12, params=None):
    req = Request(rid="r", prompt_ids=engine.tokenizer.encode(prompt),
                  max_new_tokens=max_new, params=params)
    cb.submit(req)
    cb.run_until_drained()
    assert req.done, req
    return req.output_ids


def replay_hook(ref, k, at=None):
    """Drafts that replay the plain run's continuation, with position
    ``at`` flipped (``"all"``: every one; None: none)."""
    def hook(slot, req):
        pos = len(req.output_ids)
        d = list(ref[pos:pos + k])
        for i in range(len(d)):
            if at == "all" or i == at:
                d[i] = (d[i] + 1) % 300
        return d
    return hook


def _batcher(eng, mode="off", cls=ContinuousBatcher):
    eng.speculative = mode
    cb = cls(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
    eng.speculative = "off"
    return cb


@pytest.fixture(scope="module", params=[(True, "fp32"), (False, "fp32"), (True, "int8")],
                ids=["paged-fp32", "contig-fp32", "paged-int8-w4a16"])
def pair(request):
    paged, kv = request.param
    jp = ref_build(ref_smoke("minitron-8b").replace(**KW)).init(jax.random.PRNGKey(0))
    if kv != "fp32":
        jp = jquant.quantize_mlp_tree(jp, group_size=64)
    ref = RefEngine(ref_smoke("minitron-8b").replace(**KW), max_seq=96, paged_kv=paged,
                    kv_dtype=kv, params=jp)
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         paged_kv=paged, kv_dtype=kv, device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    yield ref, port
    ref.shutdown()
    port.shutdown()


def test_speculative_streams_match_reference(pair):
    """n-gram drafting (greedy and seeded) and forced 100% / 0% / mid-window
    acceptance: the port's speculative streams equal the reference
    engine's speculative streams and the plain stream, tick for tick in
    acceptance."""
    ref, port = pair
    plain = run_one(_batcher(port), port, PROMPT)
    seeded = run_one(_batcher(port), port, "seeded spec", params=SEEDED)
    cases = [("ngram", PROMPT, None, None, plain), ("ngram", "seeded spec", SEEDED, None,
                                                    seeded),
             ("full", PROMPT, None, lambda k: replay_hook(plain, k), plain),
             ("zero", PROMPT, None, lambda k: replay_hook(plain, k, "all"), plain),
             ("mid", PROMPT, None, lambda k: replay_hook(plain, k, 2), plain)]
    for name, prompt, params, hook, want in cases:
        stats = []
        for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
            cb = _batcher(eng, "ngram", cls=cls)
            assert cb.spec_mode == "ngram"
            if hook is not None:
                cb.draft_hook = hook(cb.spec_k)
            assert run_one(cb, eng, prompt, params=params) == want, name
            s = cb.spec_stats
            stats.append((s.proposed, s.accepted, s.emitted, s.spec_ticks, s.plain_ticks))
        assert stats[0] == stats[1], name


def test_model_drafter_streams_match_reference():
    """The cross-tier pairing (gemma smoke drafting for minitron smoke) at
    the reference's weights: the same tokens and acceptance counts."""
    big, small = ref_smoke("minitron-8b").replace(**KW), ref_smoke("gemma-7b").replace(**KW)
    jp = ref_build(big).init(jax.random.PRNGKey(0))
    jd = ref_build(small).init(jax.random.PRNGKey(1))
    ref = RefEngine(big, max_seq=96, params=jp, drafter_cfg=small, drafter_params=jd)
    port = ServingEngine(get_smoke_config("minitron-8b").replace(**KW), max_seq=96,
                         device="cpu", params=params_from_numpy(jax.tree.map(np.asarray, jp)),
                         drafter_cfg=get_smoke_config("gemma-7b").replace(**KW),
                         drafter_params=params_from_numpy(jax.tree.map(np.asarray, jd)))
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        cb = cls(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
        assert cb.spec_mode == "model"
        toks = run_one(cb, eng, "cross tier drafting", max_new=16)
        s = cb.spec_stats
        outs.append((toks, s.proposed, s.accepted, s.spec_ticks))
    assert outs[0] == outs[1]
    ref.shutdown()
    port.shutdown()


def test_build_system_speculative_like_reference():
    """build_system(speculative=True): with the default xLSTM local tier the
    HPC tier drafts by n-grams and the local tier runs plain decode; with
    a dense local tier the HPC tier drafts with the local model. With the
    reference's weights the HPC stream equals the reference system's."""
    from repro.core import build_system as ref_build_system
    from repro_torch.core import build_system

    f32 = {"compute_dtype": "float32"}
    kw = dict(dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0, prefix_cache_pages=16,
              hpc_overrides=f32, local_overrides=f32, speculative=True, spec_k=4)
    msgs = [{"role": "user", "content": "Explain the dual-channel relay, the relay, "
                                        "the relay in depth."}]
    for local_arch, mode in (("xlstm-125m", "ngram"), ("minitron-8b", "model")):
        ref_s = ref_build_system(local_arch=local_arch, **kw)
        port = build_system(device="cpu", local_arch=local_arch, **kw)
        try:
            for tier in ("hpc", "local"):
                port.engines[tier].params = params_from_numpy(
                    jax.tree.map(np.asarray, ref_s.engines[tier].params))
            if mode == "model":
                port.engines["hpc"].drafter.params = port.engines["local"].params
            streams = []
            for s in (ref_s, port):
                ids = []
                s.backends["hpc"].stream(msgs, max_tokens=12,
                                         on_token=lambda t, _: ids.append(t))
                streams.append(ids)
            assert streams[0] == streams[1] and len(streams[1]) > 0
            hb = port.engines["hpc"].scheduler.batcher
            assert hb.spec_mode == mode and hb.spec_stats.spec_ticks > 0
            port.engines["local"].generate("hi", max_new_tokens=2)
            lb = port.engines["local"]._get_broker().batcher
            assert lb.spec_mode == ("off" if local_arch == "xlstm-125m" else "ngram")
        finally:
            for s in (ref_s, port):
                for e in s.engines.values():
                    e.shutdown()
                s.endpoint.shutdown()
