"""The encoder-decoder (whisper-medium) and vision (llama-3.2-vision-11b)
smokes served by the port against the JAX package's engine at the same
weights (the vision gates set to 0.5 in both trees). Both families carry
their cross K/V as state leaves, so the batcher takes the contiguous
splice path with a stateful prefix pool, and the engine passes no
extras: the cross blocks attend the cold cache leaves, as in the JAX
package. Held: greedy and seeded streams through the splice
``ContinuousBatcher``, ``submit``, ``generate`` and ``generate_batch``
token-identical to the reference's; a warm prefix hit token-identical to
cold prefill and to a solo run (the reference's
``test_prefix_hit_identity_every_family``); n-gram speculative serving
of the vision smoke equal to its plain stream and to the reference's,
acceptance included; ``build_system(hpc_arch=...)`` serving each family
through the gateway with the reference's HPC stream. Float32 compute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import build_system as ref_build_system  # noqa: E402
from repro.serving import ContinuousBatcher as RefBatcher  # noqa: E402
from repro.serving import GenerationParams as RefParams  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import build_system  # noqa: E402
from repro_torch.core.sse import parse_sse  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams,  # noqa: E402
                                 Request, ServingEngine)

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
ARCHS = ["whisper-medium", "llama-3.2-vision-11b"]
PROMPT = "hello cross attention world, across more than one sixteen-token page"
SEED = dict(max_tokens=8, temperature=0.9, seed=77)


def _gated(jp):
    if "cross" in jp:
        jp["cross"]["attn"]["gate"] = jnp.full_like(jp["cross"]["attn"]["gate"], 0.5)
    return jp


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    ref = RefEngine(ref_smoke(request.param).replace(**KW), max_seq=96)
    ref.params = _gated(ref.params)
    port = ServingEngine(get_smoke_config(request.param).replace(**KW), max_seq=96,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    yield ref, port
    ref.shutdown()
    port.shutdown()


def run_one(cb, engine, prompt, max_new=8, params=None, req_cls=Request):
    out = {}
    cb.submit(req_cls(rid="r", prompt_ids=engine.tokenizer.encode(prompt),
                      max_new_tokens=max_new, params=params,
                      on_done=lambda r: out.update(tokens=list(r.output_ids),
                                                   hit=r.prefix_hit_tokens)))
    cb.run_until_drained()
    return out


def _batcher(eng, cls=ContinuousBatcher, spec="off"):
    eng.speculative = spec
    try:
        cb = cls(eng, slots=2, max_seq=96, page=16, prefix_pages=24)
    finally:
        eng.speculative = "off"
    assert not cb.paged            # cross K/V are state leaves: the splice path
    return cb


def test_splice_streams_and_prefix_hits_match_reference(engines):
    """Greedy and seeded streams through the splice batcher equal the
    reference's; a repeat is a prefix hit (a state snapshot spliced from
    the pool) decoding the cold tokens, which equal a solo generate()."""
    from repro.serving.scheduler import Request as RefRequest
    ref, port = engines
    outs = []
    for eng, cls, rq, gp in ((ref, RefBatcher, RefRequest, RefParams(**SEED)),
                             (port, ContinuousBatcher, Request, GenerationParams(**SEED))):
        cb = _batcher(eng, cls)
        cold = run_one(cb, eng, PROMPT, req_cls=rq)
        warm = run_one(cb, eng, PROMPT, req_cls=rq)
        seeded = run_one(cb, eng, "seeded", params=gp, req_cls=rq)
        assert cold["hit"] == 0 and warm["hit"] > 0
        assert warm["tokens"] == cold["tokens"] == eng.generate(PROMPT, max_new_tokens=8).tokens
        outs.append((cold["tokens"], warm["hit"], seeded["tokens"]))
    assert outs[1] == outs[0]


def test_submit_generate_and_generate_batch_match_reference(engines):
    ref, port = engines
    for p in ("x", PROMPT):
        want = ref.submit(p, max_new_tokens=6).result(timeout=120).tokens
        assert port.submit(p, max_new_tokens=6).result(timeout=120).tokens == want
        assert port.generate(p, max_new_tokens=6).tokens == want
    prompts = ["a", "two words", PROMPT]
    assert port.generate_batch(prompts, max_new_tokens=5)[1] == \
        ref.generate_batch(prompts, max_new_tokens=5)[1]


def test_ngram_speculation_on_vision_equals_plain_and_reference():
    """The vision smoke has the verify_chunk contract, so the splice
    batcher runs n-gram verify ticks (the cross blocks inside the window);
    its greedy stream equals plain decode and the reference's speculative
    stream, acceptance counts included."""
    from repro.serving.scheduler import Request as RefRequest
    arch = "llama-3.2-vision-11b"
    ref = RefEngine(ref_smoke(arch).replace(**KW), max_seq=96)
    ref.params = _gated(ref.params)
    port = ServingEngine(get_smoke_config(arch).replace(**KW), max_seq=96, device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref.params)))
    prompt = "the cat sat on the mat; the cat sat on the mat; the cat"
    plain = run_one(_batcher(port), port, prompt, max_new=12)["tokens"]
    stats = []
    for eng, cls, rq in ((ref, RefBatcher, RefRequest), (port, ContinuousBatcher, Request)):
        cb = _batcher(eng, cls, spec="ngram")
        assert cb.spec_mode == "ngram"
        assert run_one(cb, eng, prompt, max_new=12, req_cls=rq)["tokens"] == plain
        s = cb.spec_stats
        stats.append((s.proposed, s.accepted, s.spec_ticks, s.plain_ticks))
    assert stats[0] == stats[1] and stats[1][2] > 0
    ref.shutdown()
    port.shutdown()


@pytest.mark.parametrize("arch", ARCHS)
def test_build_system_serves_the_family_like_reference(arch):
    """build_system(hpc_arch=...) on the CPU: the HPC tier's greedy stream
    equals the reference system's at the same weights, and the gateway
    serves a stream-hpc request from that tier."""
    kw = dict(dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0, local_arch="minitron-8b",
              hpc_arch=arch, hpc_overrides={"compute_dtype": "float32"},
              local_overrides={"compute_dtype": "float32"})
    ref, port = ref_build_system(**kw), build_system(device="cpu", **kw)
    try:
        port.engines["hpc"].params = params_from_numpy(
            jax.tree.map(np.asarray, ref.engines["hpc"].params))
        msgs = [{"role": "user", "content": "Explain the dual-channel relay in depth."}]
        streams = []
        for s in (ref, port):
            ids = []
            res = s.backends["hpc"].stream(msgs, max_tokens=8,
                                           on_token=lambda t, _: ids.append(t))
            assert res.streamed and res.n_completion_tokens == len(ids)
            streams.append(ids)
        assert streams[1] == streams[0] and len(streams[0]) == 8
        tok = port.globus.issue_token("port@uic.edu")
        resp = port.gateway.handle_chat_completions(
            {"model": "stream-hpc", "messages": msgs, "max_tokens": 4, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=tok)
        chunks = parse_sse("".join(resp.stream))
        assert resp.status == 200 and resp.headers["x-stream-tier"] == "hpc"
        assert chunks[-1]["usage"]["completion_tokens"] == 4
        assert type(port.engines["hpc"].model).__name__ == (
            "EncDecLM" if arch == "whisper-medium" else "TransformerLM")
    finally:
        for s in (ref, port):
            for e in s.engines.values():
                e.shutdown()
            s.endpoint.shutdown()
