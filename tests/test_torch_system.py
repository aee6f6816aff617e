"""The port's ``build_system`` on the CPU: the OpenAI gateway serves
``stream-hpc`` through the control plane and the encrypted relay, and
``stream-auto`` through the judge; the relay never carries plaintext;
and with the reference's weights swapped in before the first request,
the HPC tier's greedy stream equals the JAX package's ``build_system``.
Smoke configs at float32 compute on both tiers.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import build_system as ref_build_system  # noqa: E402
from repro_torch.core import build_system  # noqa: E402
from repro_torch.core.relay import ProducerConn  # noqa: E402
from repro_torch.core.sse import parse_sse  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

F32 = {"compute_dtype": "float32"}
KW = dict(dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0,
          local_arch="minitron-8b", hpc_overrides=F32, local_overrides=F32)


@pytest.fixture(scope="module")
def systems():
    ref = ref_build_system(**KW)
    port = build_system(device="cpu", **KW)
    for tier in ("hpc", "local"):
        port.engines[tier].params = params_from_numpy(
            jax.tree.map(np.asarray, ref.engines[tier].params))
    yield ref, port
    for s in (ref, port):
        for e in s.engines.values():
            e.shutdown()
        s.endpoint.shutdown()


def _chat(system, alias, content, max_tokens=6):
    tok = system.globus.issue_token("port@uic.edu")
    resp = system.gateway.handle_chat_completions(
        {"model": alias, "messages": [{"role": "user", "content": content}],
         "max_tokens": max_tokens, "stream": True,
         "stream_options": {"include_usage": True}}, bearer=tok)
    assert resp.status == 200
    return resp, parse_sse("".join(resp.stream))


def test_hpc_tier_greedy_stream_equals_reference(systems):
    ref, port = systems
    msgs = [{"role": "user", "content": "Explain the dual-channel relay in depth."}]
    streams = []
    for s in (ref, port):
        ids = []
        res = s.backends["hpc"].stream(msgs, max_tokens=12,
                                       on_token=lambda t, _: ids.append(t))
        assert res.streamed and res.n_completion_tokens == len(ids)
        streams.append(ids)
    assert streams[1] == streams[0] and len(streams[0]) == 12


def test_hpc_tier_greedy_stream_equals_reference_quantized():
    """The paper's quantized HPC tier: int8 KV pages and W4A16 weights
    (group 64) on both tiers; with the reference's quantized weights
    swapped in, the HPC tier's greedy stream equals the reference's."""
    kw = dict(KW, kv_dtype="int8", quantize_mlp=True)
    ref = ref_build_system(**kw)
    port = build_system(device="cpu", **kw)
    try:
        hpc = port.engines["hpc"]
        assert hpc.params["blocks"]["mlp"]["w1"]["qw"].dtype == torch.int32
        hpc.params = params_from_numpy(jax.tree.map(np.asarray, ref.engines["hpc"].params))
        msgs = [{"role": "user", "content": "Explain the dual-channel relay in depth."}]
        streams = []
        for s in (ref, port):
            ids = []
            res = s.backends["hpc"].stream(msgs, max_tokens=12,
                                           on_token=lambda t, _: ids.append(t))
            assert res.streamed and res.n_completion_tokens == len(ids)
            streams.append(ids)
        assert streams[1] == streams[0] and len(streams[0]) == 12
        assert hpc.scheduler.batcher.cache["k"].dtype == torch.int8
    finally:
        for s in (ref, port):
            for e in s.engines.values():
                e.shutdown()
            s.endpoint.shutdown()


@pytest.mark.parametrize("alias,tier", [("stream-hpc", "hpc"), ("stream-auto", "local")])
def test_gateway_serves_alias(systems, alias, tier):
    _, port = systems
    resp, chunks = _chat(port, alias, "What is the capital of France?")
    assert resp.headers["x-stream-tier"] == tier
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    usage = chunks[-1]
    assert usage["choices"] == [] and usage["usage"]["completion_tokens"] == 6
    assert usage["stream"]["tier"] == tier
    frames = [c for c in chunks if c.get("choices")
              and c["choices"][0].get("finish_reason") is None]
    assert len(frames) - 1 == 6


def test_relay_never_sees_plaintext(systems, monkeypatch):
    _, port = systems
    seen = []
    send = ProducerConn.send
    monkeypatch.setattr(ProducerConn, "send",
                        lambda self, m: seen.append(dict(m)) or send(self, m))
    secret = "PLAINTEXT_CANARY_QUERY"
    _, chunks = _chat(port, "stream-hpc", secret)
    assert seen and all(m.get("enc") is True and set(m) == {"enc", "nonce", "data"}
                        for m in seen)
    blob = json.dumps(seen) + json.dumps(port.relay.access_log)
    assert secret not in blob and '"token"' not in blob


def test_unported_options_refuse():
    # W4A16 on the encoder-decoder: its cross-attention output projection
    # is a dense matmul in the JAX package (which fails on a quantized one)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_system(device="cpu", hpc_arch="whisper-medium", quantize_mlp=True)
    with pytest.raises(ValueError, match="kv_dtype must be one of"):
        build_system(device="cpu", kv_dtype="int4")


def test_feature_judge_trains_like_reference():
    """FeatureJudge.train runs on PyTorch in the port; from its own random
    init it reaches the reference's fit and the same decisions."""
    from repro.core.judge import FeatureJudge as RefJudge
    from repro_torch.core.judge import FeatureJudge

    texts = (["what is X?"] * 20
             + ["explain and compare the trade-offs of algorithm design choices"] * 20
             + ["prove this novel theorem about frontier research open problem"] * 20)
    labels = [0] * 20 + [1] * 20 + [2] * 20
    judge, loss = FeatureJudge.train(texts, labels, steps=200)
    ref, ref_loss = RefJudge.train(texts, labels, steps=200)
    assert judge.w.shape == ref.w.shape and judge.w.dtype == np.float32
    assert loss < 1.0 and abs(loss - ref_loss) < 0.05
    for t in set(texts) | {"what is Y?"}:
        assert judge.judge(t)[0] == ref.judge(t)[0]
