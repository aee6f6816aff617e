"""The MoE family served by the port (ServingEngine -> ContinuousBatcher,
paged and contiguous) against its own plain paths and against the JAX
package's engine at the same weights, with deepseek-v2-lite's smoke
config (MLA latent pools, a dense first block, MoE blocks) as the HPC
engine: paged tokens identical to the contiguous splice path (greedy and
seeded), streams identical to the reference engine's, a prefix hit
identical to cold prefill, int8 / fp8 latent pools (the logit error
bound, a shrunk pool, int8 streams equal to the reference's), the MoE
tree's W4A16 quantization, and ``build_system`` serving both MoE configs
through the gateway. The JAX package's ``tests/test_paged_serving.py``
and ``test_prefix_cache.py`` hold the same cases for its MLA member;
speculation and rolling windows over MLA are in
``tests/test_torch_moe_speculative.py``. Float32 compute.
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, GenerationParams,  # noqa: E402
                                 PagePool, Request, ServingEngine)

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


def test_paged_token_identical_to_contiguous(engines):
    """Paged decode over the latent pool produces the tokens of the
    contiguous splice path, greedy and seeded; the paged path copies no
    byte per admission."""
    _, port = engines
    outs = {}
    for paged in (True, False):
        cb = _batcher(port, paged)
        outs[paged] = (run_one(cb, port, PROMPT)["tokens"],
                       run_one(cb, port, "seeded", params=SEEDED)["tokens"])
        if paged:
            assert cb.bytes_copied_per_admission() == 0.0
            assert {"c_kv", "k_rope", "dense0_ckv", "dense0_krope"} <= set(cb.cache)
    assert outs[True] == outs[False]
    assert len(outs[True][0]) == 8


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_streams_match_reference_engine(engines, paged):
    ref, port = engines
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        cb = _batcher(eng, paged, cls)
        outs.append((run_one(cb, eng, PROMPT)["tokens"],
                     run_one(cb, eng, "seeded", params=SEEDED)["tokens"]))
    assert outs[0] == outs[1]


def test_submit_and_generate_match_reference(engines):
    """Through the broker (submit) and generate(), as the gateway serves."""
    ref, port = engines
    for p in ("x", PROMPT):
        want = ref.submit(p, max_new_tokens=6).result(timeout=120).tokens
        assert port.submit(p, max_new_tokens=6).result(timeout=120).tokens == want
        assert port.generate(p, max_new_tokens=6).tokens == want


def test_prefix_hit_identical_to_cold_prefill(engines):
    _, port = engines
    solo = port.generate(PROMPT, max_new_tokens=5).tokens
    cb = _batcher(port)
    cold = run_one(cb, port, PROMPT, max_new=5)
    warm = run_one(cb, port, PROMPT, max_new=5)
    assert cold["tokens"] == warm["tokens"] == solo
    assert warm["hit"] > 0 and cold["hit"] == 0


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quantized_logit_error_bounded(engines, kv):
    """Teacher-forced chunked prefill through a quantized latent pool keeps
    every logit within 0.25 of the float32 pool's (the reference's bound),
    and the pool is at most 0.55 of the float32 pool's bytes."""
    _, port = engines
    model, params = port.model, port.params
    ids = [104, 101, 108, 108, 111, 32] * 10 + list(range(2, 12))

    def paged_logits(dt):
        pool = PagePool(model, page=16, capacity=64, kv_dtype=dt)
        cache = pool.paged_cache(1, 6)
        pids = [pool.alloc() for _ in range(6)]
        cache["block_tables"] = torch.tensor([pids], dtype=torch.int32)
        out, pos = [], 0
        with torch.no_grad():
            while pos < len(ids):
                chunk = ids[pos:pos + 16]
                cache["pos"] = pos
                logits, cache = model.prefill_chunk(params, torch.tensor([chunk]), cache)
                pos += len(chunk)
                out.append(logits[0].numpy())
        return np.stack(out), pool.pool_bytes

    q, qb = paged_logits(kv)
    f, fb = paged_logits("fp32")
    assert np.abs(q - f).max() < 0.25
    assert qb < 0.55 * fb


def test_fp8_pages_decode_to_completion(engines):
    _, port = engines
    port.kv_dtype = "fp8_e4m3"
    try:
        runs = [run_one(_batcher(port), port, PROMPT)["tokens"] for _ in range(2)]
    finally:
        port.kv_dtype = "fp32"
    assert runs[0] == runs[1] and len(runs[0]) == 8
    assert all(0 <= t < 300 for t in runs[0])


def test_int8_streams_match_reference():
    """int8 latent pools with W4A16 weights (group 64): the reference's
    quantized tree carried over, greedy and seeded streams equal."""
    from repro.serving import quantize as jquant
    jp = jquant.quantize_mlp_tree(
        ref_build(ref_smoke(ARCH).replace(**KW)).init(jax.random.PRNGKey(0)), group_size=64)
    ref = RefEngine(ref_smoke(ARCH).replace(**KW), max_seq=96, kv_dtype="int8", params=jp)
    port = ServingEngine(_cfg(), max_seq=96, kv_dtype="int8", device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    assert "qw" in port.params["dense0"]["mlp"]["w1"]
    assert "qw" in port.params["blocks"]["mlp"]["shared"]["w2"]
    assert "qw" in port.params["blocks"]["attn"]["wo"]
    assert torch.is_tensor(port.params["blocks"]["mlp"]["w1"])        # experts stay dense
    outs = []
    for eng, cls in ((ref, RefBatcher), (port, ContinuousBatcher)):
        cb = _batcher(eng, True, cls)
        outs.append((run_one(cb, eng, PROMPT)["tokens"],
                     run_one(cb, eng, "seeded", params=SEEDED)["tokens"]))
        if cls is ContinuousBatcher:
            assert cb.bytes_copied_per_admission() == 0.0
            assert cb.cache["c_kv"].dtype == torch.int8 and "c_kv_qscale" in cb.cache
    assert outs[0] == outs[1]
    ref.shutdown()
    port.shutdown()


@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
def test_build_system_serves_the_moe_family(arch):
    """build_system(hpc_arch=...) on the CPU answers a stream-hpc request
    through the gateway with the MoE model on the HPC tier."""
    from repro_torch.core import build_system
    from repro_torch.core.sse import parse_sse
    from repro_torch.models.lm import TransformerLM
    sys_ = build_system(device="cpu", hpc_arch=arch, dispatch_latency_s=0.0)
    try:
        hpc = sys_.engines["hpc"]
        assert isinstance(hpc.model, TransformerLM) and hpc.cfg.n_experts > 0
        token = sys_.globus.issue_token("tester@uic.edu")
        resp = sys_.gateway.handle_chat_completions(
            {"model": "stream-hpc", "messages": [{"role": "user", "content": "hi there"}],
             "max_tokens": 5, "stream": True, "stream_options": {"include_usage": True}},
            bearer=token)
        assert resp.status == 200 and resp.headers["x-stream-tier"] == "hpc"
        chunks = parse_sse("".join(resp.stream))
        assert chunks[-1]["usage"]["completion_tokens"] == 5
    finally:
        for e in sys_.engines.values():
            e.shutdown()
        sys_.endpoint.shutdown()
        sys_.gateway.shutdown()


def test_moe_params_quantize_as_the_reference():
    """quantize_mlp_tree over the MoE tree: the stacked experts (L, E, D, F)
    stay dense; ``shared``, ``dense0/mlp`` and MLA's ``wo`` quantize at
    group 64, as the reference's; dense0's w2 (K = 160 at smoke) is
    planned by awq_matmul.splits whatever its group count."""
    from repro.serving import quantize as jquant
    from repro_torch.kernels import awq_matmul
    from repro_torch.models.common import flatten
    from repro_torch.serving.quantize import quantize_mlp_tree
    jp = ref_build(ref_smoke(ARCH).replace(**KW)).init(jax.random.PRNGKey(0))
    jq = jquant.quantize_mlp_tree(jp, group_size=64)
    tq = quantize_mlp_tree(params_from_numpy(jax.tree.map(np.asarray, jp)), group_size=64)
    ref = dict(flatten(jax.tree.map(np.asarray, jq)))
    got = dict(flatten(tq))
    assert set(got) == set(ref)
    for path, a in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), a, err_msg="/".join(path))
    # the full width's dense0 w2: K = 10944 is 171 groups of 64
    plan = awq_matmul.splits(8, 10944, 2048, 64, 132)
    assert plan.n_split * plan.groups_per_split >= 171 > (plan.n_split - 1) * plan.groups_per_split
