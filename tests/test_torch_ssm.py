"""Port's Mamba-2 SSD scan and hybrid zamba2 model against the JAX
package, with the reference's weights carried over by
``interop.params_from_numpy``; inputs from a numpy seed.

Tolerances, float32 throughout:
  * SSD scan: max abs error <= 1e-5 * max(1, max |reference|). The port
    runs the chunk-to-chunk recurrence in order, the JAX package as an
    associative scan, and both sum the decay through cumsum differences:
    equal up to rounding (observed ~2e-7 relative).
  * model logits: max abs error <= 1e-4, as for the dense model.
Greedy serving streams must be token-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssm_scan as jscan  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import _layer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.pagepool import chunk_plan  # noqa: E402

SSD_REL = 1e-5
ATOL = 1e-4
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PAGE, MAX_SEQ = 16, 64


def _ssd_inputs(seed, b, T, H, P, N, h0=False, pad=0):
    """SSD inputs as numpy; the last ``pad`` steps are padding (dt = 0)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, T, H, P)).astype(np.float32)
    dt = r.uniform(1e-3, 0.2, (b, T, H)).astype(np.float32)
    if pad:
        x[:, T - pad:] = dt[:, T - pad:] = 0.0
    A = -r.uniform(1.0, 16.0, H).astype(np.float32)
    B = r.standard_normal((b, T, N)).astype(np.float32)
    C = r.standard_normal((b, T, N)).astype(np.float32)
    D = r.standard_normal(H).astype(np.float32)
    hh = r.standard_normal((b, H, P, N)).astype(np.float32) if h0 else None
    return x, dt, A, B, C, D, hh


def _ssd_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= SSD_REL * max(1.0, np.abs(want).max()), err


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,chunk,h0,pad", [
    (16, 16, False, 0), (16, 16, True, 0),           # one chunk
    (64, 16, False, 0), (64, 16, True, 0),           # several chunks, state carried
    (48, 16, True, 11),                              # a padded piece (dt = 0 tail)
    (48, 16, True, 16),                              # a whole chunk of padding
    (256, 256, True, 224),                           # the full config's chunk, 32-token piece
])
def test_ssd_matches_reference(T, chunk, h0, pad):
    x, dt, A, B, C, D, hh = _ssd_inputs(T + chunk, 2, T, 3, 16, 16, h0, pad)
    yj, hj = jref.ssd(x, dt, A, B, C, D, chunk=chunk, h0=hh)
    y, h = ref.ssd(*_torch(x, dt, A, B, C, D), chunk=chunk,
                   h0=None if hh is None else torch.from_numpy(hh))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _ssd_close(y, yj)
    _ssd_close(h, hj)
    if pad:
        # what the padded steps hold leaves the state and the live y alone
        r = np.random.default_rng(T + pad)
        x2, B2, C2 = x.copy(), B.copy(), C.copy()
        for a in (x2, B2, C2):
            a[:, T - pad:] = r.standard_normal(a[:, T - pad:].shape)
        y2, h2 = ref.ssd(*_torch(x2, dt, A, B2, C2, D), chunk=chunk,
                         h0=torch.from_numpy(hh))
        torch.testing.assert_close(h2, h, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(y2[:, :T - pad], y[:, :T - pad], atol=1e-6, rtol=1e-6)
        n = T - pad
        if n % chunk == 0:
            # padding leaves the state where the unpadded steps left it
            _, h_un = ref.ssd(*_torch(x[:, :n], dt[:, :n], A, B[:, :n], C[:, :n], D),
                              chunk=chunk, h0=torch.from_numpy(hh))
            torch.testing.assert_close(h, h_un, atol=1e-6, rtol=1e-6)


def test_segsum_matches_reference():
    logd = -np.random.default_rng(3).uniform(0, 1, (2, 3, 16)).astype(np.float32)
    got = ref._segsum(torch.from_numpy(logd)).numpy()
    want = np.asarray(jref._segsum(logd))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    # cumsum rounding: a few ulps of the largest partial sum
    np.testing.assert_allclose(got[fin], want[fin],
                               atol=SSD_REL * np.abs(want[fin]).max(), rtol=0)


def test_ssd_matches_reference_pallas_kernel_interpreted():
    """The JAX package's Pallas kernel (interpret mode; it takes no h0)
    against the port's plain version, which the Hopper kernel follows."""
    x, dt, A, B, C, D, _ = _ssd_inputs(5, 1, 32, 2, 16, 16)
    yk, hk = jscan.ssd(x, dt, A, B, C, D, chunk=16, interpret=True)
    y, h = ops.ssd(*_torch(x, dt, A, B, C, D), chunk=16)
    _ssd_close(y, yk)
    _ssd_close(h, hk)


def test_ssd_step_matches_scan_and_reference():
    """Stepping token by token with ssd_step equals the chunked scan, and
    each step equals the JAX package's ssd_step."""
    x, dt, A, B, C, D, hh = _ssd_inputs(7, 2, 32, 3, 16, 16, h0=True)
    y_scan, h_scan = ref.ssd(*_torch(x, dt, A, B, C, D), chunk=16,
                             h0=torch.from_numpy(hh))
    h, hj = torch.from_numpy(hh), hh
    for t in range(32):
        yt, h = ops.ssd_step(*_torch(x[:, t], dt[:, t], A, B[:, t], C[:, t], D), h)
        yj, hj = jref.ssd_step(x[:, t], dt[:, t], A, B[:, t], C[:, t], D, hj)
        _ssd_close(yt, yj)
        _ssd_close(yt, y_scan[:, t].numpy())
    _ssd_close(h, hj)
    _ssd_close(h, h_scan.numpy())


def test_ssd_wrapper_refuses_other_devices():
    """Meta tensors take the plain version (nothing runs); a device that
    is neither the CPU, meta nor CUDA raises."""
    from _torch_elsewhere import Elsewhere
    x, dt, A, B, C, D, _ = _torch(*_ssd_inputs(1, 1, 16, 2, 16, 16))
    y, h = ops.ssd(*(t.to("meta") for t in (x, dt, A, B, C, D)), chunk=16)
    assert y.device.type == "meta" and y.shape == x.shape
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(Elsewhere(x), dt, A, B, C, D, chunk=16)


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke("zamba2-7b").replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_smoke_config("zamba2-7b").replace(**KW))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, pm, pp


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def test_configs_match_reference_field_for_field():
    for port, refc in ((get_config("zamba2-7b"), ref_full("zamba2-7b")),
                       (get_smoke_config("zamba2-7b"), ref_smoke("zamba2-7b"))):
        for f in refc.__dataclass_fields__:
            assert getattr(port, f) == getattr(refc, f), f


def test_param_tree_layout_matches_reference(models):
    """Key paths and shapes equal the JAX tree's, including the (L, H)
    A_log / dt_bias / D leaves and out_norm; the ssm init kinds draw in
    their ranges on the port."""
    jm, jp, pm, pp = models
    want = {path: tuple(a.shape) for path, a in flatten(jax.tree.map(np.asarray, jp))}
    assert {path: d.shape for path, d in flatten(pm.param_defs())} == want
    assert {path: tuple(t.shape) for path, t in flatten(pp)} == want
    for key in ("A_log", "dt_bias", "D", "out_norm"):
        assert np.array_equal(pp["blocks"][key].numpy(), np.asarray(jp["blocks"][key]))
    own = pm.init(seed=1, device="cpu")["blocks"]
    a = torch.exp(own["A_log"])
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())


@pytest.mark.parametrize("branch", ["decode", "continuation", "from_zero"])
def test_mamba2_block_matches_reference(models, branch):
    jm, jp, pm, pp = models
    cfg, jcfg = pm.cfg, jm.cfg
    r = np.random.default_rng(11)
    T = 1 if branch == "decode" else 21
    x = r.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    conv = r.standard_normal((2, cfg.ssm_conv_kernel - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)).astype(np.float32)
    st = r.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state)).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[2], jp["blocks"])
    bp = _layer(pp["blocks"], 2)
    if branch == "decode":
        kw = dict(conv_state=conv, ssm_state=st)
        pkw = dict(conv_state=torch.from_numpy(conv), ssm_state=torch.from_numpy(st))
    elif branch == "continuation":
        kw = dict(chunk_states=(conv, st))
        pkw = dict(chunk_states=(torch.from_numpy(conv), torch.from_numpy(st)))
    else:       # the conv-state sentinel asks for the prefill conv state too
        kw = dict(conv_state=jnp.zeros(()))
        pkw = dict(conv_state=torch.zeros(()))
    jy, jc, js = jssm.mamba2_block(jnp.asarray(x), jbp, jcfg, **kw)
    with torch.inference_mode():
        y, c, s = ssm.mamba2_block(torch.from_numpy(x), bp, cfg, **pkw)
    close(y, jy, 1e-5)
    close(c, jc, 1e-5)
    close(s, js, 1e-5)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 259, size=n).tolist()


def test_prefill_chunks_and_decode_match_reference(models):
    """Logits at every prefill piece (16 + 16 + 4 + 1 tokens: the SSD
    continuation carries the state across pieces, short pieces pad to a
    chunk) and every decode step; the caches stay written in place."""
    jm, jp, pm, pp = models
    ids = _prompt(0, 37)
    jc, pc = jm.init_cache(1, MAX_SEQ), pm.init_cache(1, MAX_SEQ, device="cpu")
    ssm_ptr = pc["ssm"].data_ptr()
    off = 0
    for n in chunk_plan(0, len(ids), PAGE):
        jl, jc = jm.prefill_chunk(jp, jnp.asarray([ids[off:off + n]]), jc)
        with torch.inference_mode():
            pl, pc = pm.prefill_chunk(pp, torch.tensor([ids[off:off + n]]), pc)
        close(pl, jl)
        off += n
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        close(pc[key], jc[key], 1e-5)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jnp.asarray([[tok]]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.tensor([[tok]]), pc)
        close(pl, jl)
        tok = int(np.argmax(np.asarray(jl)[0]))
    assert pc["pos"] == int(jc["pos"]) == 42
    assert pc["ssm"].data_ptr() == ssm_ptr


def test_decode_with_per_slot_positions_matches_reference(models):
    """Two slots at different positions decode together through a (B,)
    pos, as the contiguous batcher runs them."""
    jm, jp, pm, pp = models
    prompts = [_prompt(1, 21), _prompt(2, 7)]
    jcs, pcs, toks = [], [], []
    for ids in prompts:
        jc, pc = jm.init_cache(1, MAX_SEQ), pm.init_cache(1, MAX_SEQ, device="cpu")
        off = 0
        for n in chunk_plan(0, len(ids), PAGE):
            jl, jc = jm.prefill_chunk(jp, jnp.asarray([ids[off:off + n]]), jc)
            with torch.inference_mode():
                _, pc = pm.prefill_chunk(pp, torch.tensor([ids[off:off + n]]), pc)
            off += n
        jcs.append(jc)
        pcs.append(pc)
        toks.append(int(np.argmax(np.asarray(jl)[0])))
    keys = ("conv", "ssm", "attn_k", "attn_v")
    jc = {k: jnp.concatenate([c[k] for c in jcs], axis=1) for k in keys}
    jc["pos"] = jnp.asarray([len(p) for p in prompts], jnp.int32)
    pc = {k: torch.cat([c[k] for c in pcs], dim=1) for k in keys}
    pc["pos"] = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    tok = np.asarray(toks)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok[:, None]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.from_numpy(tok[:, None]).long(), pc)
        close(pl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1)
    assert pc["pos"].tolist() == [25, 11]


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines():
    ref_e = RefEngine(ref_smoke("zamba2-7b").replace(**KW), max_seq=96)
    port = ServingEngine(get_smoke_config("zamba2-7b").replace(**KW), max_seq=96,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref_e.params)))
    yield ref_e, port
    ref_e.shutdown()
    port.shutdown()


PROMPTS = ["hello hybrid world", "a prompt that runs past one sixteen-token page, "
           "and then some more", "x"]


def test_generate_matches_reference(engines):
    ref_e, port = engines
    for p in PROMPTS:
        assert port.generate(p, max_new_tokens=8).tokens == \
            ref_e.generate(p, max_new_tokens=8).tokens


def test_submit_streams_match_reference(engines):
    """ServingEngine.submit -> broker -> the contiguous splice batcher,
    against the reference's, with a prefix hit on the repeat."""
    ref_e, port = engines
    outs = []
    for eng in (ref_e, port):
        res = [h.result(timeout=120) for h in
               [eng.submit(p, max_new_tokens=8) for p in PROMPTS]]
        res.append(eng.submit(PROMPTS[1], max_new_tokens=8).result(timeout=120))
        outs.append(res)
    for r, p in zip(*outs):
        assert p.tokens == r.tokens
        assert p.prefix_hit_tokens == r.prefix_hit_tokens
    assert outs[1][3].prefix_hit_tokens > 0
    b = port.scheduler.batcher
    assert not b.paged and b.pool.stateful
    assert b.bytes_copied_per_admission() == \
        ref_e.scheduler.batcher.bytes_copied_per_admission() > 0


def test_build_system_serves_zamba2_hpc_tier_like_reference():
    """build_system(hpc_arch="zamba2-7b"): the HPC tier's greedy stream
    through the control plane and relay equals the JAX package's with
    the same weights, and the gateway serves stream-hpc from it over the
    contiguous splice path."""
    from repro.core import build_system as ref_build_system
    from repro_torch.core import build_system
    from repro_torch.core.sse import parse_sse

    f32 = {"compute_dtype": "float32"}
    kw = dict(dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0,
              local_arch="minitron-8b", hpc_arch="zamba2-7b", prefix_cache_pages=16,
              hpc_overrides=f32, local_overrides=f32)
    ref_s, port = ref_build_system(**kw), build_system(device="cpu", **kw)
    try:
        port.engines["hpc"].params = params_from_numpy(
            jax.tree.map(np.asarray, ref_s.engines["hpc"].params))
        msgs = [{"role": "user", "content": "Explain the dual-channel relay in depth."}]
        streams = []
        for s in (ref_s, port):
            ids = []
            res = s.backends["hpc"].stream(msgs, max_tokens=8,
                                           on_token=lambda t, _: ids.append(t))
            assert res.streamed and len(ids) == res.n_completion_tokens > 0
            streams.append(ids)
        assert streams[0] == streams[1]
        token = port.globus.issue_token("port@uic.edu")
        resp = port.gateway.handle_chat_completions(
            {"model": "stream-hpc", "messages": msgs, "max_tokens": 6, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=token)
        chunks = parse_sse("".join(resp.stream))
        assert resp.status == 200 and resp.headers["x-stream-tier"] == "hpc"
        assert chunks[-1]["usage"]["completion_tokens"] >= 1
        b = port.engines["hpc"].scheduler.batcher
        assert not b.paged and b.pool.stateful and b.pool.kv_dtype == "fp32"
    finally:
        for s in (ref_s, port):
            for e in s.engines.values():
                e.shutdown()
            s.endpoint.shutdown()
