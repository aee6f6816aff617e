"""Port's xLSTM (mLSTM + sLSTM blocks, the reference's default local
tier) against the JAX package, with the reference's weights carried over
by ``interop.params_from_numpy``; inputs from a numpy seed. The smoke
config at float32 compute.

Tolerances, float32 throughout:
  * logits and every state leaf (mLSTM conv window, C, n, m; sLSTM c, n,
    h, m): max abs error <= 1e-4, as for the hybrid model. The port runs
    the time recurrence as a loop where the JAX package scans: equal up
    to summation order (observed ~2e-5 on sLSTM's n, which grows with T).
  * loss within 1e-5 and every gradient leaf within 1e-4 of ``jax.grad``.
Greedy serving streams must be token-identical.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import build_model, xlstm  # noqa: E402
from repro_torch.models.common import (cache_layout, cache_leaf, flatten,  # noqa: E402
                                       tree_map)
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.pagepool import PagePool, SlotSplicer, chunk_plan  # noqa: E402

ATOL = 1e-4
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
PAGE, MAX_SEQ = 16, 64


@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke("xlstm-125m").replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_smoke_config("xlstm-125m").replace(**KW))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, pm, pp


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def close_states(pc, jc):
    for name, layer in jc["states"].items():
        assert len(pc["states"][name]) == len(layer)
        for t, j in zip(pc["states"][name], layer):
            close(t, j)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 259, size=n).tolist()


def test_configs_match_reference_field_for_field():
    for port, refc in ((get_config("xlstm-125m"), ref_full("xlstm-125m")),
                       (get_smoke_config("xlstm-125m"), ref_smoke("xlstm-125m"))):
        for f in refc.__dataclass_fields__:
            assert getattr(port, f) == getattr(refc, f), f
    m = build_model(get_config("xlstm-125m"))
    assert isinstance(m, xlstm.XLSTMLM)
    assert m.is_slstm == [i % 4 == 3 for i in range(12)]
    assert xlstm._pf_dim(get_config("xlstm-125m")) == 1536


def test_param_tree_layout_matches_reference(models):
    """Per-layer dicts under blocks/l{i} with the reference's key paths
    and shapes (sLSTM at every 4th layer)."""
    jm, jp, pm, pp = models
    want = {path: tuple(a.shape) for path, a in flatten(jax.tree.map(np.asarray, jp))}
    assert {path: d.shape for path, d in flatten(pm.param_defs())} == want
    assert {path: tuple(t.shape) for path, t in flatten(pp)} == want
    own = pm.init(seed=1, device="cpu")
    assert bool((own["blocks"]["l0"]["fb"] == 1).all())
    assert not bool(own["blocks"]["l3"]["wx"].eq(0).all())


def test_cells_match_reference():
    r = np.random.default_rng(5)
    B, H, dh = 2, 3, 8
    q, k, v = (r.standard_normal((B, H, dh)).astype(np.float32) for _ in "qkv")
    i_pre, f_pre = (r.standard_normal((B, H)).astype(np.float32) for _ in "if")
    st = (r.standard_normal((B, H, dh, dh)).astype(np.float32),
          r.standard_normal((B, H, dh)).astype(np.float32),
          r.standard_normal((B, H)).astype(np.float32))
    jh, jst = jx.mlstm_cell_step(q, k, v, i_pre, f_pre, st)
    ph, pst = xlstm.mlstm_cell_step(*(torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre)),
                                    tuple(torch.from_numpy(a) for a in st))
    close(ph, jh, 1e-5)
    for t, j in zip(pst, jst):
        close(t, j, 1e-5)
    pre = r.standard_normal((B, H, dh, 4)).astype(np.float32)
    st = tuple(r.standard_normal((B, H, dh)).astype(np.float32) for _ in range(4))
    jh, jst = jx.slstm_cell_step(pre, st)
    ph, pst = xlstm.slstm_cell_step(torch.from_numpy(pre),
                                    tuple(torch.from_numpy(a) for a in st))
    close(ph, jh, 1e-5)
    for t, j in zip(pst, jst):
        close(t, j, 1e-5)


def test_forward_logits_match_reference(models):
    jm, jp, pm, pp = models
    toks = np.random.default_rng(1).integers(0, 300, (2, 21))
    with torch.no_grad():
        close(pm.forward(pp, torch.from_numpy(toks)), jm.forward(jp, jnp.asarray(toks)))


def test_prefill_chunks_and_decode_match_reference(models):
    """prefill, then prefill_chunk continuations (16 + 4 + 1 tokens), then
    decode steps: logits at each and every state leaf at the end."""
    jm, jp, pm, pp = models
    ids = _prompt(0, 37)
    jc, pc = jm.init_cache(1, MAX_SEQ), pm.init_cache(1, MAX_SEQ, device="cpu")
    off = 0
    for i, n in enumerate(chunk_plan(0, len(ids), PAGE)):
        fj = jm.prefill if i == 0 else jm.prefill_chunk
        fp = pm.prefill if i == 0 else pm.prefill_chunk
        jl, jc = fj(jp, jnp.asarray([ids[off:off + n]]), jc)
        with torch.inference_mode():
            pl, pc = fp(pp, torch.tensor([ids[off:off + n]]), pc)
        close(pl, jl)
        off += n
    close_states(pc, jc)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jnp.asarray([[tok]]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.tensor([[tok]]), pc)
        close(pl, jl)
        tok = int(np.argmax(np.asarray(jl)[0]))
    close_states(pc, jc)
    assert pc["pos"] == int(jc["pos"]) == 42


def test_decode_with_per_slot_positions_matches_reference(models):
    """Two slots spliced into a B = 2 cache (SlotSplicer over the nested
    state tree) decode together through a (B,) pos."""
    jm, jp, pm, pp = models
    prompts = [_prompt(1, 21), _prompt(2, 7)]
    jcs, toks = [], []
    pc = pm.init_cache(2, MAX_SEQ, device="cpu")
    pc["pos"] = torch.zeros(2, dtype=torch.int32)
    sp = SlotSplicer(cache_layout(pm.cache_specs()))
    for slot, ids in enumerate(prompts):
        jc, one = jm.init_cache(1, MAX_SEQ), pm.init_cache(1, MAX_SEQ, device="cpu")
        jl, jc = jm.prefill(jp, jnp.asarray([ids]), jc)
        with torch.inference_mode():
            _, one = pm.prefill(pp, torch.tensor([ids]), one)
        sp(pc, one, slot, MAX_SEQ)
        jcs.append(jc)
        toks.append(int(np.argmax(np.asarray(jl)[0])))
    jc = {"states": jax.tree.map(lambda *a: jnp.concatenate(a, axis=0),
                                 *[c["states"] for c in jcs]),
          "pos": jnp.asarray([len(p) for p in prompts], jnp.int32)}
    tok = np.asarray(toks)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok[:, None]), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.from_numpy(tok[:, None]).long(), pc)
        close(pl, jl)
        tok = np.argmax(np.asarray(jl), axis=-1)
    close_states(pc, jc)
    assert pc["pos"].tolist() == [25, 11]


def test_nested_cache_layout_and_stateful_pool(models):
    """cache_layout flattens the nested {"states": {"l{i}": tuple}} tree
    to path keys (every leaf a state leaf), and the stateful pool
    snapshots and restores each of them per page."""
    _, _, pm, _ = models
    layout = cache_layout(pm.cache_specs())
    assert layout["pos"].batch_axis == -1
    states = [k for k in layout if k != "pos"]
    assert len(states) == 3 * 4 + 4 and all(layout[k].state for k in states)
    assert layout[("states", "l0", 1)].batch_axis == 0
    pool = PagePool(pm, page=PAGE, capacity=3)
    assert pool.stateful and not pool._paged
    per_slot = sum(cache_leaf(pm.init_cache(1, 1, device="cpu"), k).numel() * 4 for k in states)
    assert pool.pool_bytes == 4 * per_slot
    c = pm.init_cache(2, MAX_SEQ, device="cpu")
    for k in states:
        cache_leaf(c, k).normal_()
    pool.store_state(c, 1, 2)
    d = pm.init_cache(1, MAX_SEQ, device="cpu")
    pool.load(d, 0, [], state_pid=2)
    for k in states:
        assert torch.equal(cache_leaf(d, k)[0], cache_leaf(c, k)[1])


def test_loss_and_gradients_match_reference(models):
    jm, jp, pm, pp = models
    toks = np.random.default_rng(3).integers(0, 300, (2, 17))
    mask = np.ones((2, 17), np.float32)
    mask[1, 10:] = 0.0
    batch_j = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, batch_j)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    leaves = [t for _, t in flatten(live)]
    pl, _ = pm.loss(live, {"tokens": torch.from_numpy(toks),
                           "loss_mask": torch.from_numpy(mask)})
    grads = torch.autograd.grad(pl, leaves)
    assert abs(float(pl.detach()) - float(jl)) <= 1e-5
    for (path, j), g in zip(flatten(jax.tree.map(np.asarray, jg)), grads):
        np.testing.assert_allclose(g.numpy(), j, atol=1e-4, rtol=0, err_msg=str(path))


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines():
    ref_e = RefEngine(ref_smoke("xlstm-125m").replace(**KW), max_seq=96)
    port = ServingEngine(get_smoke_config("xlstm-125m").replace(**KW), max_seq=96,
                         device="cpu",
                         params=params_from_numpy(jax.tree.map(np.asarray, ref_e.params)))
    yield ref_e, port
    ref_e.shutdown()
    port.shutdown()


PROMPTS = ["hello recurrent world", "a prompt that runs past one sixteen-token page, "
           "and then some more", "x"]


def test_generate_matches_reference(engines):
    ref_e, port = engines
    for p in PROMPTS:
        assert port.generate(p, max_new_tokens=8).tokens == \
            ref_e.generate(p, max_new_tokens=8).tokens


def test_submit_streams_match_reference(engines):
    """ServingEngine.submit -> broker -> the contiguous splice batcher
    with a stateful prefix pool, against the reference's: a miss each,
    then the repeat of the long prompt, a hit on its published pages."""
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
    assert outs[1][0].prefix_hit_tokens == 0 and outs[1][3].prefix_hit_tokens > 0
    b = port.scheduler.batcher
    assert not b.paged and b.pool.stateful
    assert b.bytes_copied_per_admission() == \
        ref_e.scheduler.batcher.bytes_copied_per_admission() > 0


def test_build_system_defaults_to_xlstm_local_tier_like_reference():
    """build_system() serves the local tier from xlstm-125m (smoke), as the
    JAX package does; with the reference's weights its greedy stream
    equals the reference's, and the gateway's stream-local is served
    from it."""
    from repro.core import build_system as ref_build_system
    from repro_torch.core import build_system
    from repro_torch.core.sse import parse_sse

    f32 = {"compute_dtype": "float32"}
    kw = dict(dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0, prefix_cache_pages=16,
              hpc_overrides=f32, local_overrides=f32)
    ref_s, port = ref_build_system(**kw), build_system(device="cpu", **kw)
    try:
        local = port.engines["local"]
        assert isinstance(local.model, xlstm.XLSTMLM)
        assert local.cfg.name == ref_s.engines["local"].cfg.name == "xlstm-smoke"
        local.params = params_from_numpy(jax.tree.map(np.asarray,
                                                      ref_s.engines["local"].params))
        msgs = [{"role": "user", "content": "hi"}]
        streams = []
        for s in (ref_s, port):
            ids = []
            res = s.backends["local"].stream(msgs, max_tokens=8,
                                             on_token=lambda t, _: ids.append(t))
            assert len(ids) == res.n_completion_tokens > 0
            streams.append(ids)
        assert streams[0] == streams[1]
        token = port.globus.issue_token("port@uic.edu")
        resp = port.gateway.handle_chat_completions(
            {"model": "stream-local", "messages": msgs, "max_tokens": 6, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=token)
        chunks = parse_sse("".join(resp.stream))
        assert resp.status == 200 and resp.headers["x-stream-tier"] == "local"
        assert chunks[-1]["usage"]["completion_tokens"] >= 1
        b = local.scheduler.batcher
        assert not b.paged and b.pool.stateful
    finally:
        for s in (ref_s, port):
            for e in s.engines.values():
                e.shutdown()
            s.endpoint.shutdown()


def test_driver_defaults_to_xlstm_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--smoke", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_driver.main(argv + ["--steps", "3"])
    first = capsys.readouterr().out
    train_driver.main(argv + ["--steps", "4"])
    second = capsys.readouterr().out
    assert "arch=xlstm-smoke" in first and "device=cpu" in first
    losses = [float(line.split()[3]) for line in first.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "resumed from checkpoint step 3" in second and "step     3 loss" in second
    man = json.loads((tmp_path / "step_000000004" / "MANIFEST.json").read_text())
    assert man["aux"]["data"] == {"step": 4, "seed": 0}
