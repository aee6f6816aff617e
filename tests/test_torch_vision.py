"""Port TransformerLM for the vision family (llama-3.2-vision-11b's
tanh-gated cross-attention blocks over projected patch embeddings)
against the JAX package's, with the reference's weights carried over by
``interop.params_from_numpy`` and the cross gates set to 0.5 in both
trees (at their zero init the cross path contributes nothing): the
config field for field, the param tree (``cross``, ``vis_proj``,
``gate``), ``forward`` with and without vision, ``prefill`` with vision,
``prefill_chunk`` with and without it, ``decode_step`` at a scalar and at
per-slot positions, ``verify_chunk``, the cross cache leaves and their
page-pool snapshot, and ``layers.attention``'s cross branch. Smoke config
in float32; tolerance atol 1e-4, as in ``tests/test_torch_model.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.common import cache_layout, flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import TransformerLM  # noqa: E402
from repro_torch.serving.pagepool import PagePool  # noqa: E402

ATOL = 1e-4
ARCH = "llama-3.2-vision-11b"
KW = dict(compute_dtype="float32", remat=False)
GATE = 0.5


@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke(ARCH).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    jp["cross"]["attn"]["gate"] = jnp.full_like(jp["cross"]["attn"]["gate"], GATE)
    return jm, jp, build_model(get_smoke_config(ARCH).replace(**KW)), \
        params_from_numpy(jax.tree.map(np.asarray, jp))


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _vision(cfg, B, seed=1):
    """The stub frontend's patch embeddings at 0.1 scale, as the
    reference's smoke tests draw them."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, cfg.n_image_tokens, cfg.vision_dim))).astype(
        np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


def test_config_and_param_tree_match_reference(models):
    _, jp, pm, pp = models
    for port, ref in ((get_config(ARCH), ref_full(ARCH)),
                      (get_smoke_config(ARCH), ref_smoke(ARCH))):
        for f in ref.__dataclass_fields__:
            assert getattr(port, f) == getattr(ref, f), f
    assert isinstance(pm, TransformerLM) and pm.n_cross == 2
    ref = dict(flatten(jax.tree.map(np.asarray, jp)))
    assert {p: d.shape for p, d in flatten(pm.param_defs())} == {
        p: tuple(a.shape) for p, a in ref.items()}
    assert ("cross", "attn", "gate") in ref and ("vis_proj", "w") in ref
    for path, t in flatten(pp):
        np.testing.assert_array_equal(t.numpy(), ref[path])
    assert (pm.init(seed=0, device="cpu")["cross"]["attn"]["gate"] == 0).all()     # zero-initialised
    full, jfull = build_model(get_config(ARCH)), ref_build(ref_full(ARCH))
    assert full.n_cross == 8
    assert {p: d.shape for p, d in flatten(full.param_defs())} == {
        p: d.shape for p, d in flatten(jfull.param_defs())}


def test_cross_attention_branch_of_layers_matches_reference():
    """``layers.attention(context=...)``: K/V from the context, no rope,
    no mask, and the tanh(gate) factor where the params carry one."""
    cfg = get_smoke_config(ARCH).replace(**KW)
    jcfg = ref_smoke(ARCH).replace(**KW)
    rng = np.random.default_rng(5)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)), ("wo", (64, 64)))}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 64)).astype(np.float32)
    pos = np.arange(7)
    for gate in (None, 0.7):
        q = dict(p, **({"gate": np.full((1,), gate, np.float32)} if gate else {}))
        want = ref_layers.attention(jnp.asarray(x), q, jcfg, positions=jnp.asarray(pos),
                                    context=jnp.asarray(ctx))
        with torch.no_grad():
            got = layers.attention(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                         for k, v in q.items()}, cfg,
                                   positions=torch.from_numpy(pos),
                                   context=torch.from_numpy(ctx))
        close(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="no cache"):
        layers.attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                         cfg, positions=torch.from_numpy(pos), context=torch.from_numpy(ctx),
                         cache=(torch.zeros(1), torch.zeros(1)), cache_index=0)


@pytest.mark.parametrize("with_vision", [True, False], ids=["vision", "text-only"])
def test_forward_matches_reference(models, with_vision):
    jm, jp, pm, pp = models
    toks = _tokens((2, 13))
    vis = _vision(pm.cfg, 2)
    jx = {"vision": jnp.asarray(vis)} if with_vision else None
    px = {"vision": torch.from_numpy(vis)} if with_vision else None
    with torch.no_grad():
        close(pm.forward(pp, torch.from_numpy(toks), px), jm.forward(jp, jnp.asarray(toks), jx))
        jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks), "extra": jx})
        tl, _ = pm.loss(pp, {"tokens": torch.from_numpy(toks), "extra": px})
    assert float(tl) == pytest.approx(float(jl), abs=1e-5)


def test_cache_leaves_and_pool_snapshot(models):
    """The cross leaves are state leaves with the batch on axis 1; the
    page pool snapshots each whole, without its batch axis, and restores
    it bit for bit."""
    jm, _, pm, _ = models
    assert pm.cache_specs() == jm.cache_specs()
    ref, port = jm.init_cache(2, 32), pm.init_cache(2, 32, device="cpu")
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k != "pos":
            assert tuple(port[k].shape) == tuple(v.shape), k
    lay = cache_layout(pm.cache_specs())
    assert lay["cross_k"].state and lay["cross_k"].batch_axis == 1
    pool = PagePool(pm, page=16, capacity=3)
    assert pool.stateful
    assert tuple(pool._state["cross_k"].shape) == (4, pm.n_cross, pm.cfg.n_kv_heads,
                                                   pm.cfg.n_image_tokens, pm.cfg.head_dim)
    cache = pm.init_cache(2, 32, device="cpu")
    cache["cross_k"].normal_()
    cache["cross_v"].normal_()
    pool.store_state(cache, 1, 2)
    one = pm.init_cache(1, 32, device="cpu")
    pool.load(one, 0, [], state_pid=2)
    assert torch.equal(one["cross_k"][:, 0], cache["cross_k"][:, 1])
    assert torch.equal(one["cross_v"][:, 0], cache["cross_v"][:, 1])


def test_prefill_with_vision_then_decode_matches_reference(models):
    """prefill(vision) then three decode steps at a scalar pos, against
    the reference step by step and against the forward's logits."""
    jm, jp, pm, pp = models
    toks, vis = _tokens((2, 15), seed=2), _vision(pm.cfg, 2, seed=2)
    T = 12
    full = jm.forward(jp, jnp.asarray(toks), {"vision": jnp.asarray(vis)})
    jc = jm.init_cache(2, 32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :T]), jc, {"vision": jnp.asarray(vis)})
    with torch.no_grad():
        pc = pm.init_cache(2, 32, device="cpu")
        pl, pc = pm.prefill(pp, torch.from_numpy(toks[:, :T]), pc,
                            {"vision": torch.from_numpy(vis)})
        close(pl, jl)
        close(pl, full[:, T - 1])
        close(pc["cross_k"], jc["cross_k"])
        close(pc["cross_v"], jc["cross_v"])
        for t in range(T, T + 3):
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]), pc)
            close(pl, jl)
            close(pl, full[:, t])


@pytest.mark.parametrize("with_vision", [True, False], ids=["vision", "text-only"])
def test_prefill_chunk_matches_reference(models, with_vision):
    """The first chunk brings the patches, later chunks reuse the cached
    cross K/V; without vision the cross blocks attend the cold zero
    leaves, as the serving engine runs them."""
    jm, jp, pm, pp = models
    toks, vis = _tokens((2, 14), seed=3), _vision(pm.cfg, 2, seed=3)
    jc, pc = jm.init_cache(2, 32), pm.init_cache(2, 32, device="cpu")
    with torch.no_grad():
        for i, (a, b) in enumerate(((0, 8), (8, 12), (12, 13))):
            jx = {"vision": jnp.asarray(vis)} if with_vision and i == 0 else None
            px = {"vision": torch.from_numpy(vis)} if with_vision and i == 0 else None
            jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, a:b]), jc, jx)
            pl, pc = pm.prefill_chunk(pp, torch.from_numpy(toks[:, a:b]), pc, px)
            close(pl, jl)
            assert pc["pos"] == int(jc["pos"]) == b
        assert bool(pc["cross_k"].any()) is with_vision
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, 13:14]), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, 13:14]), pc)
        close(pl, jl)


def test_per_slot_decode_and_verify_chunk_match_reference(models):
    """Per-slot positions (the splice batcher): decode_step and a W = 4
    verify window, each against the reference; the window's logits are
    the prefill_chunk ones of the same tokens, and pos is not advanced."""
    jm, jp, pm, pp = models
    toks, vis = _tokens((2, 16), seed=4), _vision(pm.cfg, 2, seed=4)
    jc = jm.init_cache(2, 32)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :10]), jc, {"vision": jnp.asarray(vis)})
    with torch.no_grad():
        pc = pm.init_cache(2, 32, device="cpu")
        _, pc = pm.prefill(pp, torch.from_numpy(toks[:, :10]), pc,
                           {"vision": torch.from_numpy(vis)})
        jc = dict(jc, pos=jnp.asarray([10, 7], jnp.int32))
        pc = dict(pc, pos=torch.tensor([10, 7], dtype=torch.int32))
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, 10:11]), jc)
        pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, 10:11]), pc)
        close(pl, jl)
        win = toks[:, 11:15]
        jl, jc = jm.verify_chunk(jp, jnp.asarray(win), jc)
        pl, pc = pm.verify_chunk(pp, torch.from_numpy(win), pc)
        assert pl.shape == (2, 4, pm.cfg.padded_vocab)
        close(pl, jl)
        assert pc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [11, 8]
        close(pc["k"], jc["k"])
        one = {k: (v[:1].clone() if torch.is_tensor(v) and k != "pos" else v)
               for k, v in pc.items()}
        one["cross_k"], one["cross_v"] = pc["cross_k"][:, :1].clone(), pc["cross_v"][:, :1].clone()
        one["pos"] = 11
        for n in ("k", "v"):
            one[n] = pc[n][:, :1].clone()
        last, _ = pm.prefill_chunk(pp, torch.from_numpy(win[:1]), one)
        assert torch.equal(last, pl[0, -1][None])
