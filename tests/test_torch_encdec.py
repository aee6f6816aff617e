"""Port EncDecLM (whisper-medium's encoder-decoder) against the JAX
package's, with the reference's weights carried over by
``interop.params_from_numpy``: the config field for field, the param
tree, ``layernorm`` / ``sinusoid`` / ``plain_mlp``, ``encode``,
``forward``, ``prefill`` with frames, ``prefill_chunk`` with and
without them, ``decode_step`` at a scalar and at per-slot positions, and
the cache leaves. Smoke config in float32; tolerance atol 1e-4 on logits
and activations, as in ``tests/test_torch_model.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.common import cache_layout, flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

ATOL = 1e-4
ARCH = "whisper-medium"
KW = dict(compute_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke(ARCH).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(get_smoke_config(ARCH).replace(**KW)), \
        params_from_numpy(jax.tree.map(np.asarray, jp))


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _frames(cfg, B, seed=1):
    """The stub frontend's output at 0.1 scale, as the reference's smoke
    tests draw it."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model))).astype(
        np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


def test_config_and_param_tree_match_reference(models):
    _, jp, pm, pp = models
    for port, ref in ((get_config(ARCH), ref_full(ARCH)),
                      (get_smoke_config(ARCH), ref_smoke(ARCH))):
        for f in ref.__dataclass_fields__:
            assert getattr(port, f) == getattr(ref, f), f
    assert isinstance(pm, encdec.EncDecLM)
    ref = dict(flatten(jax.tree.map(np.asarray, jp)))
    assert {p: d.shape for p, d in flatten(pm.param_defs())} == {
        p: tuple(a.shape) for p, a in ref.items()}
    for path, t in flatten(pp):
        np.testing.assert_array_equal(t.numpy(), ref[path])
    full = build_model(get_config(ARCH))
    jfull = ref_build(ref_full(ARCH))
    assert {p: d.shape for p, d in flatten(full.param_defs())} == {
        p: d.shape for p, d in flatten(jfull.param_defs(),)}


@pytest.mark.parametrize("d", [8, 64])
def test_layernorm_sinusoid_plain_mlp_match_reference(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w": rng.standard_normal(d).astype(np.float32),
         "b": rng.standard_normal(d).astype(np.float32)}
    close(encdec.layernorm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}),
          ref_encdec.layernorm(jnp.asarray(x), p), atol=1e-5)
    # sin / cos of angles up to ~1499 rad (the encoder's last frame), where
    # one float32 ulp of the angle is up to 1.2e-4: each row is held to 4
    # ulps of its largest angle (the position itself)
    pos = np.array([0, 1, 7, 100, 255, 1499])
    got = encdec.sinusoid(torch.from_numpy(pos), d).numpy()
    want = np.asarray(ref_encdec.sinusoid(jnp.asarray(pos), d))
    assert (np.abs(got - want) <= 4 * np.maximum(pos, 1)[:, None] * 2.0 ** -23).all()
    f = 3 * d
    mp = {"w1": rng.standard_normal((d, f)).astype(np.float32) / np.sqrt(d),
          "b1": rng.standard_normal(f).astype(np.float32),
          "w2": rng.standard_normal((f, d)).astype(np.float32) / np.sqrt(f),
          "b2": rng.standard_normal(d).astype(np.float32)}
    close(encdec.plain_mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in mp.items()}),
          ref_encdec.plain_mlp(jnp.asarray(x), mp), atol=1e-5)


def test_encode_and_forward_match_reference(models):
    jm, jp, pm, pp = models
    fr = _frames(pm.cfg, 2)
    toks = _tokens((2, 11))
    with torch.no_grad():
        close(pm.encode(pp, torch.from_numpy(fr)), jm.encode(jp, jnp.asarray(fr)))
        close(pm.forward(pp, torch.from_numpy(toks), {"frames": torch.from_numpy(fr)}),
              jm.forward(jp, jnp.asarray(toks), {"frames": jnp.asarray(fr)}))
    with pytest.raises(ValueError, match="frames"):
        pm.forward(pp, torch.from_numpy(toks))
    with pytest.raises(NotImplementedError, match="not ported"):
        pm.loss(pp, {"tokens": torch.from_numpy(toks)})


def test_cache_leaves_match_reference(models):
    jm, _, pm, _ = models
    assert pm.cache_specs() == jm.cache_specs()
    ref, port = jm.init_cache(2, 32), pm.init_cache(2, 32)
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k != "pos":
            assert tuple(port[k].shape) == tuple(v.shape), k
    lay = cache_layout(pm.cache_specs())
    assert lay["k"].paged and lay["cross_k"].state and lay["cross_k"].batch_axis == 1


def test_prefill_with_frames_then_decode_matches_reference(models):
    """prefill(frames) then three decode steps at a scalar pos: logits
    and the cross leaves against the reference step by step, and
    against the forward's logits at the same positions."""
    jm, jp, pm, pp = models
    fr, toks = _frames(pm.cfg, 2), _tokens((2, 15))
    T = 12
    full = jm.forward(jp, jnp.asarray(toks), {"frames": jnp.asarray(fr)})
    jc = jm.init_cache(2, 32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :T]), jc, {"frames": jnp.asarray(fr)})
    with torch.no_grad():
        pc = pm.init_cache(2, 32)
        pl, pc = pm.prefill(pp, torch.from_numpy(toks[:, :T]), pc,
                            {"frames": torch.from_numpy(fr)})
        close(pl, jl)
        close(pl, full[:, T - 1])
        close(pc["cross_k"], jc["cross_k"])
        close(pc["cross_v"], jc["cross_v"])
        assert pc["pos"] == int(jc["pos"]) == T
        for t in range(T, T + 3):
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]), pc)
            close(pl, jl)
            close(pl, full[:, t])
        close(pc["k"], jc["k"])


def test_prefill_chunk_with_and_without_frames_matches_reference(models):
    """The first chunk brings the frames (the encoder runs), later ones
    reuse the cached cross K/V; without frames at all the cross leaves
    stay the cold zeros, as the serving engine runs it."""
    jm, jp, pm, pp = models
    fr, toks = _frames(pm.cfg, 2, seed=3), _tokens((2, 14), seed=3)
    for frames in (True, False):
        jc, pc = jm.init_cache(2, 32), pm.init_cache(2, 32)
        with torch.no_grad():
            for i, (a, b) in enumerate(((0, 8), (8, 12), (12, 13))):
                jx = {"frames": jnp.asarray(fr)} if frames and i == 0 else None
                px = {"frames": torch.from_numpy(fr)} if frames and i == 0 else None
                jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, a:b]), jc, jx)
                pl, pc = pm.prefill_chunk(pp, torch.from_numpy(toks[:, a:b]), pc, px)
                close(pl, jl)
                assert pc["pos"] == int(jc["pos"]) == b
            close(pc["cross_k"], jc["cross_k"])
            if not frames:
                assert not bool(pc["cross_k"].any())
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, 13:14]), jc)
            pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, 13:14]), pc)
            close(pl, jl)


def test_decode_step_per_slot_positions_matches_reference(models):
    """Per-slot ``pos`` vectors (the splice batcher's contiguous cache):
    two slots at different depths, each written and attended at its own
    position."""
    jm, jp, pm, pp = models
    fr, toks = _frames(pm.cfg, 2, seed=4), _tokens((2, 12), seed=4)
    jc = jm.init_cache(2, 32)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :10]), jc, {"frames": jnp.asarray(fr)})
    pc = pm.init_cache(2, 32)
    with torch.no_grad():
        _, pc = pm.prefill(pp, torch.from_numpy(toks[:, :10]), pc,
                           {"frames": torch.from_numpy(fr)})
        jc = dict(jc, pos=jnp.asarray([10, 6], jnp.int32))
        pc = dict(pc, pos=torch.tensor([10, 6], dtype=torch.int32))
        for t in (10, 11):
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
            pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]), pc)
            close(pl, jl)
        assert pc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [12, 8]
        close(pc["k"], jc["k"])
