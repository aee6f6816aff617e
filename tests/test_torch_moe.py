"""Port MoE layer (``repro_torch.models.moe``) against the JAX package's
``models/moe.py`` with the reference's weights: routing (float32
softmax, top-k, ``router_renorm`` on for deepseek-v2-lite and off for
grok-1), the capacity-bounded slots (``slot`` and ``keep`` equal as
integers, drops on at a small capacity factor and off at a no-drop
one), shared experts and ``load_balance_loss``. Smoke configs, float32;
outputs within rtol = atol = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params as ref_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]


def _setup(arch, **over):
    kw = dict(compute_dtype="float32", **over)
    jcfg, cfg = ref_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)
    jp = ref_init(jmoe.moe_def(jcfg), jax.random.PRNGKey(3), jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_reference(arch):
    jcfg, cfg, jp, _ = _setup(arch)
    ref = {p: tuple(a.shape) for p, a in flatten(jax.tree.map(np.asarray, jp))}
    assert {p: d.shape for p, d in flatten(moe.moe_def(cfg))} == ref
    assert ("shared", "w1") in ref if cfg.n_shared_experts else ("shared", "w1") not in ref


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.25, None])      # None: no-drop (E / K)
def test_route_and_slots_equal_reference(arch, cf):
    jcfg, cfg, jp, pp = _setup(arch)
    E, K = cfg.n_experts, cfg.top_k
    xt = _x((24, cfg.d_model))
    cf = cf if cf is not None else E / K
    C = moe._capacity(24, K, E, cf)
    jg, ji = jmoe._route(jnp.asarray(xt), jp["router"], jcfg, K)
    g, i = moe._route(torch.from_numpy(xt), pp["router"], cfg, K)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if cfg.router_renorm:
        np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, **TOL)
    js, jk = jmoe._slots(ji, E, C, K)
    s, k = moe._slots(i, E, C, K)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    if cf < 1.0:
        assert not bool(k.all())            # the small capacity drops units


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [0.5, None])
@pytest.mark.parametrize("shape", [(2, 12), (8, 1)])    # a prompt chunk; a decode tick
def test_moe_mlp_matches_reference(arch, cf, shape):
    jcfg, cfg, jp, pp = _setup(arch)
    cf = cf if cf is not None else cfg.n_experts / cfg.top_k
    x = _x((*shape, cfg.d_model), seed=1)
    want = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg, capacity_factor=cf)
    got = moe.moe_mlp(torch.from_numpy(x), pp, cfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("renorm", [True, False])
def test_router_renorm_and_default_capacity(renorm):
    """``router_renorm`` flipped on each config, and the config's own
    ``capacity_factor`` when none is passed."""
    jcfg, cfg, jp, pp = _setup("deepseek-v2-lite-16b", router_renorm=renorm)
    x = _x((3, 10, cfg.d_model), seed=2)
    want = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg)
    got = moe.moe_mlp(torch.from_numpy(x), pp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_shared_experts_are_the_gated_mlp():
    """With every routed unit dropped (zero routed weights), the output is
    the shared experts' gated MLP alone, as in the reference."""
    jcfg, cfg, jp, pp = _setup("deepseek-v2-lite-16b")
    for k in ("w1", "w3", "w2"):
        pp[k] = torch.zeros_like(pp[k])
        jp = {**jp, k: jnp.zeros_like(jp[k])}
    x = _x((2, 5, cfg.d_model), seed=4)
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    got = moe.moe_mlp(torch.from_numpy(x), pp, cfg)
    np.testing.assert_allclose(got.numpy(), layers.mlp(torch.from_numpy(x), pp["shared"],
                                                       cfg).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jlayers.mlp(jnp.asarray(x), jp["shared"], jcfg)), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_balance_loss_matches_reference(arch):
    jcfg, cfg, _, _ = _setup(arch)
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, cfg.n_experts)).astype(np.float32)
    idx = rng.integers(0, cfg.n_experts, (40, cfg.top_k))
    want = float(jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), jcfg))
    got = float(moe.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), cfg))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_shard_map_dispatch_takes_the_plain_path():
    """On one device with no mesh the reference's shard_map dispatch runs
    the plain path; so does the port's, for any ``moe_dispatch``."""
    jcfg, cfg, jp, pp = _setup("grok-1-314b", moe_dispatch="shard_map")
    x = _x((2, 6, cfg.d_model), seed=6)
    want = jmoe.moe_mlp(jnp.asarray(x), jp, jcfg)
    got = moe.moe_mlp(torch.from_numpy(x), pp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
