"""Port TransformerLM for the MoE family -- deepseek-v2-lite-16b (MLA, a
leading dense block, shared experts, renormalized gates) and grok-1-314b
(GQA 4/2 at smoke, no shared experts, raw gates) -- against the JAX
package, with the reference's weights carried over by
``interop.params_from_numpy``: configs field for field, the param tree,
the training forward's logits and loss, prefill + decode against the
forward at no-drop capacity (the reference's own check,
``tests/test_models_smoke.py``), ``prefill_chunk`` as a continuation,
``verify_chunk`` bit-equal to ``prefill_chunk`` of the same window, and
the MLA cache leaves. Smoke configs, float32; logits within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import cache_layout, flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import TransformerLM  # noqa: E402

ATOL = 1e-4
ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]


def _cfgs(arch, nodrop=False):
    kw = dict(compute_dtype="float32", remat=False)
    jcfg, cfg = ref_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)
    if nodrop:      # no-drop capacity, so routing is path-independent
        nd = cfg.n_experts / cfg.top_k
        jcfg = jcfg.replace(capacity_factor=nd, eval_capacity_factor=nd)
        cfg = cfg.replace(capacity_factor=nd, eval_capacity_factor=nd)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jm = ref_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(cfg), params_from_numpy(jax.tree.map(np.asarray, jp))


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    for port, ref in ((get_config(arch), ref_full(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        for f in ref.__dataclass_fields__:
            assert getattr(port, f) == getattr(ref, f), f
    assert isinstance(build_model(get_smoke_config(arch)), TransformerLM)


def test_cross_attention_still_refused():
    """Cross-attention serves and trains now (a dense config with
    ``cross_attn_every`` builds its gated cross stack); the
    encoder-decoder's loss trains with frames and still refuses a batch
    without them, as its forward does."""
    from repro_torch.models.encdec import EncDecLM
    lm = TransformerLM(get_smoke_config("minitron-8b").replace(cross_attn_every=2))
    assert lm.n_cross == 1 and "gate" in lm.param_defs()["cross"]["attn"]
    cfg = get_smoke_config("whisper-medium")
    enc = EncDecLM(cfg)
    params = enc.init(seed=0, device="cpu")
    toks = torch.zeros((1, 5), dtype=torch.int64)
    frames = 0.1 * torch.randn((1, cfg.encoder_seq_len, cfg.d_model),
                               generator=torch.Generator().manual_seed(0))
    loss, _ = enc.loss(params, {"tokens": toks, "extra": {"frames": frames}})
    assert loss.ndim == 0 and bool(loss.isfinite())
    with pytest.raises(ValueError, match="frames"):
        enc.loss(params, {"tokens": toks})


def test_param_tree_and_interop_round_trip(models):
    """The reference's ``dense0/...``, MoE and MLA leaves land on the
    port's by key path, value for value, and go back unchanged."""
    _, jp, pm, pp = models
    ref = dict(flatten(jax.tree.map(np.asarray, jp)))
    assert {p: d.shape for p, d in flatten(pm.param_defs())} == {
        p: tuple(a.shape) for p, a in ref.items()}
    for path, t in flatten(pp):
        np.testing.assert_array_equal(t.numpy(), ref[path])
    if pm.cfg.first_dense_layers:
        assert ("dense0", "mlp", "w1") in ref and ("blocks", "mlp", "router") in ref
    again = params_from_numpy({"/".join(p): t.numpy() for p, t in flatten(pp)})
    assert all(np.array_equal(again["/".join(p)].numpy(), a) for p, a in ref.items())


def test_forward_logits_and_loss_match_reference(models):
    jm, jp, pm, pp = models
    toks = _tokens((2, 14))
    with torch.no_grad():
        close(pm.forward(pp, torch.from_numpy(toks)), jm.forward(jp, jnp.asarray(toks)))
        jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks)})
        tl, tmet = pm.loss(pp, {"tokens": torch.from_numpy(toks)})
    assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    assert float(tmet["nll"]) == pytest.approx(float(jmet["nll"]), abs=1e-5)


def test_cache_leaves_match_reference(models):
    jm, _, pm, _ = models
    assert pm.cache_specs() == jm.cache_specs()
    ref = jm.init_cache(2, 32)
    port = pm.init_cache(2, 32, device="cpu")
    assert set(port) == set(ref)
    for k, v in ref.items():
        if k != "pos":
            assert tuple(port[k].shape) == tuple(v.shape), k
    if pm.cfg.use_mla:
        lay = cache_layout(pm.cache_specs())
        assert {"c_kv", "k_rope", "dense0_ckv", "dense0_krope"} <= set(lay)
        assert all(lay[k].paged for k in lay if k != "pos")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """At no-drop capacity prefill + 3 decode steps reproduce the
    forward's logits, in the port as in the reference, and the two
    packages agree step by step."""
    jcfg, cfg = _cfgs(arch, nodrop=True)
    jm, pm = ref_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = _tokens((2, 15), seed=1)
    T = 12
    with torch.no_grad():
        full = pm.forward(pp, torch.from_numpy(toks))
        cache = pm.init_cache(2, 32, device="cpu")
        last, cache = pm.prefill(pp, torch.from_numpy(toks[:, :T]), cache)
    jc = jm.init_cache(2, 32)
    jlast, jc = jm.prefill(jp, jnp.asarray(toks[:, :T]), jc)
    np.testing.assert_allclose(last.numpy(), full[:, T - 1].numpy(), rtol=1e-4, atol=1e-4)
    close(last, jlast)
    for t in range(T, T + 3):
        with torch.no_grad():
            lg, cache = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]), cache)
        jlg, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), rtol=1e-4, atol=1e-4)
        close(lg, jlg)
    assert cache["pos"] == T + 3


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_is_a_continuation(arch):
    jcfg, cfg = _cfgs(arch, nodrop=True)
    jm, pm = ref_build(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = _tokens((2, 14), seed=2)
    with torch.no_grad():
        full = pm.forward(pp, torch.from_numpy(toks))
        cache = pm.init_cache(2, 32, device="cpu")
        _, cache = pm.prefill_chunk(pp, torch.from_numpy(toks[:, :8]), cache)
        last, cache = pm.prefill_chunk(pp, torch.from_numpy(toks[:, 8:12]), cache)
        np.testing.assert_allclose(last.numpy(), full[:, 11].numpy(), rtol=1e-4, atol=1e-4)
        for t in (12, 13):
            lg, cache = pm.decode_step(pp, torch.from_numpy(toks[:, t:t + 1]), cache)
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), rtol=1e-4, atol=1e-4)
    jc = jm.init_cache(2, 32)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :8]), jc)
    jlast, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, 8:12]), jc)
    close(last, jlast)


def test_verify_chunk_bit_equal_to_prefill_chunk(models):
    """The speculative verifier's window scores the same bits as a prefill
    chunk of the same window (the head runs over the whole piece in
    both), at an int position and at per-slot (B,) positions."""
    _, _, pm, pp = models
    toks = torch.from_numpy(_tokens((2, 13), seed=3))
    with torch.no_grad():
        base = pm.init_cache(2, 32, device="cpu")
        _, base = pm.prefill_chunk(pp, toks[:, :8], base)
        c1 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in base.items()}
        c2 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in base.items()}
        last, c1 = pm.prefill_chunk(pp, toks[:, 8:13], c1)
        win, c2 = pm.verify_chunk(pp, toks[:, 8:13], c2)
        assert c2["pos"] == 8 and c1["pos"] == 13
        assert torch.equal(win[:, -1], last)
        for k in c1:
            if k != "pos":
                assert torch.equal(c1[k], c2[k]), k
        c3 = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in base.items()}
        c3["pos"] = torch.full((2,), 8, dtype=torch.int32)
        win3, _ = pm.verify_chunk(pp, toks[:, 8:13], c3)
        torch.testing.assert_close(win3, win, rtol=0, atol=1e-5)


def test_propose_k_matches_reference(models):
    jm, jp, pm, pp = models
    toks = _tokens((2, 9), seed=4)
    with torch.no_grad():
        cache = pm.init_cache(2, 32, device="cpu")
        _, cache = pm.prefill_chunk(pp, torch.from_numpy(toks[:, :8]), cache)
        drafts, cache = pm.propose_k(pp, torch.from_numpy(toks[:, 8:9]), cache, 3)
    jc = jm.init_cache(2, 32)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :8]), jc)
    jd, jc = jm.propose_k(jp, jnp.asarray(toks[:, 8:9], jnp.int32), jc, 3)
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(jd))
    assert cache["pos"] == int(jc["pos"]) == 12
