"""The port's flash attention, its attention branches and the dense
model's training forward, loss, gradients and whole-prompt prefill,
against the JAX package; the reference's weights carried over by
``interop.params_from_numpy``, inputs from a numpy seed.

Tolerances, float32 throughout:
  * attention outputs: max abs error <= 2e-6 (the same float32 math in
    another summation order; observed <= 6e-7);
  * model logits and loss: max abs error <= 1e-4, as for the serving
    tests of the dense model;
  * gradients: max abs error <= 1e-5 + 1e-4 * max |reference gradient|
    of the leaf (two autodiffs of the same float32 code, summed in
    another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.common import flatten, tree_unflatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import _layer  # noqa: E402

ATT_TOL = 2e-6
ATOL = 1e-4
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            r.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            r.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------- the kernel's function
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,cap", [
    (1, 4, 2, 32, 32, 16, True, 0.0),        # block-divisible causal, GQA
    (2, 4, 4, 16, 48, 16, True, 0.0),        # Skv > Sq: query i at i + 32
    (1, 4, 2, 32, 48, 16, False, 0.0),       # non-causal
    (1, 4, 1, 32, 32, 16, True, 30.0),       # soft cap, 4 query heads per kv head
    (1, 2, 2, 32, 32, 32, True, 5.0),        # soft cap that bites
    (1, 2, 2, 32, 32, 256, True, 0.0),       # gemma-7b's D 256, G 1
    (1, 4, 2, 32, 48, 256, False, 30.0),     # D 256, non-causal, soft cap
    (1, 8, 2, 32, 32, 8, True, 0.0),         # deepseek-67b's smoke: D 8, G 4
    (1, 48, 1, 16, 32, 16, True, 0.0),       # granite-20b's G 48 (MQA)
])
def test_plain_matches_pallas_interpret(B, Hq, Hkv, Sq, Skv, D, causal, cap):
    q, k, v = _qkv(Sq + Skv + D, B, Hq, Hkv, Sq, Skv, D)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, logit_soft_cap=cap, interpret=True,
                               block_q=16, block_k=16)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              logit_soft_cap=cap)
    _close(got, want, ATT_TOL)


@pytest.mark.parametrize("Sq,Skv,causal,cap", [
    (63, 63, True, 0.0),                     # the driver's T = seq - 1
    (17, 250, True, 0.0), (33, 70, False, 0.0), (63, 63, True, 20.0),
    (1100, 1100, True, 0.0),                 # past 1024 queries: 512-query chunks
    (1030, 1500, True, 0.0),
    (48, 16, True, 0.0),                     # causal Skv < Sq: rows that see no key
    (100, 63, True, 20.0),
])
def test_plain_matches_reference_at_ragged_lengths(Sq, Skv, causal, cap):
    q, k, v = _qkv(Sq, 1, 4, 2, Sq, Skv, 16)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=causal, logit_soft_cap=cap)
    if Sq > 1024:     # the dispatch above took the chunked reference: hold both
        _close(ref.mha_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal,
                               chunk_q=512),
               jref.mha_chunked(jq, jk, jv, causal=causal, chunk_q=512), ATT_TOL)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              logit_soft_cap=cap)
    _close(got, want, ATT_TOL)


def test_kernel_wrapper_refuses_a_device_it_does_not_take():
    """A tensor on the meta device takes the plain version (nothing runs);
    one that is on neither the CPU, meta nor a CUDA card raises (the
    kernel's own refusals are card tests)."""
    from _torch_elsewhere import elsewhere
    q, k, v = (torch.zeros(1, 4, 8, 16, device="meta") for _ in range(3))
    out = fa.flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*(elsewhere(1, 4, 8, 16) for _ in range(3)))


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke("minitron-8b").replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_smoke_config("minitron-8b").replace(**KW))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jm, jp, pm, pp


def _tokens(seed, B, T, V):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def test_attention_cache_free_and_prefill_branches(models):
    jm, jp, pm, pp = models
    cfg, jcfg = pm.cfg, jm.cfg
    x = np.random.default_rng(3).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    attn = _layer(pp["blocks"], 1)["attn"]
    want = jlayers.attention(jnp.asarray(x), jattn, jcfg, positions=jnp.arange(13))
    got = layers.attention(torch.from_numpy(x), attn, cfg, positions=torch.arange(13))
    _close(got, want, ATOL)

    shape = (2, cfg.n_kv_heads, 24, cfg.head_dim)
    jk = jnp.zeros(shape, jnp.float32)
    want, (wk, wv) = jlayers.attention(jnp.asarray(x), jattn, jcfg,
                                       positions=jnp.arange(13), cache=(jk, jk),
                                       cache_index=0)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    got = layers.attention(torch.from_numpy(x), attn, cfg, positions=torch.arange(13),
                           cache=(ck, cv), cache_index=0)
    _close(got, want, ATOL)
    _close(ck, wk, ATOL)
    _close(cv, wv, ATOL)


@pytest.mark.parametrize("T", [16, 23])
def test_forward_and_loss_match_reference(models, T):
    jm, jp, pm, pp = models
    toks = _tokens(T, 2, T + 1, pm.cfg.vocab_size)
    mask = (np.random.default_rng(T).random((2, T + 1)) < 0.7).astype(np.float32)
    with torch.no_grad():
        _close(pm.forward(pp, torch.from_numpy(toks[:, :-1])),
               jm.forward(jp, jnp.asarray(toks[:, :-1])), ATOL)
        for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
            jl, jmets = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
            pl, pmets = pm.loss(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
            _close(pl, jl, ATOL)
            _close(pmets["nll"], jmets["nll"], ATOL)


def test_loss_gradients_match_reference(models):
    """Every leaf's gradient of the loss, through remat (cfg.remat: the
    port's torch.utils.checkpoint, the JAX package's jax.checkpoint)."""
    jm, jp, pm, pp = models
    assert pm.cfg.remat
    toks = _tokens(7, 2, 24, pm.cfg.vocab_size)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)})[0])(jp)
    leaves = [t.clone().requires_grad_() for _, t in flatten(pp)]
    loss, _ = pm.loss(tree_unflatten(pp, leaves), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jl, ATOL)
    want = dict(flatten(jax.tree.map(np.asarray, jg)))
    assert len(want) == len(grads) == 12
    for (path, _), g in zip(flatten(pp), grads):
        w = want[path]
        _close(g, w, 1e-5 + 1e-4 * np.abs(w).max())


def test_prefill_matches_reference_and_chunked_prefill(models):
    jm, jp, pm, pp = models
    toks = _tokens(11, 2, 19, pm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(2, 32))
    with torch.no_grad():
        pl, pc = pm.prefill(pp, torch.from_numpy(toks), pm.init_cache(2, 32, device="cpu"))
        cl, cc = pm.prefill_chunk(pp, torch.from_numpy(toks), pm.init_cache(2, 32, device="cpu"))
    _close(pl, jl, ATOL)
    for name in ("k", "v"):
        _close(pc[name], jc[name], ATOL)
        _close(cc[name], pc[name].numpy(), ATOL)
    _close(cl, pl.numpy(), ATOL)
    assert pc["pos"] == int(jc["pos"]) == 19
    # the cache a prefill leaves decodes on: one step matches the reference
    nxt = _tokens(12, 2, 1, pm.cfg.vocab_size)
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jc)
    with torch.no_grad():
        pd, _ = pm.decode_step(pp, torch.from_numpy(nxt), pc)
    _close(pd, jd, ATOL)


@pytest.mark.parametrize("need", [(True, True, True), (False, True, False), (True, False, False)])
def test_kernel_autograd_functions_backward_through_their_launches(monkeypatch, need):
    """The card's autograd.Functions, with their launches replaced by the
    plain versions (the kernels themselves need a card): flash_attention's
    forward by ``plain_fwd`` (out and lse; float32 has no out_lo) and its
    backward launch by
    ``plain_bwd``, held to plain autograd within float32 tolerance (atol
    1e-5 + rtol 1e-5: the same math summed in another order); rmsnorm's
    backward is the plain version's autograd gradient, bit for bit. Only
    the inputs that need a gradient get one."""
    from repro_torch.kernels import rmsnorm as rms
    monkeypatch.setattr(fa, "_launch", lambda q, k, v, causal, scale, cap, with_lse: (
        *fa.plain_fwd(q, k, v, causal=causal, scale=scale, logit_soft_cap=cap), None))
    monkeypatch.setattr(fa, "_launch_bwd", lambda q, k, v, o, o_lo, lse, do, causal, scale,
                        cap, need_q, need_kv: fa.plain_bwd(q, k, v, o, lse, do, causal=causal,
                                                           scale=scale, logit_soft_cap=cap))
    monkeypatch.setattr(rms, "_launch", lambda x, w, eps, gemma: rms.plain(
        x, w, eps=eps, gemma_style=gemma))
    q, k, v = (torch.from_numpy(a).requires_grad_(n)
               for a, n in zip(_qkv(9, 2, 4, 2, 21, 21, 16), need))
    go = torch.from_numpy(_qkv(10, 2, 4, 2, 21, 21, 16)[0])
    wanted = [t for t in (q, k, v) if t.requires_grad]
    got = torch.autograd.grad(fa._FlashAttention.apply(q, k, v, True, 0.25, 0.0), wanted, go)
    want = torch.autograd.grad(fa.plain(q, k, v, scale=0.25), wanted, go)
    assert len(got) == len(wanted)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    x, w = q[0, 0].detach().requires_grad_(need[0]), k[0, 0, 0].detach().requires_grad_(need[1])
    wanted = [t for t in (x, w) if t.requires_grad]
    if wanted:
        got = torch.autograd.grad(rms._RMSNorm.apply(x, w, 1e-5, False), wanted, go[0, 0])
        want = torch.autograd.grad(rms.plain(x, w), wanted, go[0, 0])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
