"""The hybrid family's training and whole-prompt prefill in the port
against the JAX package (zamba2's smoke config at
``compute_dtype="float32"``, the reference's weights carried over by
``interop.params_from_numpy``): ``HybridLM.loss``, its logits and every
gradient leaf against ``jax.value_and_grad``; three AdamW steps of
``make_train_step``; ``HybridLM.prefill`` and two decode steps; and the
SSD scan's gradient, ``ops.ssd`` on the CPU and the card path's
``autograd.Function`` (its backward is autograd of the plain version,
recomputed), against ``jax.grad`` of the reference's ``ref.ssd`` with
and without ``h0``.

Tolerances, float32 throughout:
  * loss within 1e-5 absolute; logits within 1e-4 (as the model tests),
    caches within 1e-5;
  * each gradient leaf within 1e-4 x max(1, max |reference leaf|);
  * the 3-step trajectory: losses within 1e-4, params as
    ``tests/test_torch_training.py`` holds them (1e-5 plus, a step, lr x
    min(2, G_TOL / (sqrt(vh) + eps)));
  * the SSD gradients: max abs error <= 1e-5 x max(1, max |reference|),
    the scan's own bound (``tests/test_torch_ssm.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ssm_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import flatten, tree_map  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLMData, adamw_init,  # noqa: E402
                                  make_train_step)

ARCH = "zamba2-7b"
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
OC = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
G_TOL = 1e-6
SSD_REL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = ref_build(ref_smoke(ARCH).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(get_smoke_config(ARCH).replace(**KW))


def _port(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def _np_tree(tree):
    return {"/".join(p): np.asarray(a) for p, a in flatten(tree)}


def _tokens(B, T, seed):
    return SyntheticLMData(300, B, T, seed=seed).next()["tokens"]


def test_loss_logits_and_every_gradient_match_reference(models):
    """T = 23 tokens a row: the scan pads the last of two 16-step chunks."""
    jm, jp, pm = models
    toks = _tokens(2, 24, 1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    pp = _port(jp)
    leaves = [t.requires_grad_() for _, t in flatten(pp)]
    loss, _ = pm.loss(pp, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    ref = _np_tree(jg)
    for (path, _), g in zip(flatten(pp), grads):
        want = ref["/".join(path)]
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=tol, rtol=0, err_msg="/".join(path))
    with torch.no_grad():
        logits = pm.forward(pp, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax.jit(jm.forward)(
        jp, jnp.asarray(toks[:, :-1]))), atol=1e-4, rtol=0)


def test_remat_gives_the_same_gradients(models):
    """cfg.remat recomputes each layer (torch.utils.checkpoint): the same
    loss and gradients as keeping every activation."""
    _, jp, pm = models
    toks = torch.from_numpy(_tokens(2, 18, 2))
    out = []
    for remat in (True, False):
        model = build_model(pm.cfg.replace(remat=remat))
        pp = _port(jp)
        leaves = [t.requires_grad_() for _, t in flatten(pp)]
        loss, _ = model.loss(pp, {"tokens": toks})
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_three_step_trajectory_matches_reference(models):
    jm, jp, pm = models
    data = SyntheticLMData(pm.cfg.vocab_size, 2, 24, seed=3)
    batches = [data.next()["tokens"] for _ in range(3)]
    jstep = jax.jit(ref_make_train_step(jm, joptim.AdamWConfig(**OC)))
    pstep = make_train_step(pm, AdamWConfig(**OC))
    jst, pp = joptim.adamw_init(jp), _port(jp)
    pst = adamw_init(pp)
    nus = []
    for toks in batches:
        jp, jst, jmets = jstep(jp, jst, {"tokens": jnp.asarray(toks)})
        nus.append(_np_tree(jst["nu"]))
        pp, pst, pmets = pstep(pp, pst, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(pmets["loss"]), float(jmets["loss"]), atol=1e-4)
    g, w = _np_tree(tree_map(lambda t: t.detach(), pp)), _np_tree(jp)
    oc = AdamWConfig(**OC)
    for k in g:
        err = np.abs(g[k] - w[k])
        lim = 1e-5 + sum(oc.lr * np.minimum(2.0, G_TOL / (np.sqrt(v[k] / (1 - oc.b2 ** t))
                                                         + oc.eps))
                         for t, v in enumerate(nus, 1))
        assert (err <= lim).all(), (k, err.max())


def test_prefill_then_decode_matches_reference(models):
    """Whole-prompt prefill (every layer's scan from zero state, the conv
    state from the prompt's last inputs, the shared block's K/V at 0),
    then two decode steps: logits and every cache leaf."""
    jm, jp, pm = models
    pp = _port(jp)
    toks = _tokens(2, 22, 4)
    jc, pc = jm.init_cache(2, 48), pm.init_cache(2, 48, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    with torch.inference_mode():
        pl, pc = pm.prefill(pp, torch.from_numpy(toks), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for _ in range(2):
        for key in ("conv", "ssm", "attn_k", "attn_v"):
            np.testing.assert_allclose(pc[key].numpy(), np.asarray(jc[key]), atol=1e-5,
                                       rtol=0, err_msg=key)
        assert pc["pos"] == int(jc["pos"])
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc)
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, torch.from_numpy(tok), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def _ssd_case(h0):
    r = np.random.default_rng(7 if h0 else 8)
    b, T, H, P, N = 2, 48, 3, 16, 16
    args = [r.standard_normal((b, T, H, P)), r.uniform(1e-3, 0.2, (b, T, H)),
            -r.uniform(1.0, 16.0, H), r.standard_normal((b, T, N)),
            r.standard_normal((b, T, N)), r.standard_normal(H),
            r.standard_normal((b, H, P, N)) if h0 else None]
    cot = (r.standard_normal((b, T, H, P)), r.standard_normal((b, H, P, N)))
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)    # noqa: E731
    return [f32(a) for a in args], [f32(c) for c in cot]


def _ssd_reference_grads(args, cot):
    names = [i for i, a in enumerate(args) if a is not None]

    def f(*live):
        full = list(args)
        for i, a in zip(names, live):
            full[i] = a
        y, h = jref.ssd(*full[:6], chunk=16, h0=full[6])
        return (y * cot[0]).sum() + (h * cot[1]).sum()

    return jax.jit(jax.grad(f, argnums=tuple(range(len(names)))))(*(jnp.asarray(args[i])
                                                           for i in names))


def _ssd_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= SSD_REL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("path", ["ops", "function"])
def test_ssd_gradient_matches_reference(h0, path, monkeypatch):
    """``ops.ssd``'s CPU gradient (autograd of the plain version), and the
    card path's ``_SSD`` function with the plain version standing in for
    the kernel's forward (``_launch``): its backward
    (``_build.plain_backward`` over the two outputs, ``h0`` None or
    given) recomputes and differentiates."""
    args, cot = _ssd_case(h0)
    ins = [None if a is None else torch.from_numpy(a).requires_grad_() for a in args]
    if path == "ops":
        y, h = ops.ssd(*ins[:6], chunk=16, h0=ins[6])
    else:
        launched = []

        def kernel(x, dt, A, B, C, D, chunk, h0):
            launched.append(chunk)
            return ssm_scan.plain(x, dt, A, B, C, D, chunk=chunk, h0=h0)

        monkeypatch.setattr(ssm_scan, "_launch", kernel)
        y, h = ssm_scan._SSD.apply(*ins, 16)
        assert launched == [16] and y.grad_fn is not None
    loss = (y * torch.from_numpy(cot[0])).sum() + (h * torch.from_numpy(cot[1])).sum()
    live = [t for t in ins if t is not None]
    for g, want in zip(torch.autograd.grad(loss, live), _ssd_reference_grads(args, cot)):
        _ssd_close(g, want)
