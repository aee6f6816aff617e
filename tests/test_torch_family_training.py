"""Training of the MLA/MoE, encoder-decoder and vision families in the
port against the JAX package: ``model.loss`` and every gradient
leaf against ``jax.value_and_grad`` of the reference's, three AdamW steps
of ``make_train_step``, microbatch accumulation with the stub inputs in
``batch["extra"]``, and the training driver for every family (the
hybrid family's own checks are ``tests/test_torch_hybrid_training.py``).
Smoke configs at
``compute_dtype="float32"`` (remat on, as the configs have it), the
reference's weights carried over by ``interop.params_from_numpy``; the
vision cross gates set to 0.5 in both trees (at their zero init the
cross path carries no gradient into its attention); stub frames and
patches from a numpy seed x 0.1, as the reference's smoke tests draw
them.

Tolerances, float32 throughout:
  * loss within 1e-5 absolute, logits within 1e-4 (as the model tests);
  * each gradient leaf within 1e-4 x max(1, max |reference leaf|): the
    two autodiffs sum in other orders;
  * the 3-step trajectory: losses within 1e-4, params as
    ``tests/test_torch_training.py`` holds them (1e-5 plus, a step, lr x
    min(2, G_TOL / (sqrt(vh) + eps)), vh the reference's bias-corrected
    second moment), first moments within 1e-5;
  * accumulation over 2 microbatches against one full batch: loss within
    1e-5, params as the trajectory.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import flatten, tree_map  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLMData, adamw_init,  # noqa: E402
                                  make_train_step)

ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b", "whisper-medium", "llama-3.2-vision-11b"]
KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
OC = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
GATE, STUB = 0.5, 0.1
G_TOL = 1e-6


def _extra(cfg, B, seed):
    """The stub inputs the arch's forward takes, as numpy (or None)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frames": (STUB * rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)}
    if cfg.cross_attn_every:
        return {"vision": (STUB * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.vision_dim))).astype(np.float32)}
    return None


def _batches(cfg, B, T, seed, n):
    """n batches of the synthetic stream (T + 1 tokens a row) with their
    stub inputs: (numpy, jax, torch) each."""
    data = SyntheticLMData(cfg.vocab_size, B, T + 1, seed=seed)
    out = []
    for i in range(n):
        b = {"tokens": data.next()["tokens"]}
        ex = _extra(cfg, B, 100 * seed + i)
        if ex is not None:
            b["extra"] = ex
        out.append((b, jax.tree.map(jnp.asarray, b), tree_map(torch.from_numpy, b)))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(jax model, jax params, port model): the reference built and
    initialised once per arch."""
    jm = ref_build(ref_smoke(request.param).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    if "cross" in jp:
        jp["cross"]["attn"]["gate"] = jnp.full_like(jp["cross"]["attn"]["gate"], GATE)
    return jm, jp, build_model(get_smoke_config(request.param).replace(**KW))


def _port(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


def _np_tree(tree):
    return {"/".join(p): np.asarray(a) for p, a in flatten(tree)}


def _assert_params_close(got, want, nus):
    """As ``tests/test_torch_training.py``: within 1e-5 + the sum over
    steps t of lr * min(2, G_TOL / (sqrt(vh_t) + eps))."""
    g, w = _np_tree(tree_map(lambda t: t.detach().float(), got)), _np_tree(want)
    vs = [_np_tree(nu) for nu in nus]
    assert all(g.keys() == w.keys() == v.keys() for v in vs)
    oc = AdamWConfig(**OC)
    for k in g:
        err = np.abs(g[k] - w[k].astype(np.float32))
        lim = 1e-5 + sum(oc.lr * np.minimum(2.0, G_TOL / (np.sqrt(v[k] / (1 - oc.b2 ** t))
                                                         + oc.eps))
                         for t, v in enumerate(vs, 1))
        assert (err <= lim).all(), (k, err.max(), int((err > 1e-5).sum()))


def test_loss_logits_and_every_gradient_match_reference(models):
    jm, jp, pm = models
    (nb, jb, tb), = _batches(pm.cfg, 2, 23, seed=1, n=1)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    pp = _port(jp)
    leaves = [t.requires_grad_() for _, t in flatten(pp)]
    loss, _ = pm.loss(pp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    ref = _np_tree(jg)
    assert [p for p, _ in flatten(pp)] == [tuple(k.split("/")) for k in ref]
    for (path, _), g in zip(flatten(pp), grads):
        want = ref["/".join(path)]
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=tol, rtol=0, err_msg="/".join(path))
    with torch.no_grad():
        logits = pm.forward(pp, tb["tokens"][:, :-1], tb.get("extra"))
    want = jax.jit(jm.forward)(jp, jb["tokens"][:, :-1], jb.get("extra"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_three_step_trajectory_matches_reference(models):
    jm, jp, pm = models
    batches = _batches(pm.cfg, 2, 23, seed=3, n=3)
    jstep = jax.jit(ref_make_train_step(jm, joptim.AdamWConfig(**OC)))
    pstep = make_train_step(pm, AdamWConfig(**OC))
    jst, pp = joptim.adamw_init(jp), _port(jp)
    pst = adamw_init(pp)
    nus = []
    for _, jb, tb in batches:
        jp, jst, jmets = jstep(jp, jst, jb)
        nus.append(jst["nu"])
        pp, pst, pmets = pstep(pp, pst, tb)
        np.testing.assert_allclose(float(pmets["loss"]), float(jmets["loss"]), atol=1e-4)
        np.testing.assert_allclose(float(pmets["grad_norm"]), float(jmets["grad_norm"]),
                                   rtol=1e-4)
    _assert_params_close(pp, jp, nus)
    g, w = _np_tree(tree_map(lambda t: t.detach().float(), pst["mu"])), _np_tree(jst["mu"])
    for k in g:
        np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b"])
def test_accumulation_splits_the_extra_inputs(arch):
    """accum_steps=2 splits the stub frames / patches with the tokens: the
    same step as one full batch."""
    cfg = get_smoke_config(arch).replace(**KW)
    pm = build_model(cfg)
    pp0 = pm.init(0, "cpu")
    if "cross" in pp0:
        pp0["cross"]["attn"]["gate"].fill_(GATE)
    (_, _, tb), = _batches(cfg, 4, 19, seed=4, n=1)
    runs = {}
    for accum in (1, 2):
        pp = tree_map(lambda t: t.clone(), pp0)
        runs[accum] = make_train_step(pm, AdamWConfig(**OC), accum_steps=accum)(
            pp, adamw_init(pp), tb)
    (p1, s1, m1), (p2, _, m2) = runs[1], runs[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), atol=1e-5)
    _assert_params_close(p2, _np_tree(p1), [_np_tree(s1["nu"])])


@pytest.mark.parametrize("arch", ["zamba2-7b", "deepseek-v2-lite-16b",
                                  "llama-3.2-vision-11b"])
def test_driver_trains_every_family_on_cpu(arch, capsys):
    train_driver.main(["--device", "cpu", "--smoke", "--arch", arch, "--batch", "2",
                       "--seq", "16", "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={get_smoke_config(arch).name}" in out and "device=cpu" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_driver_refuses_whisper_for_want_of_frames():
    """Like the JAX driver, the port's passes no frames: the encoder
    refuses (the JAX package fails there with a KeyError)."""
    with pytest.raises(ValueError, match="frames"):
        train_driver.main(["--device", "cpu", "--smoke", "--arch", "whisper-medium",
                           "--batch", "2", "--seq", "16", "--steps", "1"])
