"""The port's training package against the JAX package's: AdamW, the
learning-rate schedule, the train step with and without microbatch
accumulation (at the smoke configs of the four dense archs), the
synthetic data stream, checkpoints and the driver.
Weights come from the reference (``interop.params_from_numpy``), batches
and gradients from numpy seeds.

Tolerances, float32 throughout:
  * one AdamW step from the same gradients: max abs error <= 1e-6 on
    params and moments (the same float32 arithmetic, fused differently;
    a bfloat16 leaf within one bfloat16 ulp of its value);
  * the 3-step trajectory: losses within 1e-4 (as the model tests),
    first moments within 1e-5. Params: Adam moves a weight by
    lr * mh / (sqrt(vh) + eps) a step, so a gradient error dg moves it by
    about lr * dg / (sqrt(vh) + eps) -- small where the weight's gradients
    are large, up to a whole step where they are near zero or cancel
    across steps. With dg = G_TOL = 1e-6 (gradients of two float32
    implementations agree far closer), each weight is held within
    1e-5 + the sum over steps t of lr * min(2, G_TOL / (sqrt(vh_t) +
    eps)), vh_t the reference's bias-corrected second moment after step t
    (a weight whose first gradient is small takes a first step set by
    that gradient alone): 1% of one step where the gradients are large,
    at most 2 lr a step where they are not;
  * accumulation over 2 microbatches against one full batch: loss within
    1e-5, params as the trajectory;
  * schedule: relative 1e-6; data stream and resumed runs: exact.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.training import SyntheticLMData as RefData  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import flatten, tree_map  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWConfig, CheckpointManager,  # noqa: E402
                                  SyntheticLMData, adamw_init, adamw_update,
                                  make_train_step)
from repro_torch.training import optim  # noqa: E402
from repro_torch.training.train import init_train_state  # noqa: E402

KW = dict(vocab_size=300, vocab_pad_to=64, compute_dtype="float32")
OC = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def _np_tree(tree):
    return {"/".join(p): np.asarray(a) for p, a in flatten(tree)}


def _assert_trees_close(got, want, atol):
    g, w = _np_tree(tree_map(lambda t: t.detach().float(), got)), _np_tree(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k].astype(np.float32), atol=atol, rtol=0,
                                   err_msg=k)


DENSE = ["minitron-8b", "gemma-7b", "granite-20b", "deepseek-67b"]   # family "dense"


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    jm = ref_build(ref_smoke(request.param).replace(**KW))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(get_smoke_config(request.param).replace(**KW))
    return jm, jp, pm


G_TOL = 1e-6


def _assert_params_close(got, want, nus):
    """Params within 1e-5 + the sum over steps t of lr * min(2, G_TOL /
    (sqrt(vh_t) + eps)), vh_t the bias-corrected second moment after step
    t (``nus``: the reference's nu after each step): step t moves a weight
    by lr * mh_t / (sqrt(vh_t) + eps)."""
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


def _port_params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp))


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("step", [0, 1, 2, 5, 6, 50, 99, 100, 101, 5000, 10000, 20000])
def test_schedule_matches_reference(step):
    oc = AdamWConfig()
    want = joptim.schedule(jnp.asarray(step, jnp.int32), joptim.AdamWConfig())
    got = optim.schedule(step, oc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,master", [("float32", False), ("bfloat16", False),
                                          ("bfloat16", True)])
def test_one_adamw_step_matches_reference(dtype, master):
    r = np.random.default_rng(0)
    shapes = {"w": (6, 5), "stack": (2, 5), "norm": (5,)}
    p_np = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jdt = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p_np.items()}
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    joc = joptim.AdamWConfig(lr=1e-2, warmup_steps=1, clip_norm=0.5)
    oc = AdamWConfig(lr=1e-2, warmup_steps=1, clip_norm=0.5)
    jst = joptim.adamw_init(jp, master_fp32=master)
    pst = adamw_init(pp, master_fp32=master)
    for i in range(2):                      # two steps: moments and bias correction
        g_np = {k: (3 * r.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g_np.items()}
        pg = params_from_numpy(jax.tree.map(np.asarray, jg))
        jp, jst, jstats = joptim.adamw_update(jg, jst, jp, joc)
        pp2, pst2, pstats = adamw_update(pg, pst, pp, oc)
        assert pp2 is pp and pst2 is pst    # updated in place
    np.testing.assert_allclose(float(pstats["grad_norm"]), float(jstats["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pstats["lr"]), float(jstats["lr"]), rtol=1e-7)
    assert int(pst["step"]) == int(jst["step"]) == 2
    for name in ("mu", "nu") + (("master",) if master else ()):
        _assert_trees_close(pst[name], jst[name], 1e-6)
    if dtype == "float32":
        _assert_trees_close(pp, jp, 1e-6)
    else:      # one bfloat16 ulp of the value
        for k in shapes:
            w = np.asarray(jp[k]).astype(np.float32)
            np.testing.assert_allclose(pp[k].float().numpy(), w, rtol=2 ** -8, atol=0)


# ---------------------------------------------------------------- train step
def test_three_step_trajectory_matches_reference(models):
    jm, jp, pm = models
    data = SyntheticLMData(pm.cfg.vocab_size, 2, 24, seed=3)
    batches = [data.next()["tokens"] for _ in range(3)]
    jstep = jax.jit(ref_make_train_step(jm, joptim.AdamWConfig(**OC)))
    pstep = make_train_step(pm, AdamWConfig(**OC))
    jst, pp = joptim.adamw_init(jp), _port_params(jp)
    pst = adamw_init(pp)
    nus = []
    for toks in batches:
        jp, jst, jmets = jstep(jp, jst, {"tokens": jnp.asarray(toks)})
        nus.append(jst["nu"])
        pp, pst, pmets = pstep(pp, pst, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(pmets["loss"]), float(jmets["loss"]), atol=1e-4)
        np.testing.assert_allclose(float(pmets["grad_norm"]), float(jmets["grad_norm"]),
                                   rtol=1e-4)
    _assert_params_close(pp, jp, nus)
    _assert_trees_close(pst["mu"], jst["mu"], 1e-5)


def test_accumulation_matches_one_full_batch(models):
    jm, jp, pm = models
    toks = SyntheticLMData(pm.cfg.vocab_size, 4, 20, seed=4).next()["tokens"]
    runs = {}
    for accum in (1, 2):
        pp = _port_params(jp)
        pst = adamw_init(pp)
        step = make_train_step(pm, AdamWConfig(**OC), accum_steps=accum)
        runs[accum] = step(pp, pst, {"tokens": torch.from_numpy(toks)})
    (p1, s1, m1), (p2, _, m2) = runs[1], runs[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), atol=1e-5)
    _assert_params_close(p2, _np_tree(p1), [_np_tree(s1["nu"])])
    # and the reference's scan over the same two microbatches
    jstep = jax.jit(ref_make_train_step(jm, joptim.AdamWConfig(**OC), accum_steps=2))
    jp2, js2, jm2 = jstep(jp, joptim.adamw_init(jp), {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), atol=1e-4)
    _assert_params_close(p2, jp2, [js2["nu"]])


def test_cast_params_trains_float32_masters_through_a_cast(models):
    """cast_params="float32" on float32 params is the identity cast: the
    same step as without it, and gradients land on the float32 leaves."""
    jm, jp, pm = models
    toks = torch.from_numpy(SyntheticLMData(pm.cfg.vocab_size, 2, 16, seed=6).next()["tokens"])
    out = []
    for cast in (None, "float32"):
        pp = _port_params(jp)
        step = make_train_step(pm, AdamWConfig(**OC), cast_params=cast)
        out.append(step(pp, adamw_init(pp), {"tokens": toks}))
    assert float(out[0][2]["loss"]) == float(out[1][2]["loss"])
    _assert_trees_close(out[1][0], _np_tree(out[0][0]), 0.0)


# ---------------------------------------------------------------- data
def test_data_stream_matches_reference_token_for_token():
    ours, theirs = SyntheticLMData(300, 3, 18, seed=5), RefData(300, 3, 18, seed=5)
    for _ in range(4):
        np.testing.assert_array_equal(ours.next()["tokens"], theirs.next()["tokens"])
    state = ours.state()
    assert state == theirs.state() == {"step": 4, "seed": 5}
    again = SyntheticLMData(300, 3, 18, seed=0)
    again.restore(state)
    np.testing.assert_array_equal(again.next()["tokens"], theirs.next()["tokens"])


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_keeps_dtypes_and_last_n(tmp_path):
    tree = {"a": {"w": torch.randn(3, 4), "b": torch.randn(5).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    cm = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3):
        cm.save(s, tree, aux={"data": {"step": s, "seed": 0}})
    os.makedirs(tmp_path / "step_000000009.tmp")      # a crashed save is ignored
    assert sorted(os.listdir(tmp_path)) == ["step_000000002", "step_000000003",
                                            "step_000000009.tmp"]
    assert cm.latest_step() == 3
    man = json.loads((tmp_path / "step_000000003" / "MANIFEST.json").read_text())
    assert man["dtypes"] == ["bfloat16", "float32", "int32"]
    assert man["paths"] == ["a/b", "a/w", "step"]
    like = tree_map(torch.zeros_like, tree)
    got, aux, step = cm.restore(None, like)
    assert step == 3 and aux == {"data": {"step": 3, "seed": 0}}
    for (_, a), (_, b) in zip(flatten(got), flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="checkpoint"):
        cm.restore(3, {**like, "a": {"w": like["a"]["w"], "b": like["a"]["b"].float()}})


def test_restore_takes_a_mesh_only_with_shardings(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(4, 4)})
    with pytest.raises(ValueError, match="come together"):
        cm.restore(1, {"w": torch.empty(4, 4)}, mesh=object())
    with pytest.raises(ValueError, match="come together"):
        cm.restore(1, {"w": torch.empty(4, 4)}, shardings={"w": ()})
    with pytest.raises(ValueError, match="meta like leaf needs shardings"):
        cm.restore(1, {"w": torch.empty(4, 4, device="meta")})


def test_async_save_copies_before_in_place_updates(tmp_path):
    w = torch.zeros(64, 64)
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(1, {"w": w})
    w.add_(1.0)                         # the train step updates params in place
    cm.wait()
    got, _, _ = cm.restore(1, {"w": torch.empty(64, 64)})
    assert float(got["w"].abs().max()) == 0.0


def test_resume_is_exact(models, tmp_path):
    _, jp, pm = models
    oc = AdamWConfig(**OC)
    step = make_train_step(pm, oc)

    def run(pp, st, data, n):
        for _ in range(n):
            pp, st, m = step(pp, st, {"tokens": torch.from_numpy(data.next()["tokens"])})
        return pp, st, m

    data = SyntheticLMData(pm.cfg.vocab_size, 2, 16, seed=1)
    pp = _port_params(jp)
    straight = run(pp, adamw_init(pp), data, 4)

    data = SyntheticLMData(pm.cfg.vocab_size, 2, 16, seed=1)
    pp = _port_params(jp)
    pp, st, _ = run(pp, adamw_init(pp), data, 2)
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, {"params": pp, "opt": st}, aux={"data": data.state()})
    fresh = _port_params(jp)
    tree, aux, _ = cm.restore(None, {"params": fresh, "opt": adamw_init(fresh)})
    data = SyntheticLMData(pm.cfg.vocab_size, 2, 16, seed=0)
    data.restore(aux["data"])
    resumed = run(tree["params"], tree["opt"], data, 2)
    assert float(resumed[2]["loss"]) == float(straight[2]["loss"])
    assert int(resumed[1]["step"]) == 4
    for (_, a), (_, b) in zip(flatten(resumed[0]), flatten(straight[0])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- driver
def test_driver_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--smoke", "--arch", "minitron-8b", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train_driver.main(argv + ["--steps", "3"])
    first = capsys.readouterr().out
    train_driver.main(argv + ["--steps", "4"])
    second = capsys.readouterr().out
    assert "arch=minitron-smoke" in first and "device=cpu" in first
    losses = [float(line.split()[3]) for line in first.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "resumed from checkpoint step 3" in second and "step     3 loss" in second
    man = json.loads((tmp_path / "step_000000004" / "MANIFEST.json").read_text())
    assert man["aux"]["data"] == {"step": 4, "seed": 0}


def test_training_needs_a_card_unless_asked_for_cpu(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(models[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_driver.main(["--steps", "1"])
    params, opt = init_train_state(models[2], 0, "cpu")
    assert params["embed"]["w"].device.type == "cpu" and int(opt["step"]) == 0
