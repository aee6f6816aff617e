"""The port's distribution on several CPU ranks (gloo), held against the
JAX package's single-device results: the reference cannot run
multi-device here (``tests/test_moe_shard_map.py``), so the multi-rank
port is compared with the reference's one-device output and with its
own plain path.

The parent process makes the reference's smoke params and outputs with
JAX, then starts four ranks of ``tests/_torch_dist_worker.py`` (no JAX)
on a ``file://`` store in ``tmp_path``. Each rank's process group times
out after 60 s and the four together have a hard wall limit, so a hang
fails the tests instead of stalling the suite. A (1, 1) mesh runs here,
in this process, through ``make_local_mesh(device="cpu")``.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed.sharding import DEFAULT_RULES as REF_RULES  # noqa: E402
from repro.distributed.sharding import logical_to_pspec as ref_pspec  # noqa: E402
from repro.distributed.sharding import make_abstract_mesh as ref_mesh  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models.common import spec_tree as ref_spec_tree  # noqa: E402
from repro_torch.distributed.sharding import to_placements  # noqa: E402
from repro_torch.models.common import flatten  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from _torch_dist_worker import launch  # noqa: E402

WORLD = 4
WALL_S = 240                 # the four ranks together
# the reference test's configs (tests/test_moe_shard_map.py): float32, no
# remat, capacity 4 for the plain dispatch and 8 for shard_map (no drops);
# grok with 6 experts on a (1, 4) mesh reaches the d_ff-parallel regime
MOE = {"grok": ("grok-1-314b", {}), "deepseek": ("deepseek-v2-lite-16b", {}),
       "grok_dff": ("grok-1-314b", {"n_experts": 6})}


def _flat_np(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _prepare(d: Path):
    """The reference's smoke minitron params as a port checkpoint (and
    their values), a training batch, and the MoE smokes' params, tokens,
    probe and single-device logits."""
    jm = ref_build(ref_smoke("minitron-8b"))
    flat = _flat_np(jm.init(jax.random.PRNGKey(0)))
    np.savez(d / "ref_params.npz", **flat)
    tree = {}
    for k, v in flat.items():
        node = tree
        for part in k.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[k.split("/")[-1]] = v
    CheckpointManager(str(d / "ckpt")).save(3, {"params": params_from_numpy(tree)},
                                            aux={"data": {"step": 3}})
    rng = np.random.default_rng(0)
    np.save(d / "train_tokens.npy", rng.integers(0, 256, (4, 17)).astype(np.int64))
    for name, (arch, over) in MOE.items():
        kw = dict(remat=False, compute_dtype="float32", capacity_factor=4.0,
                  eval_capacity_factor=4.0, **over)
        jm = ref_build(ref_smoke(arch).replace(**kw))
        jp = jm.init(jax.random.PRNGKey(1))
        toks = jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0, jm.cfg.vocab_size)
        logits = np.asarray(jax.jit(jm.forward)(jp, toks))
        np.savez(d / f"moe_{name}.npz", tokens=np.asarray(toks).astype(np.int64),
                 logits=logits, probe=rng.standard_normal(logits.shape).astype(np.float32),
                 meta=json.dumps({"arch": arch, "overrides": kw}),
                 **{f"p/{k}": v for k, v in _flat_np(jp).items()})
    return flat


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    flat = _prepare(d)
    return launch(WORLD, d, WALL_S), flat


def _ref_placements(mesh_shape):
    mesh = ref_mesh(mesh_shape, ("data", "model"))
    jm = ref_build(ref_smoke("minitron-8b"))
    defs = jm.param_defs()
    specs = {"/".join(str(k.key) for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(
                 ref_spec_tree(defs), is_leaf=lambda x: isinstance(x, tuple))[0]}
    shapes = {"/".join(str(k.key) for k in path): d.shape for path, d in
              jax.tree_util.tree_flatten_with_path(
                  defs, is_leaf=lambda x: hasattr(x, "logical"))[0]}
    return {k: ref_pspec(specs[k], shapes[k], mesh, REF_RULES) for k in specs}, shapes


def _local_shape(shape, pspec, mesh_sizes, coords):
    """A rank's local shape under the reference's pspec (dims divide)."""
    out = list(shape)
    for d, entry in enumerate(pspec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        for a in axes:
            out[d] //= mesh_sizes[a]
    return out


def test_elastic_restore_onto_2x2_keeps_reference_values_and_layout(ranks):
    outs, flat = ranks
    pspecs, shapes = _ref_placements((2, 2))
    sizes = {"data": 2, "model": 2}
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"), "shape": (2, 2)})()
    for r, out in enumerate(outs):
        got = out["elastic"]
        assert got["step"] == 3 and got["aux"] == {"data": {"step": 3}}
        assert set(got["leaves"]) == set(flat)
        for key, leaf in got["leaves"].items():
            assert leaf["err"] == 0.0, key
            assert leaf["placements"] == [repr(p) for p in
                                          to_placements(pspecs[key], mesh)], key
            assert leaf["local"] == _local_shape(shapes[key], pspecs[key], sizes, r), key
    # the layout really splits: the embedding over "model", wq's heads too
    assert pspecs["embed/w"][0] == "model" and pspecs["blocks/attn/wq"][2] == "model"


def test_elastic_restore_onto_1x1_local_mesh(tmp_path):
    """make_local_mesh(device="cpu") starts a world of one; every leaf is
    whole, with the reference's values and placements."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.fault import elastic_restore
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    jm = ref_build(ref_smoke("minitron-8b"))
    flat = _flat_np(jm.init(jax.random.PRNGKey(0)))
    tree = {}
    for k, v in flat.items():
        node = tree
        for part in k.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[k.split("/")[-1]] = v
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(5, {"params": params_from_numpy(tree)})
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        params, aux, step = elastic_restore(ckpt, build_model(get_smoke_config("minitron-8b")),
                                            mesh)
        pspecs, _ = _ref_placements((1, 1))
        assert step == 5
        for path, t in flatten(params):
            key = "/".join(path)
            assert tuple(t.placements) == to_placements(pspecs[key], mesh)
            assert t.to_local().shape == t.shape          # a one-device split is whole
            np.testing.assert_array_equal(t.to_local().numpy(), flat[key])
    finally:
        dist.destroy_process_group()


def test_train_step_on_2x2_matches_the_single_process_step(ranks):
    outs, _ = ranks
    for out in outs:
        t = out["train"]
        assert abs(t["loss"][0] - t["loss"][1]) <= 1e-5, t
        assert abs(t["grad_norm"][0] - t["grad_norm"][1]) <= 1e-5, t
        assert t["grad_err"] <= 1e-5, t        # each leaf's, relative to its largest
        assert t["param_err"] <= 1e-5, t
        assert t["moved"] > 5e-5, t            # the step did move the params
        assert t["same_placements"]


@pytest.mark.parametrize("name", ["grok", "deepseek", "grok_dff"])
def test_shard_map_moe_on_4_ranks_matches_reference_and_plain(ranks, name):
    outs, _ = ranks
    for out in outs:
        m = out[f"moe_{name}"]
        assert m["calls"] and all(m["calls"]), m        # every MoE block went through it
        assert m["plain_vs_ref"] < 1e-4, m
        assert m["vs_ref"] < 1e-4, m
        assert m["vs_plain"] < 1e-4, m
        assert m["grad_rel"] < 1e-4, m
        assert not m["unused"], m


@pytest.mark.parametrize("case", ["rmsnorm_rows", "rmsnorm_last_dim", "rmsnorm_partial",
                                  "flash_heads", "flash_gqa_mismatch", "flash_plain_k",
                                  "ssd_batch", "ssd_heads"])
def test_kernel_wrappers_on_dtensors_match_plain(ranks, case):
    """Each wrapper on DTensors of the (2, 2) mesh against its plain
    version on the whole tensors, forward and every input's gradient,
    float32 within 1e-5 of max(1, |value|): rows and batch kept split,
    heads split alike on q and kv, and the layouts gathered first (the
    last dim, q's heads split where kv's are not, a plain k, a partial
    sum)."""
    for out in ranks[0]:
        assert out[case] <= 1e-5, (case, out[case])


def test_serving_kernels_refuse_dtensors(ranks):
    """decode_attention, paged_attention and awq_matmul refuse DTensors on
    the card only (``tests/test_torch_cuda.py``): on DTensors of CPU
    shards, as on the dry-run's meta DTensors, they run their plain
    versions as DTensor ops, equal to the plain versions on the whole
    tensors within 1e-5 of max(1, |value|)."""
    for out in ranks[0]:
        assert out["serving_plain"] <= 1e-5, out["serving_plain"]
