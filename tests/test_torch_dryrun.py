"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``), held
against the JAX package's ``launch/dryrun.py``: the per-cell rules, the
abstract inputs and the accumulation choice for every (arch, cell, mesh)
against the reference's functions on JAX abstract meshes, and the
record's keys against the reference's. The process groups run in a
process of their own (``tests/_torch_dryrun_worker.py``, one run for the
module): the card's anchor on a one-device mesh, the production mesh,
the analyzer's count of an all-to-all, the walk's two shortcuts against
whole walks at smoke size, and full-size cells cut in depth (a dense
decode, two MoE prefills, an xLSTM and a zamba2 cell)."""

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402

_xla_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref  # noqa: E402  (appends a device count to XLA_FLAGS)

if _xla_flags is None:                  # this process's JAX keeps its own devices
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla_flags

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for  # noqa: E402
from repro_torch.distributed.sharding import (make_abstract_mesh,  # noqa: E402
                                              spec_tree_to_shardings)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.train import microbatch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER_WALL_S = 150
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    try:
        p = subprocess.run([sys.executable, "-W", "ignore", str(ROOT / "tests" /
                                                               "_torch_dryrun_worker.py"),
                            str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=WORKER_WALL_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the dry-run worker did not finish within {WORKER_WALL_S} s")
    got = json.loads(out.read_text()) if out.exists() else {}
    if p.returncode != 0 or "error" in got:
        raise AssertionError(f"{got.get('error', '')}\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    got["wall_s"] = time.monotonic() - t0
    return got


@pytest.mark.parametrize("arch", list_archs())
def test_rules_inputs_and_accumulation_equal_the_reference(arch):
    cells = shapes_for(arch)
    assert [c.name for c in cells] == [c.name for c in ref.shapes_for(arch)]
    for mesh_name, (sizes, names) in MESHES.items():
        jmesh = jax.sharding.AbstractMesh(sizes, names)
        mesh = make_abstract_mesh(sizes, names)
        assert dryrun.n_dev_of(mesh) == ref.n_dev_of(jmesh)
        for cell in cells:
            where = (mesh_name, cell.name)
            cfg, rcfg = get_config(arch), ref_config(arch)
            assert dryrun.rules_for(cfg, cell, mesh) == ref.rules_for(rcfg, cell, jmesh), where
            got, want = dryrun.input_specs(cfg, cell), ref.input_specs(rcfg, cell)
            assert list(got) == list(want), where
            for k, (t, logical) in got.items():
                w, wlogical = want[k]
                assert t.device.type == "meta", where
                assert tuple(t.shape) == tuple(w.shape), (where, k)
                assert str(t.dtype).removeprefix("torch.") == str(w.dtype), (where, k)
                assert logical == wlogical, (where, k)
            if cell.kind == "train":
                dp = ref.n_dev_of(jmesh) // dict(jmesh.shape)["model"]
                assert dryrun.accum_for(cell, mesh) == max(
                    max(cell.global_batch // dp, 1) // 2, 1), where


def _reference_record_keys():
    """The keys of the record the reference's run_cell builds, read from
    its source (its own run fails on this JAX)."""
    tree = ast.parse(Path(ref.__file__).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    keys = {k.value for k in rec.keys if k is not None}
    return keys | {"roofline"}


def test_record_has_the_reference_keys(worker):
    from repro.launch.analysis import analytic_costs

    want = _reference_record_keys() | set(analytic_costs(ref_config("minitron-8b"),
                                                         SHAPES["decode_32k"]))
    rec = worker["minitron-8b/decode_32k"]
    assert set(rec) - {"walk_wall_s"} == want | {"scaled"}
    for k in ("compile_s", "xla_flops_per_device_scan_once", "n_while_loops", "scaled"):
        assert rec[k] is None, k
    assert rec["mem_temp_bytes"] > 0         # MemTracker over the whole walk
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck",
                                    "step_time_bound_s", "model_flops_ratio", "mfu_bound"}


def test_anchor_on_a_one_device_mesh(worker):
    """chip_smoke's dry-run anchor at smoke size on a (1, 1) gloo mesh: the
    record's argument bytes are what a real step's params, AdamW state
    and batch hold, to the byte, and its FLOPs are analyze_step's count
    of the loss's gradient on plain meta tensors; a world of one moves
    nothing."""
    a = worker["anchor"]
    assert a["args"] == a["held"] > 0
    assert a["flops"] == a["counted"] > 0
    assert a["coll"] == 0


def test_production_mesh_on_fake_worlds(worker):
    assert "needs a process group of 256 ranks" in worker["no_world"]
    assert worker["mesh256"] == {"shape": [16, 16], "names": ["data", "model"],
                                 "type": "cuda", "backend": "fake"}
    assert worker["mesh512"] == {"shape": [2, 16, 16], "names": ["pod", "data", "model"],
                                 "type": "cuda", "backend": "fake"}
    assert "needs a process group of 256 ranks" in worker["wrong_world"]


def test_analyzer_counts_dtensors_all_to_all(worker):
    """(8, 12) float32 Shard(0) -> Shard(1) over 4 ranks on a "cuda" mesh:
    one all-to-all whose output, (8, 3) on each rank, is 96 bytes, and
    no all-gather (a "cpu" mesh would gather)."""
    a = worker["a2a"]
    assert a["type"] == "cuda" and a["local"] == [8, 3]
    assert a["counts"]["collective_bytes"] == {"all-gather": 0, "all-reduce": 0,
                                               "reduce-scatter": 0, "all-to-all": 96,
                                               "collective-permute": 0}
    assert a["counts"]["collective_op_counts"]["all-to-all"] == 1


@pytest.mark.parametrize("case", ["minitron_train", "xlstm_train", "xlstm_prefill"])
def test_walk_shortcuts_equal_the_whole_walk(worker, case):
    """One microbatch counted accum times plus the update, and the xLSTM's
    affine fit over two short lengths, give exactly the whole walk's
    FLOPs, collective bytes and counts, and memory."""
    short, whole = worker[case]["True"], worker[case]["False"]
    assert whole["scaled"] is None and short["scaled"] is not None
    if case != "xlstm_prefill":
        assert short["scaled"]["microbatches"] == {"walked": 1,
                                                   "counted": short["accum_steps"]}
    if case.startswith("xlstm"):
        assert short["scaled"]["seq_len"]["fit"] == "affine"
    for k in whole:
        if k != "scaled":
            assert short[k] == whole[k], (k, short[k], whole[k])
    assert whole["hlo_flops_per_device"] > 0 and whole["collective_bytes_total_per_device"] > 0


@pytest.mark.parametrize("cell", ["minitron-8b/decode_32k", "deepseek-v2-lite-16b/prefill_32k",
                                  "grok-1-314b/prefill_32k", "xlstm-125m/prefill_32k",
                                  "zamba2-7b/long_500k"])
def test_full_size_cells_cut_in_depth(worker, cell):
    rec = worker[cell]
    arch, shape = cell.split("/")
    assert rec["ok"] and (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "16x16")
    assert rec["n_devices"] == 256 and rec["hlo_flops_per_device"] > 0
    assert rec["collective_bytes_total_per_device"] == sum(
        rec["collective_bytes_by_kind"].values()) > 0
    assert rec["mem_argument_bytes"] > 0 and rec["mem_output_bytes"] > 0
    assert rec["roofline"]["step_time_bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    assert (rec["scaled"] is not None) == arch.startswith("xlstm")
    # a peak is read over a whole walk only: the shortcuts extrapolate counts
    assert (rec["mem_temp_bytes"] is None) == arch.startswith("xlstm")


def test_spec_tree_to_shardings_walks_tuples_and_shapeless_leaves():
    """The xLSTM's cache nests tuples of specs; "pos" has no shape."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_config("xlstm-125m", n_layers=4)
    model = build_model(cfg)
    like = model.init_cache(32, 64, device="meta")
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    got = spec_tree_to_shardings(model.cache_specs(), like, mesh,
                                 dryrun.rules_for(cfg, SHAPES["decode_32k"], mesh))
    assert got["pos"] == (Replicate(), Replicate())
    assert isinstance(got["states"]["l0"], tuple) and len(got["states"]["l0"]) == 4
    # mLSTM conv window (B, 3, u): batch over data, u over model
    assert got["states"]["l0"][0] == (Shard(0), Shard(2))
    # sLSTM (B, H, dh), H = 4 does not divide over 16: batch only
    assert got["states"]["l3"] == ((Shard(0), Replicate()),) * 4


def test_microbatch_of_plain_tensors_is_a_slice():
    batch = {"tokens": torch.arange(24).reshape(8, 3), "extra": {"v": torch.ones(8, 2)}}
    mb = microbatch(batch, 2, 4)
    assert torch.equal(mb["tokens"], batch["tokens"][4:6])
    assert mb["extra"]["v"].shape == (2, 2)
