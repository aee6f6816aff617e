"""One rank of the port's multi-rank CPU checks (gloo), started by
``tests/test_torch_distributed.py``:

    python tests/_torch_dist_worker.py RANK WORLD DIR

``DIR`` holds what the parent process prepared with the JAX package
(a checkpoint of the reference's smoke params, their values, the MoE
smokes' params, tokens and single-device logits); each rank writes its
findings to ``DIR/rank{RANK}.json``. With WORLD 4 every scenario runs
on the ranks of one process group: the kernel wrappers on DTensors,
elastic restore and a train step on a (2, 2) ("data", "model") mesh, the shard_map MoE dispatch on (2, 2) (the
expert-parallel regime) and on (1, 4) (the d_ff-parallel regime). With
WORLD 2 it is the analyzer's known program (``tests/test_torch_analysis.py``).
This file imports no JAX.
"""

import datetime
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def launch(world: int, d: Path, wall_s: float) -> list:
    """Start ``world`` ranks of this script on ``d`` and wait for them all
    within ``wall_s`` seconds, killing them past it. Returns each rank's
    findings; raises AssertionError with the failing rank's output."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-W", "ignore::FutureWarning", __file__,
                               str(r), str(world), str(d)], env=env, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    t0, logs = time.monotonic(), []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, wall_s - (time.monotonic() - t0)))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"the {world} ranks did not finish within {wall_s} s")
    outs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        f = d / f"rank{r}.json"
        out = json.loads(f.read_text()) if f.exists() else {}
        if p.returncode != 0 or "error" in out:
            raise AssertionError(f"rank {r} failed:\n{out.get('error', '')}\n{log[-3000:]}")
        outs.append(out)
    return outs


def nested(flat):
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def elastic(d, mesh, out):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.fault import elastic_restore
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten
    from repro_torch.training.checkpoint import CheckpointManager

    model = build_model(get_smoke_config("minitron-8b"))
    params, aux, step = elastic_restore(CheckpointManager(str(d / "ckpt")), model, mesh)
    want = np.load(d / "ref_params.npz")
    leaves = {}
    for path, t in flatten(params):
        key = "/".join(path)
        leaves[key] = {"placements": [repr(p) for p in t.placements],
                       "local": list(t.to_local().shape),
                       "err": float(np.abs(full(t).numpy() - want[key]).max())}
    out["elastic"] = {"leaves": leaves, "aux": aux, "step": step}


def train(d, mesh, out):
    """One train step of the smoke minitron on the mesh (params restored
    onto it, grad_shardings its placements) against the same step on
    plain tensors, and the two gradients. Adam's first step divides each
    gradient by its own size, so a rounding difference dg (the mesh sums
    partial products in another order) moves a weight by about
    lr * dg / (|g| + eps): at lr 1e-4 that stays inside 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.fault import elastic_restore, shardings_for_mesh
    from repro_torch.distributed.sharding import DEFAULT_RULES, axis_rules, use_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import flatten, tree_map, tree_unflatten
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optim import adamw_init

    cfg = get_smoke_config("minitron-8b").replace(compute_dtype="float32")
    model = build_model(cfg)
    oc = AdamWConfig(lr=1e-4, warmup_steps=0)
    dparams, _, _ = elastic_restore(CheckpointManager(str(d / "ckpt")), model, mesh)
    plain = tree_map(lambda t: full(t).clone(), dparams)
    start = tree_map(lambda t: t.clone(), plain)
    batch = {"tokens": torch.from_numpy(np.load(d / "train_tokens.npy"))}

    def grads(ps):
        live = [t.detach().requires_grad_() for _, t in flatten(ps)]
        loss, _ = model.loss(tree_unflatten(ps, live), batch)
        return [full(g) for g in torch.autograd.grad(loss, live)]

    with axis_rules(DEFAULT_RULES), use_mesh(mesh):
        g2 = grads(dparams)
    grad_err = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                   for a, b in zip(grads(plain), g2))
    p1, _, m1 = make_train_step(model, oc)(plain, adamw_init(plain), batch)
    step = make_train_step(model, oc, grad_shardings=shardings_for_mesh(model, mesh))
    dopt = adamw_init(dparams)
    with axis_rules(DEFAULT_RULES), use_mesh(mesh):
        p2, o2, m2 = step(dparams, dopt, batch)
    out["train"] = {
        "loss": [float(m1["loss"]), float(m2["loss"])],
        "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
        "grad_err": grad_err,
        "param_err": max(float((full(b) - a).abs().max())
                         for (_, a), (_, b) in zip(flatten(p1), flatten(p2))),
        "moved": max(float((b - a).abs().max())
                     for (_, a), (_, b) in zip(flatten(start), flatten(p1))),
        "same_placements": all(tuple(b.placements) == tuple(m.placements) for (_, b), (_, m)
                               in zip(flatten(p2), flatten(o2["mu"]))),
    }


def moe(d, mesh, out, name):
    """The MoE smoke's forward and gradients through the shard_map
    dispatch on ``mesh`` against the plain dispatch on plain tensors and
    the reference's single-device logits."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.fault import shardings_for_mesh
    from repro_torch.distributed.sharding import DEFAULT_RULES, axis_rules, use_mesh
    from repro_torch.models import build_model, moe as moe_mod
    from repro_torch.models.common import flatten, tree_map
    from repro_torch.models.interop import params_from_numpy

    z = np.load(d / f"moe_{name}.npz")
    meta = json.loads(str(z["meta"]))
    cfg = get_smoke_config(meta["arch"]).replace(**meta["overrides"])
    params = params_from_numpy(nested({k[2:]: z[k] for k in z.files if k.startswith("p/")}),
                               device="cpu")
    toks = torch.from_numpy(z["tokens"])
    probe = torch.from_numpy(z["probe"])

    def value_and_grads(model, ps):
        live = tree_map(lambda t: t.detach().requires_grad_(), ps)
        logits = model.forward(live, toks)
        loss = (logits * probe).sum()
        leaves = [t for _, t in flatten(live)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return full(logits).detach(), [None if g is None else full(g) for g in grads]

    plain_logits, plain_grads = value_and_grads(build_model(cfg), params)
    sm_cfg = cfg.replace(moe_dispatch="shard_map", capacity_factor=8.0,
                         eval_capacity_factor=8.0)
    sm_model = build_model(sm_cfg)
    dparams = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), params,
                       shardings_for_mesh(sm_model, mesh))
    calls = []
    inner = moe_mod.moe_mlp_shard_map

    def counted(*a, **k):
        y = inner(*a, **k)
        calls.append(y is not None)
        return y

    moe_mod.moe_mlp_shard_map = counted
    try:
        with axis_rules(DEFAULT_RULES), use_mesh(mesh):
            sm_logits, sm_grads = value_and_grads(sm_model, dparams)
    finally:
        moe_mod.moe_mlp_shard_map = inner
    ref = torch.from_numpy(z["logits"])
    gerr = max(float((a - b).abs().max()) / max(1.0, float(a.abs().max()))
               for a, b in zip(plain_grads, sm_grads) if a is not None)
    out[f"moe_{name}"] = {
        "vs_ref": float((sm_logits - ref).abs().max()),
        "plain_vs_ref": float((plain_logits - ref).abs().max()),
        "vs_plain": float((sm_logits - plain_logits).abs().max()),
        "grad_rel": gerr, "calls": calls,
        "unused": [i for i, (a, b) in enumerate(zip(plain_grads, sm_grads))
                   if (a is None) != (b is None)],
    }


def wrappers(mesh, out):
    """rmsnorm, flash_attention and ssd on DTensors against their plain
    versions on the whole tensors, forward and gradients: splits the
    wrappers keep (rows, batch, heads that divide Hq and Hkv) and ones
    they gather first (the last dim, q's heads split where kv's are not,
    a partial sum); the serving kernels take their plain versions on
    DTensors of CPU shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor

    from repro_torch.kernels import (awq_matmul, decode_attention, flash_attention,
                                     paged_attention, rmsnorm, ssm_scan)

    g = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def check(name, fn, plain_fn, inputs, placements):
        """max |diff| of outputs and of every input's gradient, each over
        max(1, its largest |value|)."""
        ref_in = [t.clone().requires_grad_() for t in inputs]
        d_in = [distribute_tensor(t.clone(), mesh, pl).requires_grad_()
                if pl is not None else t.clone().requires_grad_()
                for t, pl in zip(inputs, placements)]
        want = plain_fn(*ref_in)
        got = fn(*d_in)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        probes = [rnd(*w.shape) for w in want]
        sum(((w * p).sum() for w, p in zip(want, probes))).backward()
        sum(((full(gt) * p).sum() for gt, p in zip(got, probes))).backward()
        pairs = list(zip(got, want)) + [(d.grad, r.grad) for d, r in zip(d_in, ref_in)]
        out[name] = max(float((full(a) - b).abs().max()) / max(1.0, float(b.abs().max()))
                        for a, b in pairs)

    x, w = rnd(4, 6, 8), rnd(8)
    for name, pl in (("rows", [Shard(0), Shard(1)]), ("last_dim", [Shard(2), Replicate()])):
        check(f"rmsnorm_{name}", lambda a, b: rmsnorm.rmsnorm(a, b),
              lambda a, b: rmsnorm.plain(a, b), (x, w), (pl, [Replicate(), Replicate()]))
    q, k, v = rnd(4, 4, 8, 16), rnd(4, 2, 8, 16), rnd(4, 2, 8, 16)
    both = [Shard(0), Shard(1)]
    for name, pls in (("heads", (both, both, both)),
                      ("gqa_mismatch", (both, [Shard(0), Replicate()], [Shard(0), Replicate()])),
                      ("plain_k", (both, None, both))):
        check(f"flash_{name}", lambda a, b, c: flash_attention.flash_attention(a, b, c),
              lambda a, b, c: flash_attention.plain(a, b, c), (q, k, v), pls)
    b_, T, H, P, N = 4, 32, 2, 16, 16
    sx, sdt = rnd(b_, T, H, P), 0.01 + 0.1 * torch.rand((b_, T, H), generator=g)
    sA, sB, sC, sD = -1.0 - torch.rand(H, generator=g), rnd(b_, T, N), rnd(b_, T, N), rnd(H)
    bat, rep = [Shard(0), Replicate()], [Replicate(), Replicate()]
    check("ssd_batch", lambda *a: ssm_scan.ssd(*a, chunk=16),
          lambda *a: ssm_scan.plain(*a, chunk=16), (sx, sdt, sA, sB, sC, sD),
          (bat, bat, rep, bat, bat, rep))
    check("ssd_heads", lambda *a: ssm_scan.ssd(*a, chunk=16),
          lambda *a: ssm_scan.plain(*a, chunk=16), (sx, sdt, sA, sB, sC, sD),
          ([Shard(0), Shard(2)], [Shard(0), Shard(2)], [Replicate(), Shard(0)], bat, bat,
           [Replicate(), Shard(0)]))
    # a partial sum reaches rmsnorm: reduced before the rows are normalised
    part = distribute_tensor(x, mesh, [Shard(0), Replicate()]).redistribute(
        mesh, [Shard(0), Replicate()])
    half = torch.distributed.tensor.DTensor.from_local(
        part.to_local() / 2, mesh, [Shard(0), Partial()], run_check=False)
    out["rmsnorm_partial"] = float((full(rmsnorm.rmsnorm(half, w)) - rmsnorm.plain(x, w))
                                   .abs().max())
    # the serving kernels on DTensors of CPU shards take their plain
    # versions as DTensor ops under the mesh (the card refuses them): q's
    # heads split over "model" where they group by kv head, the cache's
    # positions split
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.kernels.ref import awq_pack

    q, k, v = rnd(4, 4, 1, 16), rnd(4, 2, 8, 16), rnd(4, 2, 8, 16)
    kp, vp = rnd(6, 2, 4, 16), rnd(6, 2, 4, 16)
    tables = torch.tensor([[0, 1], [2, 3], [4, 5], [1, 0]], dtype=torch.int32)
    x = rnd(4, 128)
    qw = awq_pack(torch.randint(0, 16, (128, 32), generator=g))
    sc, zs = rnd(1, 32).abs() + 0.1, torch.full((1, 32), 8.0)
    seq = [Shard(0), Shard(2)]
    errs = []
    with torch.no_grad(), use_mesh(mesh):   # the plain masks meet DTensors as replicated
        for fn, plain_fn, args, pls in (
                (decode_attention.decode_attention, decode_attention.plain, (q, k, v),
                 (both, seq, seq)),
                (lambda *a: paged_attention.paged_attention(*a, block_tables=tables,
                                                            kv_len=7),
                 lambda *a: paged_attention.plain(*a, block_tables=tables, kv_len=7),
                 (q, kp, vp), (both, [Replicate(), Shard(1)], [Replicate(), Shard(1)])),
                (lambda *a: awq_matmul.awq_matmul(*a, group_size=128),
                 lambda *a: awq_matmul.plain(*a, group_size=128), (x, qw, sc, zs),
                 ([Shard(0), Replicate()], None, None, None))):
            kw = {"kv_len": 5} if fn is decode_attention.decode_attention else {}
            d_args = [distribute_tensor(t, mesh, pl) if pl is not None else t
                      for t, pl in zip(args, pls)]
            got, want = fn(*d_args, **kw), plain_fn(*args, **kw)
            errs.append(float((full(got) - want).abs().max()) / max(1.0, float(want.abs().max())))
    out["serving_plain"] = max(errs)


def analysis(out):
    """``analyze_step`` over a known program on a group of two ranks:
    functional collectives, a DTensor gathered whole, a sharded matmul."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.analysis import analyze_step

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    group = (mesh, 0)
    x = distribute_tensor(torch.ones(6, 8), mesh, [Shard(0)])
    w = distribute_tensor(torch.ones(8, 4), mesh, [Replicate()])

    def program():
        funcol.all_reduce(torch.ones(4, 8), "sum", group).wait()
        funcol.all_gather_tensor(torch.ones(2, 8), 0, group).wait()
        funcol.reduce_scatter_tensor(torch.ones(4, 8), "sum", 0, group).wait()
        funcol.all_to_all_single(torch.ones(4, 8), None, None, group).wait()
        y = x @ w                                   # (3, 8) @ (8, 4) on each rank
        return x.redistribute(mesh, [Replicate()]).to_local(), y

    out["analysis"] = analyze_step(program)


def main():
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    from torch.distributed.device_mesh import init_device_mesh
    torch.manual_seed(0)
    out = {}
    try:
        if world == 2:
            analysis(out)
        else:
            m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
            wrappers(m22, out)
            elastic(d, m22, out)
            train(d, m22, out)
            moe(d, m22, out, "grok")
            moe(d, m22, out, "deepseek")
            moe(d, m14, out, "grok_dff")
    except Exception:
        out["error"] = traceback.format_exc()
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        raise
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
