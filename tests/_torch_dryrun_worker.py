"""The fake-world checks of ``tests/test_torch_dryrun.py``, in a process
of their own (a fake process group must never meet another test's):

    python tests/_torch_dryrun_worker.py OUT.json

Writes each scenario's findings to OUT.json: the card's dry-run anchor on
a (1, 1) gloo mesh at smoke size, the production mesh with no world and
on fake worlds of 256 and 512 ranks, the analyzer's count of a
known Shard(0) -> Shard(1) redistribution on a fake world of 4, the two
shortcuts of the dry-run's walk against whole walks at smoke size, and a
few full-size cells cut in depth. This file imports no JAX.
"""

import json
import sys
import time
import traceback


def anchor(out):
    """What the card's dry-run anchor checks, on a (1, 1) gloo mesh at
    smoke size: the record's argument bytes against the params, AdamW
    state and batch that a real step on the mesh holds, and its FLOPs
    against analyze_step of the loss's gradient on plain meta tensors."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.distributed.fault import shardings_for_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import analyze_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, shape_tree
    from repro_torch.models.common import flatten, tree_map
    from repro_torch.training import adamw_init

    mesh = make_local_mesh("cpu")
    cfg = get_smoke_config("minitron-8b", compute_dtype="bfloat16")
    model = build_model(cfg)
    params = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), model.init(0, "cpu"),
                      shardings_for_mesh(model, mesh))
    batch = {"tokens": torch.zeros(2, 17, dtype=torch.int32)}
    held = dryrun.local_bytes((params, adamw_init(params), batch))

    def grad_step(ps, b):
        leaves = [t.requires_grad_() for _, t in flatten(ps)]
        loss, _ = model.loss(ps, b)
        return torch.autograd.grad(loss, leaves)

    counted = analyze_step(grad_step, shape_tree(model.param_defs(), cfg.pdtype()),
                           {"tokens": torch.empty(2, 17, dtype=torch.int64, device="meta")})
    cell = ShapeCell("anchor", 16, 2, "train")
    rec = dryrun.cell_record("minitron-8b", cfg, cell, mesh, "1x1",
                             dryrun.rules_for(cfg, cell, mesh), accum_steps=1)
    out["anchor"] = {"held": held, "args": rec["mem_argument_bytes"],
                     "counted": counted["flops"], "flops": rec["hlo_flops_per_device"],
                     "coll": rec["collective_bytes_total_per_device"]}
    dist.destroy_process_group()


def production_mesh(out):
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    try:
        make_production_mesh()
        out["no_world"] = "no error"
    except RuntimeError as e:
        out["no_world"] = str(e)
    for n, multi in ((256, False), (512, True)):
        dryrun.fake_world(n)
        mesh = make_production_mesh(multi_pod=multi)
        out[f"mesh{n}"] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                           "type": mesh.device_type, "backend": dist.get_backend()}
    try:
        make_production_mesh()            # 512 ranks, the single-pod mesh needs 256
        out["wrong_world"] = "no error"
    except RuntimeError as e:
        out["wrong_world"] = str(e)


def all_to_all(out):
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import analyze_step
    from repro_torch.launch.mesh import _mesh_device_type

    dryrun.fake_world(4)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(_mesh_device_type(), (4,), mesh_dim_names=("model",))
    x = dryrun.sharded_meta(torch.empty(8, 12, device="meta"), (Shard(0),), mesh)
    box = []
    counts = analyze_step(lambda: box.append(x.redistribute(mesh, (Shard(1),))))
    out["a2a"] = {"counts": counts, "local": list(box[0].to_local().shape),
                  "type": mesh.device_type}


def shortcuts(out):
    """Each shortcut against the whole walk on the 16 x 16 fake world, at
    smoke size: minitron training (microbatches), xLSTM training (both)
    and prefill (the affine fit)."""
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    dryrun.fake_world(256)
    mesh = make_production_mesh()
    dryrun.SSM_WALK_LENGTHS = (4, 8)      # shorter walks, the same fit
    keys = ("hlo_flops_per_device", "collective_bytes_total_per_device",
            "collective_bytes_by_kind", "collective_op_counts", "mem_argument_bytes",
            "mem_output_bytes")
    for name, arch, cell, accum in (
            ("minitron_train", "minitron-8b", ShapeCell("t", 64, 64, "train"), 4),
            ("xlstm_train", "xlstm-125m", ShapeCell("t", 13, 32, "train"), 2),
            ("xlstm_prefill", "xlstm-125m", ShapeCell("p", 13, 16, "prefill"), None)):
        cfg = get_smoke_config(arch, compute_dtype="bfloat16")
        rules = dryrun.rules_for(cfg, cell, mesh)
        got = {}
        for scale in (True, False):
            part = dryrun.cell_step(cfg, cell, mesh, rules, accum_steps=accum, scale=scale)
            got[str(scale)] = {k: part[k] for k in keys + ("scaled", "accum_steps")}
        out[name] = got


def cells(out):
    """Full-size cells on the 16 x 16 fake world, cut in depth."""
    from repro_torch.launch import dryrun

    dryrun.SSM_WALK_LENGTHS = (16, 32)
    for arch, shape, ov in (("minitron-8b", "decode_32k", {"n_layers": 2}),
                            ("deepseek-v2-lite-16b", "prefill_32k", {"n_layers": 2}),
                            ("grok-1-314b", "prefill_32k", {"n_layers": 1}),
                            ("xlstm-125m", "prefill_32k", {"n_layers": 4}),
                            ("zamba2-7b", "long_500k", {"n_layers": 6})):
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False,
                              config_overrides=ov)
        rec["walk_wall_s"] = time.time() - t0
        out[f"{arch}/{shape}"] = rec


def main(path):
    out = {}
    for scenario in (anchor, production_mesh, all_to_all, shortcuts, cells):
        t0 = time.time()
        try:
            scenario(out)
        except Exception:
            out["error"] = f"{scenario.__name__}: {traceback.format_exc()}"
            break
        out.setdefault("seconds", {})[scenario.__name__] = time.time() - t0
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
