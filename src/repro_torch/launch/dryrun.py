"""Multi-pod dry-run: walk every (arch x shape x mesh) cell on a fake
world of H100s (the JAX package's ``launch/dryrun.py``).

For each cell this:
  1. builds the FULL-size model config; params, optimizer state, batch
     and cache are meta DTensors laid out by the logical-axis rules on the
     production mesh (single-pod 16x16 or multi-pod 2x16x16, over torch's
     fake process group of 256 or 512 ranks): each is a meta shard of its
     local shape, so nothing is allocated;
  2. runs the train step, ``prefill`` or ``decode_step`` as the shape
     cell dictates, once, under ``analysis.analyze_step``: DTensor runs
     every op and issues the collectives NCCL would, on meta tensors, and
     the kernel wrappers take their plain versions;
  3. reads the per-device matmul FLOPs and collective bytes by kind, the
     local shards' bytes, and the roofline terms on the H100's data sheet;
  4. appends a JSON record to --out, with the JAX package's keys.

Where the JAX package compiles, this walks: ``compile_s``,
``xla_flops_per_device_scan_once`` and ``n_while_loops`` are null, and
``mem_temp_bytes`` is MemTracker's peak over the walk of the plain
versions (null where the walk was cut short). Two exact shortcuts keep a
walk short, each stated under ``scaled`` (null when the whole step was
walked): a training cell walks one microbatch's forward and backward and
counts it ``accum_steps`` times, then the rest of the step (the
accumulation and AdamW) once; the xLSTM (family "ssm"), whose time loop
makes its counts affine in the sequence length, walks two short lengths
and extrapolates. Families with attention walk whole.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.jsonl
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, ShapeCell, get_config, list_archs, shapes_for
from repro_torch.distributed.sharding import (DEFAULT_RULES, _mesh_axis_sizes, axis_rules,
                                              logical_to_pspec, spec_tree_to_shardings,
                                              to_placements, use_mesh)
from repro_torch.launch.analysis import (COLL_KINDS, analytic_costs, analyze_step,
                                         roofline_terms)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.common import count_params, shape_tree, spec_tree, tree_map
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train import make_train_step, microbatch

# the two sequence lengths the xLSTM's affine extrapolation walks
SSM_WALK_LENGTHS = (16, 32)

# ---------------------------------------------------------------------------
# per-cell sharding rules
# ---------------------------------------------------------------------------


def n_dev_of(mesh) -> int:
    return math.prod(_mesh_axis_sizes(mesh).values())


def rules_for(cfg, cell, mesh):
    rules = dict(DEFAULT_RULES)
    rules["embed"] = ("pod", "data")          # ZeRO-3-style FSDP on params
    msize = _mesh_axis_sizes(mesh)["model"]
    if cell.kind == "decode":
        if cell.global_batch == 1:
            rules["kv_seq"] = ("data",)        # long-context: shard the cache seq
        elif cfg.use_mla or (cfg.n_kv_heads % msize != 0):
            rules["kv_seq"] = ("model",)       # few KV heads: shard cache seq on TP
    return rules


def accum_for(cell, mesh) -> int:
    """Microbatches of a training cell: at most 2 sequences per device per
    microbatch, so that per-device activations fit in HBM."""
    dp = n_dev_of(mesh) // _mesh_axis_sizes(mesh)["model"]
    per_dev = max(cell.global_batch // dp, 1)
    return max(per_dev // 2, 1)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, cell):
    """Meta stand-ins + logical axes for every model input:
    {name: (meta tensor, logical axes)}."""
    B, S = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cell.kind == "train":
        # S+1 tokens: the loss shifts by one, so the TRAINED width is S
        specs = {"tokens": (_meta((B, S + 1), i32), ("batch", None))}
    elif cell.kind == "prefill":
        specs = {"tokens": (_meta((B, S), i32), ("batch", None))}
    else:  # decode: one new token against a seq_len cache
        specs = {"token": (_meta((B, 1), i32), ("batch", None))}
    if cfg.family == "vlm":
        specs["vision"] = (_meta((B, cfg.n_image_tokens, cfg.vision_dim), bf16),
                           ("batch", None, None))
    if cfg.is_encoder_decoder:
        specs["frames"] = (_meta((B, cfg.encoder_seq_len, cfg.d_model), bf16),
                           ("batch", None, None))
    return specs


def _extra_from_specs(specs):
    extra = {k: specs[k][0] for k in ("vision", "frames") if k in specs}
    return extra or None


# ---------------------------------------------------------------------------
# meta DTensors
# ---------------------------------------------------------------------------


def sharded_meta(like, placements, mesh):
    """A DTensor of ``like``'s shape and dtype on ``mesh`` at
    ``placements``, over a meta shard of the local shape: nothing is
    allocated. A leaf that is not a tensor (the cache's "pos") stays."""
    if not isinstance(like, torch.Tensor):
        return like
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(like.shape, mesh, placements)
    return DTensor.from_local(_meta(local, like.dtype), mesh, placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def lay_out(like, shardings, mesh):
    """:func:`sharded_meta` over a tree: ``like``'s dicts, tuples and lists
    (the xLSTM's cache) matched by ``shardings``' nodes."""
    if isinstance(like, dict):
        return {k: lay_out(v, shardings[k], mesh) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(lay_out(v, s, mesh) for v, s in zip(like, shardings))
    return sharded_meta(like, shardings, mesh)


def _placements_of(logical, like, mesh, rules):
    return to_placements(logical_to_pspec(logical, like.shape, mesh, rules), mesh)


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on one device: a DTensor's local
    shard, a plain tensor whole; other leaves count nothing."""
    def one(t):
        if isinstance(t, DTensor):
            t = t.to_local()
        return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    return one(tree)


# ---------------------------------------------------------------------------
# walking a step
# ---------------------------------------------------------------------------


def _walk(fn, peak=None):
    """(analyze_step's counts, the step's result) of one call of ``fn``.
    With a ``peak`` list, ``MemTracker`` follows the walk and the peak
    bytes it saw allocated on a device, over what existed before the
    walk (the arguments), are appended to it."""
    box = []
    if peak is None:
        return analyze_step(lambda: box.append(fn())), box[0]
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    with tracker:
        counts = analyze_step(lambda: box.append(fn()))
    peak.append(max((d["Total"] for d in tracker.get_tracker_snapshot("peak").values()),
                    default=0))
    return counts, box[0]


def combine(terms):
    """sum(k * counts) over ``terms`` [(k, counts), ...]: counts with
    analyze_step's keys; bytes and op counts stay integers (each k is a
    whole number, or the exact slope of an affine extrapolation)."""
    out = {"flops": 0.0, "collective_bytes": dict.fromkeys(COLL_KINDS, 0),
           "collective_op_counts": dict.fromkeys(COLL_KINDS, 0)}
    for k, c in terms:
        out["flops"] += k * c["flops"]
        for kind in COLL_KINDS:
            out["collective_bytes"][kind] += k * c["collective_bytes"][kind]
            out["collective_op_counts"][kind] += k * c["collective_op_counts"][kind]
    for key in ("collective_bytes", "collective_op_counts"):
        for kind, v in out[key].items():
            if v != int(v):
                raise ArithmeticError(f"{key}[{kind}] = {v} is not whole: the counts "
                                      "are not affine in what was scaled")
            out[key][kind] = int(v)
    out["collective_bytes_total"] = sum(out["collective_bytes"].values())
    return out


def _affine(walk, lengths, target):
    """Counts at sequence length ``target`` from ``walk(T)`` at two
    ``lengths``, the counts being affine in T: c(T1) + (target - T1) *
    (c(T2) - c(T1)) / (T2 - T1). Returns (counts, the walk at T1's result)."""
    t1, t2 = lengths
    c1, out = walk(t1)
    c2, _ = walk(t2)
    slope = (target - t1) / (t2 - t1)
    return combine([(1 - slope, c1), (slope, c2)]), out


def cell_step(cfg, cell, mesh, rules, *, accum_steps=None, train_overrides=None,
              scale=True):
    """Lay a cell's inputs out on ``mesh`` as meta DTensors and walk its
    step under ``analyze_step``. Any mesh: the fake production world's,
    or the card's (1, 1) NCCL mesh. Returns a partial record: the counts
    (``hlo_flops_per_device`` and the ``collective_*`` keys), the local
    bytes of the arguments and outputs, the temp peak of a whole walk,
    ``accum_steps``, ``lower_s`` (the walk's seconds) and ``scaled``
    (what was walked short, or None). With ``scale=False`` every cell
    walks whole."""
    model = build_model(cfg)
    defs = model.param_defs()
    p_shapes = shape_tree(defs, cfg.pdtype())
    p_specs = spec_tree(defs)
    ssm = scale and cfg.family == "ssm" and cell.kind in ("train", "prefill")
    scaled, accum, peak = {}, None, []     # a whole walk's MemTracker peak

    t0 = time.time()
    with use_mesh(mesh), axis_rules(rules):
        p_shard = spec_tree_to_shardings(p_specs, p_shapes, mesh, rules)
        params = lay_out(p_shapes, p_shard, mesh)

        def inputs(seq_len):
            """``input_specs`` at ``seq_len``, each laid out as a DTensor."""
            c = ShapeCell(cell.name, seq_len, cell.global_batch, cell.kind)
            return {k: (sharded_meta(t, _placements_of(lg, t, mesh, rules), mesh), lg)
                    for k, (t, lg) in input_specs(cfg, c).items()}

        if cell.kind == "train":
            accum = accum_steps if accum_steps is not None else accum_for(cell, mesh)
            tov = dict(train_overrides or {})
            if tov.get("grad_shardings") == "auto":
                tov["grad_shardings"] = p_shard
            use_master = tov.pop("fp32_master", False)
            step_fn = make_train_step(model, AdamWConfig(), accum_steps=accum, **tov)

            def moments():
                return tree_map(lambda t, pl: sharded_meta(
                    _meta(t.shape, torch.float32), pl, mesh), p_shapes, p_shard)

            opt = {"mu": moments(), "nu": moments(),
                   # a real counter: AdamW reads the step as a number
                   "step": torch.zeros((), dtype=torch.int32)}
            if use_master:  # bf16 live params + fp32 masters in opt state
                opt["master"] = moments()

            def batch_of(seq_len):
                specs = inputs(seq_len)
                extra = _extra_from_specs(specs)
                return {"tokens": specs["tokens"][0], **({"extra": extra} if extra else {})}

            batch = batch_of(cell.seq_len)
            args = (params, opt, batch)
            if (scale and accum > 1) or ssm:
                # one microbatch's forward and backward, counted accum
                # times; then the accumulation and AdamW once
                def grads_walk(seq_len):
                    mb = microbatch(batch_of(seq_len), 0, accum) if accum > 1 \
                        else batch_of(seq_len)
                    return _walk(lambda: step_fn.grads_of(params, mb))

                if ssm:
                    g, part = _affine(grads_walk, SSM_WALK_LENGTHS, cell.seq_len)
                    scaled["seq_len"] = {"walked": list(SSM_WALK_LENGTHS),
                                         "to": cell.seq_len, "fit": "affine"}
                else:
                    g, part = grads_walk(cell.seq_len)
                u, out = _walk(lambda: step_fn.apply(params, opt, iter([part] * accum)))
                counts = combine([(accum, g), (1, u)])
                if accum > 1:
                    scaled["microbatches"] = {"walked": 1, "counted": accum}
            else:
                counts, out = _walk(lambda: step_fn(params, opt, batch), peak)
        else:
            cache_like = model.init_cache(cell.global_batch, cell.seq_len, device="meta")
            cache_shard = spec_tree_to_shardings(model.cache_specs(), cache_like, mesh, rules)
            cache = lay_out(cache_like, cache_shard, mesh)
            tok_key = "tokens" if cell.kind == "prefill" else "token"

            def serve_walk(seq_len, peak=None):
                specs = inputs(seq_len)
                tok, extra = specs[tok_key][0], _extra_from_specs(specs)
                run = model.prefill if cell.kind == "prefill" else model.decode_step
                with torch.no_grad():      # HybridLM's decode_step takes no extra
                    return _walk(lambda: run(params, tok, cache, *([extra] if extra else [])),
                                 peak)

            args = (params, [t for t, _ in inputs(cell.seq_len).values()], cache)
            if ssm:
                counts, out = _affine(serve_walk, SSM_WALK_LENGTHS, cell.seq_len)
                scaled["seq_len"] = {"walked": list(SSM_WALK_LENGTHS),
                                     "to": cell.seq_len, "fit": "affine"}
            else:
                counts, out = serve_walk(cell.seq_len, peak)
    lower_s = time.time() - t0
    return {
        "accum_steps": accum,
        "lower_s": lower_s,
        "scaled": scaled or None,
        "hlo_flops_per_device": counts["flops"],
        "collective_bytes_total_per_device": counts["collective_bytes_total"],
        "collective_bytes_by_kind": counts["collective_bytes"],
        "collective_op_counts": counts["collective_op_counts"],
        "mem_argument_bytes": local_bytes(args),
        "mem_output_bytes": local_bytes(out),
        "mem_temp_bytes": peak[0] if peak else None,
    }


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def fake_world(n: int):
    """Make this process rank 0 of a fake process group of ``n`` ranks
    (torch's ``fake`` backend: collectives return at once, nothing is
    sent), replacing a fake world of another size. Refuses to replace a
    real one: the dry-run never shares a process with NCCL."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group runs here; the "
                               "dry-run needs a process of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def cell_config(arch: str, kind: str, config_overrides: dict | None = None):
    """The cell's config: full size, bf16 compute; serving takes bf16
    weights, and so does training above 1e11 params (with fp32 moments)."""
    cfg = get_config(arch, compute_dtype="bfloat16", use_kernels=False,
                     **(config_overrides or {}))
    if kind != "train" or count_params(build_model(cfg).param_defs()) > 1e11:
        cfg = cfg.replace(param_dtype="bfloat16")
    return cfg


def cell_record(arch: str, cfg, cell, mesh, mesh_name: str, rules, **kw) -> dict:
    """The JSON record of one cell on ``mesh`` (see :func:`cell_step`)."""
    part = cell_step(cfg, cell, mesh, rules, **kw)
    n_dev = n_dev_of(mesh)
    rec = {
        "arch": arch,
        "shape": cell.name,
        "kind": cell.kind,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "n_params": count_params(build_model(cfg).param_defs()),
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "lower_s": round(part["lower_s"], 1),
        "compile_s": None,
        "accum_steps": part["accum_steps"],
        "xla_flops_per_device_scan_once": None,
        "hlo_flops_per_device": part["hlo_flops_per_device"],
        "collective_bytes_total_per_device": part["collective_bytes_total_per_device"],
        "collective_bytes_by_kind": part["collective_bytes_by_kind"],
        "collective_op_counts": part["collective_op_counts"],
        "n_while_loops": None,
        **analytic_costs(cfg, cell),
        "mem_argument_bytes": part["mem_argument_bytes"],
        "mem_output_bytes": part["mem_output_bytes"],
        "mem_temp_bytes": part["mem_temp_bytes"],
        "scaled": part["scaled"],
        "ok": True,
    }
    rec["roofline"] = roofline_terms(rec, n_dev)
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
             config_overrides: dict | None = None, rules_override=None,
             accum_steps: int | None = None, train_overrides: dict | None = None):
    cell = SHAPES[shape_name]
    cfg = cell_config(arch, cell.kind, config_overrides)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules_override or rules_for(cfg, cell, mesh)
    rec = cell_record(arch, cfg, cell, mesh, "2x16x16" if multi_pod else "16x16", rules,
                      accum_steps=accum_steps, train_overrides=train_overrides)
    if verbose:
        print(json.dumps(rec))
        sys.stdout.flush()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # DTensor warns of each two-step reduction over ("data", "model"); the
    # counts have them all
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    if args.all:
        cells = [(arch, cell.name) for arch in list_archs() for cell in shapes_for(arch)]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    for mp in meshes:              # one fake world a mesh
        for arch, shape in cells:
            try:
                rec = run_cell(arch, shape, multi_pod=mp)
            except Exception as e:
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "ok", "error")}))
                n_fail += 1
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    if out_f:
        out_f.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
