"""The benchmark of the PyTorch/CUDA port (``repro_torch``), one cell a run:

    python3 stream_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``: a
configuration is ``stream_bench/configs/<config>.json``, a mix
``stream_bench/traffic/<mix>.json``, a per-layer metric the reader
``stream_bench/metrics/<metric>.py``, and the plain reference the module
of ``stream_bench/reference/`` its configuration names. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks`` last); the numbers compared, beside their limits, are
also the last lines of standard error. Without a CUDA card, or with
fewer than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# every build and kernel cache of the program stays inside the checkout,
# at fixed paths (the port's nvcc builds go to build/kernels/ by itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def log(msg: str):
    print(f"[stream_bench] {msg}", file=sys.stderr, flush=True)


def load(workload: str) -> dict:
    """Everything a cell is, found by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(entries):
        return [e for e in entries if "workloads" not in e or workload in e["workloads"]]

    return {"cell": cell, "chips": int(cell["chips"]),
            "cfg": json.loads((ROOT / conf["file"]).read_text()),
            "mix": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def record(cfg: dict, rec, calls, window, profile) -> dict:
    """What the per-layer readers read: the window's host records and
    the reduced profile, all as plain numbers."""
    t0, t1 = window

    def inw(t):
        return t0 <= t <= t1

    from stream_bench.trace import KERNELS
    return {
        "model": cfg["port"]["model"],
        "window_s": t1 - t0,
        "tokens": sum(1 for c in calls for s in c.stamps if inw(s)),
        "ttft_s": [c.stamps[0] - c.t_call for c in calls
                   if c.phase == "window" and inw(c.t_call) and c.stamps],
        "engine_ttft_s": [rec.first_emit[id(r)] - r.submitted_at
                          for t, r in rec.requests if inw(t) and id(r) in rec.first_emit],
        "decode_ticks": sum(1 for t in rec.ticks if inw(t)),
        "crypto_s": sum(e - s for s, e in rec.crypto if inw(s)),
        "prefills": [(n, start) for t, n, start in rec.prefills if inw(t)],
        "decoded": [(i, n) for t, i, n in rec.emits if inw(t)],
        "profile": profile,
        "attn_calls": {k: [kv.tolist() for kv in v if kv is not None]
                       for k, v in rec.attn_calls.items()},
        "kernel_match": KERNELS,
    }


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_process: float = T_PROCESS, control: bool = False) -> dict:
    """One run; returns the result object (``checks`` last). ``control``
    also reads the fp8 control's gap (``calibrate.py``)."""
    import torch
    from stream_bench import check, serve, stats
    from stream_bench.weights import Weights

    cfg, mix = spec["cfg"], spec["mix"]
    ref_mod = importlib.import_module(f"stream_bench.reference.{cfg['reference']}")
    layout = ref_mod.layout(cfg["port"]["model"])
    system, rec, calls, window, setup_s, peak = serve.serve(
        cfg, mix, seed, seconds, trace, device=device, weights_cls=Weights,
        layout=layout, t_process=t_process, log=log)
    t0, t1 = window
    failed = sum(c.failed for c in calls)
    attempted = len(calls)

    def inw(t):
        return t0 <= t <= t1

    metrics = {}
    if not trace:
        tokens = sum(1 for c in calls for s in c.stamps if inw(s))
        itl = [b - a for c in calls for a, b in zip(c.stamps, c.stamps[1:])
               if inw(a) and inw(b)]
        ttft = [c.stamps[0] - c.t_call for c in calls
                if c.phase == "window" and inw(c.t_call) and c.stamps]
        values = {"output_tok_s": stats.rate(tokens, t1 - t0),
                  "itl_p95_ms": stats.percentile(itl, 95) * 1e3 if itl else None,
                  "ttft_p50_ms": stats.median(ttft) * 1e3 if ttft else None,
                  "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        log(f"window: {tokens} tokens, {len(itl)} gaps, {len(ttft)} first tokens, "
            f"{attempted} requests, {failed} failed")
    else:
        rec_d = record(cfg, rec, calls, window, rec.profile)
        for m in spec["per_layer"]:
            v = importlib.import_module(f"stream_bench.metrics.{m['name']}").read(rec_d)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": spec["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        result["breakdown"] = {"device_ops": rec.profile["device_ops"],
                               "idle_gaps": rec.profile["idle_gaps"]}
    requests = list(rec.requests)
    serve.free_program(system)
    del system
    W = Weights(layout, seed, dtype=getattr(torch, cfg["port"]["model"]["param_dtype"]),
                device=device)
    t_ref = time.perf_counter()
    chk, readings = check.checks(cfg, ref_mod, W, calls, requests, seed, failed,
                                 sealed=rec.sealed, opened=rec.opened, control=control)
    log(f"reference check {time.perf_counter() - t_ref:.1f} s: {readings}")
    if control:
        result["readings"] = readings
    result["correct"] = check.correct(chk)
    result["checks"] = chk
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        log(f"needs {spec['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if loaded:
        log(f"forbidden modules loaded in this process: {loaded}")
        return 3
    log(f"correct {result['correct']}")
    for name, v in result["checks"].items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        import traceback
        traceback.print_exc()
        code = 1
    # the program's pool and relay threads may still wait on queues: end
    # the process without joining them
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
