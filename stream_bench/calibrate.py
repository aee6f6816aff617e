"""Readings that the correctness limits are set from, on the card: for each
seed, one run of a cell (as ``run.py`` makes it) whose sample is judged
twice, by the program's served tokens and by the tokens the fp8 control
puts first. One process serves the seeds one after another.

    python3 stream_bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 40

Prints one JSON line a seed (and writes them to ``--out``), with
``control_correct``: the control's gap put through the run's own check,
which has to come out false. The benchmark's own runs never run this."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from stream_bench import check, run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    spec = run.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = run.run_cell(spec, seed, args.seconds, False, t_process=t,
                           control=bool(args.control))
        line = json.dumps({"seed": seed, "correct": res["correct"],
                           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                           "checks": {k: v["value"] for k, v in res["checks"].items()},
                           "readings": res.get("readings"),
                           "control_correct": (check.correct(check.with_control(
                               res["checks"], res["readings"]))
                               if args.control and "mean_logit_gap" in res["checks"]
                               else None),
                           "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                           "wall_s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
