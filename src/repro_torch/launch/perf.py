"""The three hillclimbed cells' optimized configurations, walked by the
dry-run on the fake 16x16 world (the JAX package's ``launch/perf.py``).

Writes records to results/optimized.jsonl (relative to the working
directory) and prints one line a cell:

  A  deepseek-v2-lite-16b / decode_32k : absorbed MLA + kv_seq on "model"
  B  deepseek-67b / train_4k           : pure FSDP (no TP), accum 1
  C  grok-1-314b / prefill_32k         : shard_map local MoE dispatch,
                                         eval capacity factor 1.25

  python -m repro_torch.launch.perf

The roofline terms are analysis on the H100's data sheet, not
measurements.
"""

from __future__ import annotations

import json
import logging
import os

import torch.distributed as dist

from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.launch.dryrun import run_cell


def optimized_cells():
    out = {}

    # --- A: serving the paper's HPC tier (MLA decode) ---
    rules_a = dict(DEFAULT_RULES)
    rules_a["kv_seq"] = ("model",)
    out["A deepseek-v2-lite-16b/decode_32k"] = run_cell(
        "deepseek-v2-lite-16b", "decode_32k", multi_pod=False, verbose=False,
        config_overrides={"mla_absorbed_decode": True},
        rules_override=rules_a)

    # --- B: pure-FSDP training (no TP -> no activation all-reduce) ---
    rules_b = dict(DEFAULT_RULES)
    rules_b.update({"batch": ("data", "model"), "embed": ("data", "model"),
                    "heads": None, "kv_heads": None, "qkv": None, "ffn": None,
                    "vocab": None, "experts": None, "expert_ffn": None,
                    "moe_cap": None})
    out["B deepseek-67b/train_4k"] = run_cell(
        "deepseek-67b", "train_4k", multi_pod=False, verbose=False,
        rules_override=rules_b, accum_steps=1)

    # --- C: shard_map local MoE dispatch ---
    out["C grok-1-314b/prefill_32k"] = run_cell(
        "grok-1-314b", "prefill_32k", multi_pod=False, verbose=False,
        config_overrides={"eval_capacity_factor": 1.25,
                          "moe_dispatch": "shard_map"})
    return out


def main():
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    os.makedirs("results", exist_ok=True)
    with open("results/optimized.jsonl", "w") as f:
        for tag, rec in optimized_cells().items():
            rec["tag"] = tag
            f.write(json.dumps(rec) + "\n")
            rf = rec["roofline"]
            temp = rec["mem_temp_bytes"]
            print(f"{tag:40s} comp={rf['compute_s']:.4f} mem={rf['memory_s']:.4f} "
                  f"coll={rf['collective_s']:.4f} bound={rf['bottleneck']} "
                  f"MFUb={rf['mfu_bound']:.4f} tempGB="
                  + ("n/a" if temp is None else f"{temp / 2**30:.1f}"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
