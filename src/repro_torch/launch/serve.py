"""Serving driver: stand up the full STREAM system (three tiers,
dual-channel relay, OpenAI-compatible gateway) and run batched requests
through it — the serving analogue of the training driver.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 12 --tokens 32

The engines run on the CUDA card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import build_system
from repro_torch.core.sse import parse_sse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--arch", default="minitron-8b", help="HPC-tier architecture")
    ap.add_argument("--prefix-pages", type=int, default=256,
                    help="KV page-pool budget per tier engine (0 disables "
                         "prefix caching)")
    ap.add_argument("--device", default=None,
                    help="torch device for both tier engines (default: the "
                         "CUDA card)")
    args = ap.parse_args()

    print("building STREAM system (three tiers + relay + proxy)...")
    sys_ = build_system(hpc_arch=args.arch, dispatch_latency_s=0.05, max_seq=256,
                        prefix_cache_pages=args.prefix_pages,
                        device=args.device)

    queries = [
        "What is the capital of France?",
        "Define entropy in one sentence.",
        "Explain how MPI collectives relate to GPU memory hierarchies and "
        "compare their trade-offs.",
        "Compare and contrast hash tables with database indexing.",
        "Prove, from first principles, the convergence of gradient descent "
        "and critique the standard assumptions in depth.",
        "Design a novel research methodology for protein folding; derive its "
        "theoretical limits for an open problem.",
    ]
    for i in range(args.requests):
        q = queries[i % len(queries)]
        h = sys_.handler.handle(q, max_tokens=args.tokens)
        print(f"[{h.complexity.name:6s}] tier={h.tier_used:5s} "
              f"ttft={h.result.ttft_s*1000:6.1f}ms "
              f"tok/s={h.result.tok_per_s:7.1f} cost=${h.result.cost_usd:.5f} "
              f"| {q[:48]}...")

    # one request per model alias through the OpenAI-compatible gateway
    token = sys_.globus.issue_token("demo@uic.edu")
    print()
    for alias in ("stream-auto", "stream-local", "stream-hpc", "stream-cloud"):
        resp = sys_.gateway.handle_chat_completions(
            {"model": alias,
             "messages": [{"role": "user", "content": f"hello via {alias}"}],
             "max_tokens": 8, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=token)
        chunks = parse_sse("".join(resp.stream))
        print(f"gateway {alias:>13s}: status={resp.status} "
              f"tier={resp.headers['x-stream-tier']:5s} chunks={len(chunks)} "
              f"usage={json.dumps(chunks[-1]['usage'])}")
    print("\nusage summary:")
    print(json.dumps(sys_.tracker.summary(), indent=2, default=float))


if __name__ == "__main__":
    main()
