#!/usr/bin/env python3
"""Drive the PyTorch port of STREAM on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:
  1. build the Hopper kernels from src/repro_torch/kernels/csrc (nvcc,
     one process per source, all started together) and time the build;
  2. kernels: hold each kernel against its plain PyTorch version at the
     main path's full-width shapes, in float32 and bfloat16, and time
     kernel, plain version and a PyTorch library yardstick the port never
     calls (F.rms_norm, F.scaled_dot_product_attention), each launch with
     a cold L2;
  3. reference: a small float32 model served on the card (kernels) and on
     the CPU (plain versions) with the same weights gives identical greedy
     streams, through generate() and through the paged batcher;
  4. main path: build_system on the card with the HPC tier at the full
     width of minitron-8b (bf16, 32 layers, random weights from seed 0),
     four concurrent encrypted stream-hpc requests and one stream-auto
     request through the OpenAI gateway; every kernel's launch counter,
     zeroed just before, must grow.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Exits nonzero with no result line when
no CUDA device is present or the port's sources are missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": (5e-5, 1e-5), "bfloat16": (1e-2, 1.6e-2)}   # (atol, rtol)
FULL = dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
            d_ff=16384, vocab_size=256000, param_dtype="bfloat16",
            compute_dtype="bfloat16")
B, HQ, HKV, D, PAGE, MAX_SEQ = 8, 32, 8, 128, 16, 256
N_TIMED = 100


def log(*a):
    print(*a, flush=True)


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch, as the serving path finds KV and activations cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, n=N_TIMED):
        torch = self.torch
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for a, b in ev:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / n


def check_close(name, got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name} [{dtype}]: max_abs_err {err.max().item():.3e} "
                             f"beyond atol {atol} + rtol {rtol}")
    return err.max().item()


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- kernels
def kernel_phase(torch, timer):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import paged_attention as pa_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms_k

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float32).to(dtype)

    # ---- rmsnorm: the decode tick's (B, 1, 4096) rows
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = randn(B, 1, 4096, dtype=dt)
        for gemma in (False, True):
            w = (0.1 * randn(4096, dtype=dt)) if gemma else (1 + 0.1 * randn(4096, dtype=dt))
            err = check_close(f"rmsnorm gemma={gemma}",
                              rms_k.rmsnorm(x, w, eps=1e-5, gemma_style=gemma),
                              rms_k.plain(x, w, eps=1e-5, gemma_style=gemma), dname)
            rows.setdefault(("rmsnorm", dname), []).append(err)
        if dname == "bfloat16":
            w = 1 + 0.1 * randn(4096, dtype=dt)
            t_k = timer.ms(lambda: rms_k.rmsnorm(x, w, eps=1e-5))
            t_p = timer.ms(lambda: rms_k.plain(x, w, eps=1e-5))
            t_l = timer.ms(lambda: F.rms_norm(x, (4096,), w, eps=1e-5))
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            bms, by = bound_ms(nbytes, 4 * x.numel(), dname)
            rows["rmsnorm"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=bms, bound_by=by)

    # ---- paged attention: ragged lengths, rolled-out offsets, shared
    # pages, garbage in the trash page and in dead pages
    n_pages, P = MAX_SEQ // PAGE, 257
    kv_len = torch.tensor([1, 17, 40, 64, 100, 150, 200, 256], dtype=torch.int32,
                          device="cuda")
    poff = torch.tensor([0, 0, 16, 0, 32, 0, 48, 0], dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda")[:B * n_pages] + 1
    bt = perm.reshape(B, n_pages).to(torch.int32)
    bt[3, :2] = bt[2, :2]                         # slots 2 and 3 share a prefix
    live = ((kv_len - poff + PAGE - 1) // PAGE).tolist()
    for b in range(B):
        bt[b, live[b]:] = 0                       # padding -> trash page
    bt = bt.contiguous()
    n_live = (kv_len - poff).tolist()
    n_live_keys = sum(n_live)                     # per-slot work: shared pages count twice
    bt_host = bt.tolist()
    # bytes: a position two slots share is read from memory once
    n_distinct_keys = len({(bt_host[b][j // PAGE], j % PAGE)
                           for b in range(B) for j in range(n_live[b])})
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        q = randn(B, HQ, 1, D, dtype=dt)
        kp = randn(P, HKV, PAGE, D, dtype=dt)
        vp = randn(P, HKV, PAGE, D, dtype=dt)
        kp[0], vp[0] = 1e4, -1e4                  # trash page garbage
        for cap in (0.0, 30.0):
            err = check_close(
                f"paged_attention cap={cap}",
                pa_k.paged_attention(q, kp, vp, block_tables=bt, kv_len=kv_len,
                                     pos_offset=poff, logit_soft_cap=cap),
                pa_k.plain(q, kp, vp, block_tables=bt, kv_len=kv_len,
                           pos_offset=poff, logit_soft_cap=cap), dname)
            rows.setdefault(("paged_attention", dname), []).append(err)
        if dname == "bfloat16":
            t_k = timer.ms(lambda: pa_k.paged_attention(
                q, kp, vp, block_tables=bt, kv_len=kv_len, pos_offset=poff))
            t_p = timer.ms(lambda: pa_k.plain(
                q, kp, vp, block_tables=bt, kv_len=kv_len, pos_offset=poff))
            gk = ref.gather_kv_pages(kp, bt).repeat_interleave(HQ // HKV, dim=1)
            gv = ref.gather_kv_pages(vp, bt).repeat_interleave(HQ // HKV, dim=1)
            mask = (torch.arange(n_pages * PAGE, device="cuda")[None, :]
                    < (kv_len - poff)[:, None])[:, None, None, :]
            t_l = timer.ms(lambda: F.scaled_dot_product_attention(
                q, gk, gv, attn_mask=mask))
            elt = q.element_size()
            nbytes = (2 * q.numel() * elt + 2 * n_distinct_keys * HKV * D * elt
                      + 4 * (sum(live) + 2 * B))
            bms, by = bound_ms(nbytes, 4 * D * HQ * n_live_keys, dname)
            rows["paged_attention"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                           bound_ms=bms, bound_by=by)

    # ---- contiguous decode attention: warmup/generate() run it at B=1,
    # S=max_seq; B=8 ragged is checked too
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for bb, lens in ((1, [256]), (B, [1, 5, 16, 17, 100, 128, 255, 256])):
            q = randn(bb, HQ, 1, D, dtype=dt)
            k = randn(bb, HKV, MAX_SEQ, D, dtype=dt)
            v = randn(bb, HKV, MAX_SEQ, D, dtype=dt)
            kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for cap in (0.0, 30.0):
                err = check_close(
                    f"decode_attention B={bb} cap={cap}",
                    dec_k.decode_attention(q, k, v, kv_len=kl, logit_soft_cap=cap),
                    dec_k.plain(q, k, v, kv_len=kl, logit_soft_cap=cap), dname)
                rows.setdefault(("decode_attention", dname), []).append(err)
            if dname == "bfloat16" and bb == 1:
                t_k = timer.ms(lambda: dec_k.decode_attention(q, k, v, kv_len=kl))
                t_p = timer.ms(lambda: dec_k.plain(q, k, v, kv_len=kl))
                ke = k.repeat_interleave(HQ // HKV, dim=1)
                ve = v.repeat_interleave(HQ // HKV, dim=1)
                t_l = timer.ms(lambda: F.scaled_dot_product_attention(q, ke, ve))
                elt = q.element_size()
                keys = sum(lens)
                nbytes = 2 * q.numel() * elt + 2 * keys * HKV * D * elt + 4 * bb
                bms, by = bound_ms(nbytes, 4 * D * HQ * keys, dname)
                rows["decode_attention"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                                bound_ms=bms, bound_by=by)
    for (name, dname), errs in sorted((k, v) for k, v in rows.items()
                                      if isinstance(k, tuple)):
        log(f"kernel {name:17s} {dname:9s} max_abs_err {max(errs):.3e} "
            f"(tolerance atol {TOL[dname][0]} + rtol {TOL[dname][1]})")
    for name in ("rmsnorm", "paged_attention", "decode_attention"):
        r = rows[name]
        r["max_abs_err"] = max(rows[(name, "float32")] + rows[(name, "bfloat16")])
        log(f"time {name:17s} bf16 kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            f"  library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    return rows


# ---------------------------------------------------------------- reference
def reference_phase(torch):
    """The same small float32 model on the card and on the CPU: greedy
    streams must agree token for token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.common import tree_map
    from repro_torch.serving import ServingEngine

    cfg = get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                  compute_dtype="float32")
    gpu = ServingEngine(cfg, max_seq=96, device="cuda")
    cpu = ServingEngine(cfg, max_seq=96, device="cpu",
                        params=tree_map(lambda t: t.cpu(), gpu.params))
    prompts = ["hello world", "a prompt longer than one sixteen-token page, twice over",
               "x"]
    for p in prompts:
        a, c = gpu.generate(p, max_new_tokens=12).tokens, cpu.generate(p, max_new_tokens=12).tokens
        if a != c:
            raise AssertionError(f"generate() differs card vs CPU: {a} vs {c}")
    hg = [gpu.submit(p, max_new_tokens=12) for p in prompts]
    hc = [cpu.submit(p, max_new_tokens=12) for p in prompts]
    for a, c in zip(hg, hc):
        ta, tc = a.result(timeout=300).tokens, c.result(timeout=300).tokens
        if ta != tc:
            raise AssertionError(f"batcher stream differs card vs CPU: {ta} vs {tc}")
    gpu.shutdown()
    cpu.shutdown()
    log(f"reference: {len(prompts)} prompts token-identical card vs CPU "
        "(generate and paged batcher, float32)")


# ---------------------------------------------------------------- main path
def main_path_phase(torch):
    from repro_torch.core import build_system
    from repro_torch.core.sse import parse_sse
    from repro_torch.kernels import decode_attention, paged_attention, rmsnorm
    from repro_torch.models.common import flatten

    kernels = {"rmsnorm": rmsnorm, "paged_attention": paged_attention,
               "decode_attention": decode_attention}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sys_ = build_system(device="cuda", local_arch="minitron-8b", max_seq=MAX_SEQ,
                        hpc_overrides=FULL, dispatch_latency_s=0.05)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in flatten(sys_.engines["hpc"].params))
    log(f"main path: build_system {build_s:.1f} s, HPC tier {n_params / 1e9:.2f} B params "
        f"(bf16), {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    n_tok = 32
    token = sys_.globus.issue_token("chip-smoke@uic.edu")

    def one(alias, content, out, i):
        t_sub = time.perf_counter()
        resp = sys_.gateway.handle_chat_completions(
            {"model": alias, "messages": [{"role": "user", "content": content}],
             "max_tokens": n_tok, "stream": True,
             "stream_options": {"include_usage": True}}, bearer=token)
        if resp.status != 200:
            raise AssertionError(f"{alias}: status {resp.status}: {resp.body}")
        stamps, raw = [], []
        for piece in resp.stream:
            raw.append(piece)
            stamps.append(time.perf_counter())
        chunks = parse_sse("".join(raw))
        out[i] = dict(status=resp.status, headers=resp.headers, chunks=chunks,
                      t_sub=t_sub, stamps=stamps)

    results = [None] * 5
    threads = [threading.Thread(target=one, args=(
        "stream-hpc", f"Explain request {i} of the dual-channel relay.", results, i))
        for i in range(4)]
    t_wall = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a stream-hpc request did not finish in 600 s")
    if None in results[:4]:
        raise AssertionError("a stream-hpc request failed (traceback above)")
    wall = time.perf_counter() - t_wall
    one("stream-auto", "What is the capital of France?", results, 4)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    ttfts, rates, total_tokens = [], [], 0
    for i, r in enumerate(results):
        alias = "stream-hpc" if i < 4 else "stream-auto"
        if r["status"] != 200:
            raise AssertionError(f"{alias}: status {r['status']}")
        tier = r["headers"]["x-stream-tier"]
        if i < 4 and tier != "hpc":
            raise AssertionError(f"stream-hpc served by tier {tier!r}")
        chunks = r["chunks"]
        usage = chunks[-1].get("usage")
        if not usage or chunks[-1].get("choices") != []:
            raise AssertionError(f"{alias}: no usage chunk at the end")
        frames = [c for c in chunks if c.get("choices")
                  and c["choices"][0].get("finish_reason") is None]
        n = usage["completion_tokens"]
        if not (1 <= n <= n_tok) or len(frames) - 1 != n:
            raise AssertionError(f"{alias}: {n} completion tokens, "
                                 f"{len(frames) - 1} content frames")
        if i < 4:
            total_tokens += n
            # SSE pieces: role preamble first, then one per token
            ttfts.append(r["stamps"][1] - r["t_sub"])
            if n > 1:
                rates.append((n - 1) / (r["stamps"][n] - r["stamps"][1]))
        log(f"{alias}: tier {tier}, {n} tokens, finish "
            f"{[c for c in chunks if c.get('choices')][-1]['choices'][0]['finish_reason']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log(f"main path launches: {json.dumps(launches)}")
    ttfts.sort()
    log(f"main path: TTFT median {ttfts[len(ttfts) // 2] * 1e3:.1f} ms "
        f"(max {ttfts[-1] * 1e3:.1f} ms) over 4 concurrent stream-hpc requests; "
        f"decode {sum(rates) / len(rates):.1f} tok/s per session, "
        f"{total_tokens / wall:.1f} tok/s over all 4 sessions (wall {wall:.2f} s); "
        f"peak device memory {peak / 2**30:.2f} GiB")

    # full-width logits are finite and of the padded vocab's width
    hpc = sys_.engines["hpc"]
    with torch.inference_mode():
        cache = hpc.model.init_cache(1, MAX_SEQ, hpc.device)
        logits, _ = hpc.model.prefill_chunk(
            hpc.params, torch.tensor([[0, 40, 41, 42]], device=hpc.device), cache)
    if tuple(logits.shape) != (1, hpc.cfg.padded_vocab) or not bool(logits.isfinite().all()):
        raise AssertionError(f"full-width logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(logits.isfinite().all())}")
    return launches, sys_


def breakdown_phase(torch, sys_):
    """Where the time goes, on the HPC engine alone (after the main
    path's counters were read): the same 4 sessions through
    ServingEngine.submit without gateway, control plane, relay and
    encryption; then one B=8 paged decode step of the model, host wall
    time against the device time the profiler sums over its kernels."""
    hpc = sys_.engines["hpc"]
    prompts = [f"Explain request {i} of the dual-channel relay." for i in range(4)]
    t0 = time.perf_counter()
    res = [h.result(timeout=600) for h in
           [hpc.submit(p, max_new_tokens=32) for p in prompts]]
    wall = time.perf_counter() - t0
    ttft = sorted(r.ttft_s for r in res)
    log(f"breakdown: engine alone, 4 sessions x 32 tokens: "
        f"{sum(r.n_generated for r in res) / wall:.1f} tok/s over all sessions "
        f"(wall {wall:.2f} s), TTFT median {ttft[2] * 1e3:.1f} ms, max {ttft[-1] * 1e3:.1f} ms")

    b = hpc.scheduler.batcher
    for e in sys_.engines.values():
        e.shutdown()
    sys_.endpoint.shutdown()
    sys_.gateway.shutdown()
    # a synthetic B=8 step over the (now idle) pool: 40 cached tokens per slot
    pages = torch.arange(1, 1 + 3 * b.B, dtype=torch.int32, device=hpc.device)
    bt = torch.zeros((b.B, b.n_pages), dtype=torch.int32, device=hpc.device)
    bt[:, :3] = pages.reshape(b.B, 3)
    cache = {"k": b.cache["k"], "v": b.cache["v"],
             "pos": torch.full((b.B,), 40, dtype=torch.int32, device=hpc.device),
             "pos_offset": torch.zeros(b.B, dtype=torch.int32, device=hpc.device),
             "block_tables": bt}
    tok = torch.full((b.B, 1), 42, dtype=torch.int64, device=hpc.device)
    with torch.inference_mode():
        def step():
            logits, _ = hpc.model.decode_step(hpc.params, tok, cache)
            return logits
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in evs) / 5
    n_launch = sum(e.count for e in evs
                   if getattr(e, "self_device_time_total", 0) > 0) / 5
    log(f"breakdown: B=8 paged decode step at full width: {step_ms:.2f} ms wall, "
        f"{n_launch:.0f} device kernels taking "
        f"{dev_us / 1e3:.2f} ms -> device busy {dev_us / 1e3 / step_ms * 100:.0f}% "
        f"of the step")
    top = sorted(evs, key=lambda e: -getattr(e, "self_device_time_total", 0))[:8]
    for e in top:
        log(f"  {getattr(e, 'self_device_time_total', 0) / 5 / 1e3:8.3f} ms/step "
            f"{e.count // 5:5d} calls  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build (nvcc, sources in parallel): {time.perf_counter() - t0:.1f} s")

    timer = Timer(torch)
    rows = kernel_phase(torch, timer)
    reference_phase(torch)
    launches, sys_ = main_path_phase(torch)
    breakdown_phase(torch, sys_)

    sources = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:26"),
               "paged_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                                   "src/repro/kernels/paged_attention.py:91"),
               "decode_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                                    "src/repro/kernels/decode_attention.py:65")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
