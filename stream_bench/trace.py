"""Spans and counters recorded from the benchmark's own side, around calls
into the program, and the reduction of a profiler trace to records.

The :class:`Recorder` wraps, for one run, ``ContinuousBatcher.submit``
(the requests the engine saw), ``ContinuousBatcher.step`` (set-up's hold
until the fill is queued), ``Request.emit`` and the relay's
``encrypt_envelope`` and ``decrypt_envelope`` (the plaintext of every
token frame sealed inside a request's emit, and of every frame opened,
by nonce, for the correctness check). In a traced run it also wraps
``step`` (a ``sb.tick`` range; the ticks that decoded),
``TransformerLM.prefill_chunk`` and ``decode_step`` (``sb.prefill_chunk``
and ``sb.decode_step`` ranges; tokens and start positions), ``emit``
(``sb.emit``; each token's index and the first one's time), the envelope
calls (``sb.encrypt``; wall time) and the attention kernels' entry points
(each call's ``kv_len`` while the profiler runs). The profiler runs over
the last ``PROFILE_S`` seconds of the window (less the profiler's own
start-up), started and stopped on the scheduler's own thread, which
launches all device work.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time

import torch

PROFILE_S = 8.0
HOLD_TIMEOUT_S = 60.0
KERNELS = {"decode_attention": "decode_split_kernel",
           "paged_attention": "paged_split_kernel"}


class Recorder:
    def __init__(self, trace: bool):
        self.trace = trace
        self.engine = None          # the HPC engine, once built
        self.requests = []          # (submit time, Request) as the engine saw them
        self.hold = 0               # queued requests to wait for before the first tick
        self.hold_since = None
        self.ticks = []             # decode ticks' end times
        self.prefills = []          # (time, tokens, start position)
        self.emits = []             # (time, token index, prompt tokens)
        self.first_emit = {}        # id(Request) -> time
        self.crypto = []            # (start, end) of each envelope call
        self.sealed = {}            # id(Request) -> [(nonce, plaintext)] of its token frames
        self.opened = {}            # nonce -> plaintext of each frame decrypted
        self._local = threading.local()     # the request whose emit is running
        self.prof_window = None     # (start, end) wanted
        self.prof = None
        self.prof_span = None       # (start, end) measured
        self.prof_done = threading.Event()
        self.prof_error = None
        self.profile = None         # reduced trace
        self.attn_calls = {k: [] for k in KERNELS}
        self._profiling = False
        self._saved = []

    # ------------------------------------------------------------ install
    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.core import data_plane
        from repro_torch.kernels import ops
        from repro_torch.models.lm import TransformerLM
        from repro_torch.serving.scheduler import ContinuousBatcher, Request
        rec = self
        rf = torch.profiler.record_function

        def submit(orig):
            def f(b, req):
                if b.engine is rec.engine:
                    rec.requests.append((time.perf_counter(), req))
                return orig(b, req)
            return f

        def step(orig):
            def f(b):
                if b.engine is not rec.engine:
                    return orig(b)
                if rec.hold:
                    now = time.perf_counter()
                    rec.hold_since = rec.hold_since or now
                    if len(b.queue) < rec.hold and now - rec.hold_since < HOLD_TIMEOUT_S:
                        time.sleep(0.001)
                        return b._in_flight()
                    rec.hold = 0
                if not rec.trace:
                    return orig(b)
                rec._profile_control()
                n0 = b.transfers
                with rf("sb.tick"):
                    out = orig(b)
                if b.transfers > n0:
                    rec.ticks.append(time.perf_counter())
                return out
            return f

        def prefill_chunk(orig):
            def f(model, params, tokens, cache, extra=None):
                rec.prefills.append((time.perf_counter(), tokens.shape[1], int(cache["pos"])))
                with rf("sb.prefill_chunk"):
                    return orig(model, params, tokens, cache, extra)
            return f

        def decode_step(orig):
            def f(model, params, token, cache, extra=None):
                with rf("sb.decode_step"):
                    return orig(model, params, token, cache, extra)
            return f

        def emit(orig):
            def f(req, tid, text):
                rec._local.req = req
                try:
                    if not rec.trace:
                        return orig(req, tid, text)
                    now = time.perf_counter()
                    i = len(req.output_ids) - 1
                    n_prompt = len(req._kv_ids if req._kv_ids is not None
                                   else req.prompt_ids)
                    rec.emits.append((now, i, n_prompt))
                    if i == 0:
                        rec.first_emit[id(req)] = now
                    with rf("sb.emit"):
                        return orig(req, tid, text)
                finally:
                    rec._local.req = None
            return f

        def timed(orig, *a):
            if not rec.trace:
                return orig(*a)
            t0 = time.perf_counter()
            with rf("sb.encrypt"):
                out = orig(*a)
            rec.crypto.append((t0, time.perf_counter()))
            return out

        def seal(orig):
            def f(aes, payload):
                env = timed(orig, aes, payload)
                req = getattr(rec._local, "req", None)
                if req is not None and payload.get("t") == "token":
                    rec.sealed.setdefault(id(req), []).append((env["nonce"], plain(payload)))
                return env
            return f

        def open_(orig):
            def f(aes, env):
                payload = timed(orig, aes, env)
                if env.get("enc"):
                    rec.opened[env["nonce"]] = plain(payload)
                return payload
            return f

        def attn(kind):
            def make(orig):
                def f(q, *a, **k):
                    if rec._profiling:
                        rec.attn_calls[kind].append(k.get("kv_len"))
                    return orig(q, *a, **k)
                return f
            return make

        self._patch(ContinuousBatcher, "submit", submit)
        self._patch(ContinuousBatcher, "step", step)
        self._patch(Request, "emit", emit)
        self._patch(data_plane, "encrypt_envelope", seal)
        self._patch(data_plane, "decrypt_envelope", open_)
        if self.trace:
            self._patch(TransformerLM, "prefill_chunk", prefill_chunk)
            self._patch(TransformerLM, "decode_step", decode_step)
            for kind in KERNELS:
                self._patch(ops, kind, attn(kind))
        try:
            yield self
        finally:
            for owner, name, orig in reversed(self._saved):
                setattr(owner, name, orig)
            self._saved.clear()

    # ------------------------------------------------------------ profiler
    def _profile_control(self):
        """Start or stop the profiler; runs on the scheduler's thread."""
        if self.prof_window is None or self.prof_done.is_set():
            return
        now = time.perf_counter()
        t0, t1 = self.prof_window
        if self.prof is None and now >= t0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._profiling = True
            self.prof_span = (time.perf_counter(), None)
        elif self.prof is not None and now >= t1:
            end = time.perf_counter()
            self._profiling = False
            try:
                if self.engine.device.type == "cuda":
                    torch.cuda.synchronize()
                self.prof.stop()
                self.prof_span = (self.prof_span[0], end)
                self.profile = self._reduce()
            except Exception as e:      # reported by the run, which then fails
                self.prof_error = f"{type(e).__name__}: {e}"
            finally:
                self.prof = None
                self.prof_done.set()

    def _reduce(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce_trace(events, self.prof_span)


def plain(payload: dict) -> str:
    """A frame's plaintext, serialized as the relay's envelope serializes it."""
    return json.dumps(payload, separators=(",", ":"))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list, span: tuple) -> dict:
    """Kernel time, busy time, the time of kernels launched inside each
    ``sb.*`` range, the largest kernels and the idle gaps by what the
    scheduler's thread was doing, from a chrome trace's events (times in
    microseconds)."""
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    annots = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("sb.") and "dur" in e]
    by_name = {}
    for a in annots:
        by_name.setdefault(a["name"], []).append((a["ts"], a["ts"] + a["dur"]))
    for v in by_name.values():
        v.sort()

    def containing(name, t):
        """The range of ``name`` holding t (ranges of one name never
        nest), or None."""
        rs = by_name.get(name, [])
        i = bisect.bisect_right(rs, (t, float("inf"))) - 1
        return rs[i] if i >= 0 and rs[i][0] <= t <= rs[i][1] else None

    def inside(name, t):
        return containing(name, t) is not None

    per_op, in_range = {}, {n: 0.0 for n in by_name}
    for k in kernels:
        per_op[k["name"]] = per_op.get(k["name"], 0.0) + k["dur"]
        t = launches.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n in in_range:
            if inside(n, t):
                in_range[n] += k["dur"]
    busy = _union([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    gaps = {}
    for (a0, a1), (b0, b1) in zip(busy, busy[1:]):
        # the gap goes to the innermost range around its middle
        mid = (a1 + b0) / 2
        owner, best = "no sb.* range", None
        for n in by_name:
            r = containing(n, mid)
            if r is not None and (best is None or r[1] - r[0] < best):
                owner, best = n, r[1] - r[0]
        gaps[owner] = gaps.get(owner, 0.0) + (b0 - a1)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": span[1] - span[0],
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernel_s_by_name": {n: v * 1e-6 for n, v in per_op.items()},
        "kernel_s_in": {n: v * 1e-6 for n, v in in_range.items()},
        "ranges": {n: len(v) for n, v in by_name.items()},
        "device_ops": [[n, v * 1e-6] for n, v in top],
        "idle_gaps": [[n, v * 1e-6] for n, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
