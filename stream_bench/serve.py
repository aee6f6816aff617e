"""One run of a cell: the system built as users call it, the benchmark's
weights written into it, set-up (the fill), the measured window of
closed-loop callers through the gateway, and what the window recorded.

The window drives ``repro_torch.core.build_system(...)``'s
``gateway.handle_chat_completions`` with ``stream-hpc`` from one thread
per caller. Each caller sends its fill request during set-up, in the
mix's order, each once the engine has queued the previous caller's, and
then, until the window closes, the pool's next request as soon as its
previous one has ended. A caller stamps every SSE piece as it arrives and parses
nothing until the window has closed. At the close, every stream still
open is closed by its caller, which the gateway turns into a cancel.
"""

from __future__ import annotations

import gc
import json
import threading
import time
from dataclasses import dataclass, field

import torch

from stream_bench import traffic as traffic_mod
from stream_bench.trace import PROFILE_S, Recorder

ALIAS = "stream-hpc"
JOIN_S = 120.0


@dataclass
class Call:
    """One request as its caller saw it."""
    req: traffic_mod.Request
    phase: str                       # fill | window
    t_call: float = 0.0
    status: int = 0
    pieces: list = field(default_factory=list)    # (time, raw SSE piece)
    cut: bool = False                # closed by its caller at the window's end
    error: str = ""
    texts: list = field(default_factory=list)     # parsed: one per token
    stamps: list = field(default_factory=list)
    finish: str = ""
    usage: dict = field(default_factory=dict)     # the usage chunk's counts

    def parse(self):
        for t, piece in self.pieces:
            body = piece.strip()
            if not body.startswith("data: "):
                continue
            body = body[len("data: "):]
            if body == "[DONE]":
                break
            d = json.loads(body)
            if "error" in d:
                self.error = str(d["error"])
                continue
            if d.get("usage"):
                self.usage = dict(d["usage"])
            ch = d.get("choices") or []
            if not ch:
                continue
            delta = ch[0].get("delta", {})
            if ch[0].get("finish_reason"):
                self.finish = ch[0]["finish_reason"]
            elif "role" not in delta:
                self.texts.append(delta.get("content", ""))
                self.stamps.append(t)

    @property
    def failed(self) -> bool:
        return (self.status != 200 or bool(self.error)
                or (not self.cut and not self.finish))


def _send(system, bearer, call: Call, temperature: float, stop: threading.Event):
    call.t_call = time.perf_counter()
    resp = system.gateway.handle_chat_completions(
        {"model": ALIAS, "messages": [{"role": "user", "content": call.req.content}],
         "max_tokens": call.req.max_tokens, "temperature": temperature,
         "stream": True, "stream_options": {"include_usage": True}}, bearer=bearer)
    call.status = resp.status
    if resp.status != 200:
        call.error = str(resp.body)
        return
    stream = resp.stream
    try:
        for piece in stream:
            call.pieces.append((time.perf_counter(), piece))
            # close only past the role preamble: the gateway cancels a
            # stream closed inside its token loop, and one closed at the
            # preamble would decode on to its max_tokens
            if stop.is_set() and len(call.pieces) > 1:
                call.cut = True
                break
    finally:
        stream.close()


def free_program(system):
    """Release the program's device state (parameters and page pools)
    wherever else it is referenced, so the reference has the card."""
    from repro_torch.models.common import flatten
    for e in system.engines.values():
        b = e.scheduler.batcher if e.scheduler is not None else None
        e.shutdown()
        for _, t in flatten(e.params):
            t.data = torch.empty(0, dtype=t.dtype, device=t.device)
        if b is not None:
            for v in b.cache.values():
                if torch.is_tensor(v):
                    v.data = torch.empty(0, dtype=v.dtype, device=v.device)
    system.gateway.shutdown()
    system.endpoint.shutdown()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, *,
          device: str, weights_cls, layout: dict, t_process: float, log=print):
    """Build, set up and measure one window. Returns (system, recorder,
    calls, window (t0, t1), setup_s, memory_peak_bytes)."""
    from repro_torch.core import build_system
    from repro_torch.models.common import flatten

    port = cfg["port"]
    slots = int(port["slots"])
    # where set-up's time goes, from process start (standard error only)
    phases = {"imports": time.perf_counter() - t_process}
    tr = traffic_mod.make(mix, seed, slots)
    rec = Recorder(trace)
    with rec.installed():
        system = build_system(
            device=device, hpc_arch=port["arch"], hpc_overrides=port["model"],
            max_seq=int(port["max_seq"]), scheduler_slots=slots,
            prefix_cache_pages=int(port["prefix_cache_pages"]),
            hpc_workers=tr.clients)
        hpc = system.engines["hpc"]
        rec.engine = hpc
        phases["build_system"] = time.perf_counter() - t_process
        W = weights_cls(layout, seed, dtype=hpc.cfg.pdtype(), device=hpc.device)
        W.write_into({".".join(k): t for k, t in flatten(hpc.params)})
        if hpc.device.type == "cuda":
            torch.cuda.synchronize()
        phases["weights"] = time.perf_counter() - t_process
        bearer = system.globus.issue_token("bench@uic.edu")
        stop = threading.Event()
        calls: list[Call] = []
        lock = threading.Lock()
        nxt = iter(tr.pool)
        window = [None, None]

        def caller(first: traffic_mod.Request):
            c = Call(req=first, phase="fill")
            with lock:
                calls.append(c)
            _send(system, bearer, c, tr.temperature, stop)
            while not stop.is_set():
                with lock:
                    r = next(nxt, None)
                    if r is None or stop.is_set():
                        return
                    c = Call(req=r, phase="window")
                    calls.append(c)
                _send(system, bearer, c, tr.temperature, stop)

        # the fill: every caller's first request queued, in the mix's
        # order, before the first tick, so every run admits them alike
        rec.hold = tr.clients
        threads = [threading.Thread(target=caller, args=(r,), daemon=True,
                                    name=f"caller-{i}") for i, r in enumerate(tr.fill)]
        deadline = time.perf_counter() + 900
        for i, t in enumerate(threads):
            t.start()
            while len(rec.requests) <= i:
                if time.perf_counter() > deadline or not t.is_alive():
                    raise RuntimeError(f"fill request {i} did not reach the engine")
                time.sleep(0.001)
        phases["queued"] = time.perf_counter() - t_process
        while True:
            b = hpc.scheduler.batcher if hpc.scheduler is not None else None
            if b is not None and all(r is not None for r in b.active) and b._adm is None:
                break
            if time.perf_counter() > deadline:
                raise RuntimeError("the fill did not occupy every slot in 900 s")
            time.sleep(0.01)
        t0 = time.perf_counter()
        t1 = t0 + seconds
        window[:] = [t0, t1]
        if trace:
            rec.prof_window = (t1 - min(PROFILE_S, seconds), t1)
        setup_s = t0 - t_process
        phases["filled"] = setup_s
        log(f"set-up {setup_s:.1f} s; window {seconds} s from t0; set-up's phases "
            + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
        time.sleep(max(t1 - time.perf_counter(), 0.0))
        stop.set()
        for t in threads:
            t.join(JOIN_S)
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"a caller did not end within {JOIN_S} s of the window")
        if rec.prof_window is not None:
            if not rec.prof_done.wait(JOIN_S):
                raise RuntimeError("the profiler did not stop")
            if rec.prof_error:
                raise RuntimeError(f"the profiler failed: {rec.prof_error}")
        b = hpc.scheduler.batcher
        deadline = time.perf_counter() + JOIN_S
        while b.queue or b._in_flight():
            if time.perf_counter() > deadline:
                raise RuntimeError("cancelled sessions did not leave the batch")
            time.sleep(0.01)
        peak = (torch.cuda.max_memory_allocated() if hpc.device.type == "cuda"
                else 0)
    for c in calls:
        c.parse()
    return system, rec, calls, tuple(window), setup_s, peak
