"""SessionBroker — thread-safe concurrent streaming sessions over one
continuous-batching scheduler.

Every tier backend used to run one blocking ``engine.generate`` at a
time, so concurrent proxy sessions serialized on the engine. The broker
is the session layer that fixes that: callers on any thread call
``submit()`` and get back a :class:`SessionHandle`; a single scheduler
thread owns the :class:`~repro_torch.serving.scheduler.ContinuousBatcher` and
ticks it while work is pending, so N in-flight sessions' decode steps
interleave in ONE fused device batch.

Mapping: one session == one :class:`~repro_torch.serving.scheduler.Request`
== (once admitted) one decode slot of the shared batch. Cancellation
(`handle.cancel()`, a relay channel teardown, a deadline) frees the slot
for the next queued session on the next tick.

Callbacks (``on_token`` / ``on_done``) fire on the scheduler thread —
they must not block and must not call back into ``submit`` (feed a
queue instead, as the tier backends do). A callback that raises is
detached and its session cancelled rather than letting one bad consumer
stall every other session in the batch.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.errors import SchedulerStopped
from repro_torch.serving.sampler import GenerationParams
from repro_torch.serving.scheduler import ContinuousBatcher, Request, clip_prompt


@dataclass
class SessionResult:
    """Final state of one streaming session (mirrors GenerationResult)."""
    tokens: list
    text: str
    ttft_s: float
    total_s: float
    tok_per_s: float
    n_prompt: int
    n_generated: int
    cancelled: bool = False
    finish_reason: str = "stop"      # "stop" | "length" | "cancelled"
    error: Optional[str] = None
    prefix_hit_tokens: int = 0       # prompt tokens served from the KV cache
    rolls: int = 0                   # window rolls the session took


class SessionHandle:
    """Caller-side handle for one in-flight session."""

    def __init__(self, rid: str, cancel_fn: Callable[[], None]):
        self.rid = rid
        self.submitted_at = time.perf_counter()
        self.ttft_s: Optional[float] = None
        self.prefix_hit_tokens = 0   # set with the first token
        self._cancel_fn = cancel_fn
        self._event = threading.Event()
        self._result: Optional[SessionResult] = None

    def cancel(self):
        """Cancel the session: dequeue it, or free its decode slot. The
        handle still completes (``result()`` returns ``cancelled=True``
        with the tokens produced so far)."""
        self._cancel_fn()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> SessionResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"session {self.rid} still running after {timeout}s")
        return self._result  # type: ignore[return-value]


class SessionBroker:
    def __init__(self, engine, *, slots: int = 8, max_seq: int | None = None,
                 prefill_chunk: int = 32, page: int | None = None,
                 prefix_pages: int | None = None):
        self.engine = engine
        self.batcher = ContinuousBatcher(
            engine, slots=slots, max_seq=max_seq, prefill_chunk=prefill_chunk,
            page=page if page is not None else getattr(engine, "page", 16),
            prefix_pages=prefix_pages)
        self.slots = slots
        # The batcher is touched ONLY by the scheduler thread. Callers
        # talk to it through mailboxes drained once per tick, so a
        # submit/cancel never contends with a running device step (a
        # tick-long lock would starve 16 submitting proxy threads).
        self._lock = threading.Lock()            # mailboxes + lifecycle only
        self._work = threading.Event()
        self._pending_submits: list[Request] = []
        self._pending_cancels: list[Request] = []
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False
        self._kill_exc: Optional[BaseException] = None
        # Stamped once per scheduler-loop iteration; a fleet health
        # monitor reads it (GIL-atomic float) to detect a wedged tick.
        self.last_tick = time.perf_counter()

    # ------------------------------------------------------------ submit
    def submit(self, prompt, *, max_new_tokens: int = 32,
               on_token: Optional[Callable[[int, str], None]] = None,
               on_done: Optional[Callable[[SessionResult], None]] = None,
               deadline_s: float = 0.0, rid: str | None = None,
               params: GenerationParams | dict | None = None,
               cache_salt: str = "", on_meta=None) -> SessionHandle:
        """Enqueue one streaming session; thread-safe, returns immediately.
        ``params`` (a :class:`GenerationParams`, or its dict wire form)
        carries the per-request sampling contract; when given, its
        ``max_tokens`` wins over the legacy ``max_new_tokens`` kwarg.
        ``cache_salt`` namespaces the session's prefix-cache tree (the
        gateway derives it from the authenticated principal, so tenants
        never share prefixes). ``on_meta`` fires once, just before the
        first token, with ``{"prefix_hit_tokens": n}`` — the number of
        prompt tokens the admission served from the shared KV pool."""
        gp = GenerationParams.of(params, max_tokens=max_new_tokens)
        max_new_tokens = gp.max_tokens
        tk = self.engine.tokenizer
        ids = tk.encode(prompt) if isinstance(prompt, str) else list(prompt)
        if self.batcher.window is None:
            # rolling-window sessions are unbounded (the window rolls);
            # everyone else obeys the seq-axis capacity rule
            ids, max_new_tokens = clip_prompt(ids, max_new_tokens,
                                              self.batcher.max_seq)
        rid = rid or uuid.uuid4().hex[:12]
        handle = SessionHandle(rid, lambda: None)
        state = {"dead_cb": False}

        def tok_cb(tid: int, text: str):
            if handle.ttft_s is None:
                handle.ttft_s = time.perf_counter() - handle.submitted_at
                handle.prefix_hit_tokens = req.prefix_hit_tokens
                if on_meta is not None:
                    meta = {"prefix_hit_tokens": req.prefix_hit_tokens}
                    st = self.batcher.pool_stats()
                    if st is not None:
                        # pool pressure at first token: the gateway
                        # forwards these as x-stream-pool-* headers
                        meta["pool_occupancy"] = st.occupancy
                        meta["pool_high_water"] = st.high_water
                        meta["pool_capacity"] = st.capacity
                    try:
                        on_meta(meta)
                    except Exception:
                        pass
            if on_token is not None and not state["dead_cb"]:
                try:
                    on_token(tid, text)
                except Exception:
                    # a broken consumer must not stall the shared batch:
                    # detach its callback and reclaim the slot
                    state["dead_cb"] = True
                    self._pending_cancels.append(req)

        def done_cb(r: Request):
            total = time.perf_counter() - handle.submitted_at
            ttft = handle.ttft_s if handle.ttft_s is not None else total
            n = len(r.output_ids)
            res = SessionResult(
                tokens=list(r.output_ids), text=r.final_text(tk),
                ttft_s=ttft, total_s=total,
                tok_per_s=n / max(total - ttft, 1e-9),
                n_prompt=len(ids), n_generated=n, cancelled=r.cancelled,
                finish_reason=r.finish_reason
                or ("cancelled" if r.cancelled else "stop"),
                error="callback error" if state["dead_cb"] else r.error,
                prefix_hit_tokens=r.prefix_hit_tokens, rolls=r._rolls)
            handle._result = res
            handle._event.set()
            if on_done is not None and not state["dead_cb"]:
                try:
                    on_done(res)
                except Exception:
                    pass

        req = Request(rid=rid, prompt_ids=ids, max_new_tokens=max_new_tokens,
                      on_token=tok_cb, on_done=done_cb, deadline_s=deadline_s,
                      params=gp, cache_salt=cache_salt)
        handle._cancel_fn = lambda: self._cancel(req)
        with self._lock:
            if self._shutdown:
                # typed + prompt: enqueueing into a dead mailbox would
                # leave the caller hanging until its result() timeout,
                # and gives a fleet circuit breaker nothing to catch
                raise SchedulerStopped("SessionBroker is shut down")
            self._pending_submits.append(req)
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="session-broker")
                self._thread.start()
        self._work.set()
        return handle

    # ------------------------------------------------------------ cancel
    def _cancel(self, req: Request):
        with self._lock:
            self._pending_cancels.append(req)
        self._work.set()

    # ------------------------------------------------------------ fleet hooks
    def depth(self) -> int:
        """Sessions submitted but not yet finished: pending mailbox +
        admission queue + active decode slots. Stale-tolerant (reads
        scheduler-owned lists without the tick lock) — a routing hint,
        not an invariant."""
        with self._lock:
            n = len(self._pending_submits)
        b = self.batcher
        try:
            n += len(b.queue) + b._in_flight()
        except Exception:
            pass
        return n

    def kill(self, reason: str = "replica killed"):
        """Hard-stop the scheduler: reject future submits (typed
        :class:`SchedulerStopped`) and fail every pending and in-flight
        session NOW with ``reason``, so their handles complete as
        ``cancelled`` with an error instead of hanging. Safe to call
        from any thread, including from an ``on_token`` callback on the
        scheduler thread itself: the loop drains at its next iteration
        top (never mid-tick), and there is no self-join."""
        exc = SchedulerStopped(reason)
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._kill_exc = exc
            thread = self._thread
        self._work.set()
        if thread is None or not thread.is_alive():
            # no live loop to drain for us: fail everything inline
            self._drain_killed(exc)

    def _drain_killed(self, exc: BaseException):
        with self._lock:
            subs, self._pending_submits = self._pending_submits, []
            self._pending_cancels = []
        err = f"{type(exc).__name__}: {exc}"
        for req in subs:
            # never reached the batcher: complete the handle directly
            req.error, req.done, req.cancelled = err, True, True
            if req.on_done:
                try:
                    req.on_done(req)
                except Exception:
                    pass
        self._fail_inflight(exc)

    # ------------------------------------------------------------ loop
    def _fail_inflight(self, exc: BaseException):
        """A device/scheduler error escaped a tick: complete every live
        session as cancelled (handles unblock with a result instead of
        hanging their callers for the full result() timeout)."""
        b = self.batcher
        live = list(b.queue)
        if b._adm is not None:
            live.append(b._adm.req)
        live.extend(r for r in b.active if r is not None)
        err = f"{type(exc).__name__}: {exc}"
        for req in live:
            req.error = err
            try:
                b.cancel(req)
            except Exception:
                # last resort: complete the handle directly
                req.done, req.cancelled = True, True
                if req.on_done:
                    req.on_done(req)

    def _loop(self):
        while True:
            with self._lock:
                if self._shutdown:
                    kill_exc = self._kill_exc
                    if kill_exc is None:
                        return
            if self._shutdown:
                # killed (not gracefully shut down): fail everything so
                # no handle hangs, then exit the scheduler thread
                self._drain_killed(kill_exc)
                return
            with self._lock:
                subs, self._pending_submits = self._pending_submits, []
                cans, self._pending_cancels = self._pending_cancels, []
            self.last_tick = time.perf_counter()
            try:
                for req in subs:
                    self.batcher.submit(req)
                for req in cans:
                    # a submit always reaches its mailbox before the
                    # matching cancel, so draining submits first keeps
                    # ordering sane
                    self.batcher.cancel(req)
                busy = bool(self.batcher.queue) or self.batcher._in_flight() > 0
                if busy:
                    self.batcher.step()
                    # a tick's on_token callbacks just woke consumer
                    # threads (gateway SSE queues, relay producers);
                    # offer the GIL so they run NOW instead of waiting
                    # out the interpreter's 5 ms switch interval —
                    # first-token delivery latency, not throughput
                    time.sleep(0)
            except Exception as e:
                # never let one bad tick kill the scheduler thread: fail
                # the in-flight sessions and keep serving new submits
                self._fail_inflight(e)
                busy = False
            if not busy:
                self._work.clear()
                with self._lock:
                    again = bool(self._pending_submits or self._pending_cancels)
                if not again:
                    self._work.wait(timeout=0.25)

    def shutdown(self, timeout: float = 5.0):
        with self._lock:
            self._shutdown = True
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout)
