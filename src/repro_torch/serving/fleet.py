"""EngineFleet — data-parallel ServingEngine replicas behind one submit().

One ServingEngine = one device = one broker, which caps the system at a
single replica's throughput. The fleet owns N replicas (each with its
own broker, scheduler, PagePool, and prefix cache) and is a **drop-in**
for the engine's ``submit()`` surface, so the tier backends and the
gateway never learn how many devices sit behind the local tier.

Routing is cache-aware: for every session the fleet peeks each
replica's radix prefix tree (:meth:`PrefixCache.match_len`, a lock-free
read) for the longest salted token-prefix match and places the session
on the replica with the most reusable KV, tie-breaking on queue depth
then pool occupancy. Cold sessions (no match anywhere) therefore fall
out as least-loaded dispatch. A background monitor runs a work-stealing
pass that re-queues *waiting* admissions (no first token yet, prefix
match at or below the steal threshold) from overloaded replicas to idle
ones.

Robustness:

* circuit breaker — consecutive submit/stream failures open the
  replica for a cooldown; a typed :class:`SchedulerStopped` from a dead
  broker is the prompt signal that trips it.
* tick-liveness heartbeat — a replica whose scheduler has work but has
  not completed a loop iteration within ``tick_timeout_s`` is declared
  wedged: its broker is killed and its sessions failed over.
* mid-stream failover — when a replica faults during a stream, the
  fleet resubmits the session on a healthy replica and **swallows the
  first ``delivered`` tokens** of the replay (the duplicate-safe
  ``_ResumeTap`` idiom from the tier-fallback path). Replicas share
  parameters and sampling is (seed, step)-keyed, so the replayed stream
  is token-identical and the client never sees a duplicated or dropped
  token.

Every callback the fleet installs runs on some replica's scheduler
thread and keeps the broker contract: never block, never call back into
the same broker's ``submit``. Failover resubmission targets a
*different* replica's broker (thread-safe, returns immediately), so the
contract holds.

The replicas may share one device: each broker ticks on its own thread.
``warmup`` builds the Hopper kernels of a CUDA fleet before any replica
serves, so no first tick waits on ``nvcc`` past ``tick_timeout_s``.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Optional

from repro_torch.errors import SchedulerStopped
from repro_torch.serving.broker import SessionResult
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import GenerationParams


class _Replica:
    """Fleet-side state for one engine replica."""

    def __init__(self, idx: int, engine):
        self.idx = idx
        self.engine = engine
        self.failures = 0          # consecutive faults (submit or stream)
        self.open_until = 0.0      # circuit open (skip for routing) until
        self.dead = False          # wedged scheduler: permanently retired

    def healthy(self, now: float) -> bool:
        return not self.dead and now >= self.open_until

    # ---- stale-tolerant routing signals (no locks, hints only) ----
    def depth(self) -> int:
        b = self.engine.scheduler
        return b.depth() if b is not None else 0

    def match_len(self, salt: str, ids: list) -> int:
        pc = self.engine.prefix_cache
        return pc.match_len(salt, ids) if pc is not None else 0

    def occupancy(self) -> int:
        b = self.engine.scheduler
        if b is None:
            return 0
        try:
            st = b.batcher.pool_stats()
            return st.occupancy if st is not None else 0
        except Exception:
            return 0


class _FleetSession:
    """One client session's fleet-side record, across attempts.

    ``gen`` is the attempt generation: every callback closes over the
    generation it was installed for and ignores itself if a steal or
    failover has since moved the session (so a dying replica's late
    callbacks can never corrupt the resumed stream). ``delivered`` /
    ``seen`` / ``skip`` are the resume-tap counters: a new attempt sets
    ``skip = delivered`` and its first ``skip`` tokens are swallowed."""

    __slots__ = ("rid", "ids", "gp", "cache_salt", "deadline_s",
                 "on_token", "on_done", "on_meta", "lock", "gen",
                 "delivered", "seen", "skip", "started", "finished",
                 "client_cancel", "replica", "match_tokens", "handle",
                 "attempts", "excluded", "fleet_handle")

    def __init__(self, rid, ids, gp, cache_salt, deadline_s,
                 on_token, on_done, on_meta):
        self.rid = rid
        self.ids = ids
        self.gp = gp
        self.cache_salt = cache_salt
        self.deadline_s = deadline_s
        self.on_token = on_token
        self.on_done = on_done
        self.on_meta = on_meta
        self.lock = threading.Lock()
        self.gen = 0
        self.delivered = 0         # tokens forwarded to the caller, total
        self.seen = 0              # tokens seen from the current attempt
        self.skip = 0              # replayed tokens to swallow this attempt
        self.started = False       # first token forwarded -> not stealable
        self.finished = False
        self.client_cancel = False
        self.replica = -1          # current placement
        self.match_tokens = 0      # prefix match at last placement
        self.handle = None         # current attempt's SessionHandle
        self.attempts = 0
        self.excluded: set = set() # replicas that already faulted on us
        self.fleet_handle = None   # caller-side FleetHandle


class FleetHandle:
    """Caller-side handle, shaped like a broker ``SessionHandle``."""

    def __init__(self, rid: str, sess: _FleetSession):
        self.rid = rid
        self.submitted_at = time.perf_counter()
        self.ttft_s: Optional[float] = None
        self.prefix_hit_tokens = 0
        self._sess = sess
        self._event = threading.Event()
        self._result: Optional[SessionResult] = None

    @property
    def replica(self) -> int:
        """Replica currently (or last) serving the session."""
        return self._sess.replica

    @property
    def attempts(self) -> int:
        return self._sess.attempts

    def cancel(self):
        sess = self._sess
        with sess.lock:
            sess.client_cancel = True
            h = sess.handle
        if h is not None:
            h.cancel()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> SessionResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"session {self.rid} still running after {timeout}s")
        return self._result  # type: ignore[return-value]


class EngineFleet:
    """N data-parallel ServingEngine replicas behind one ``submit()``."""

    def __init__(self, engines: list, *, steal_threshold: int | None = None,
                 heartbeat_s: float = 0.05, tick_timeout_s: float = 30.0,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 2.0,
                 metrics=None):
        # deferred: repro_torch.core.metrics sits under the repro_torch.core
        # package init, which imports repro_torch.serving; importing it at
        # module scope would make `import repro_torch.serving.fleet`
        # order-sensitive
        from repro_torch.core.metrics import FleetMetrics
        if not engines:
            raise ValueError("EngineFleet needs at least one engine")
        self.engines = list(engines)
        self.replicas = [_Replica(i, e) for i, e in enumerate(self.engines)]
        # a session whose prefix match exceeds this many tokens is never
        # stolen — moving it would forfeit more reusable KV than the
        # queue-wait it saves. Default: one KV page.
        self.steal_threshold = (steal_threshold if steal_threshold is not None
                                else getattr(self.engines[0], "page", 16))
        self.heartbeat_s = heartbeat_s
        self.tick_timeout_s = tick_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.metrics = metrics or FleetMetrics(len(self.engines))
        self._lock = threading.Lock()              # sessions dict + lifecycle
        self._sessions: dict[str, _FleetSession] = {}
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, cfg, *, replicas: int = 2, seed: int = 0, params=None,
              device=None, **kw) -> "EngineFleet":
        """Build N replicas sharing ONE parameter set (replica 0 inits,
        the rest receive ``params=``) — shared params are what make a
        failed-over stream token-identical on the surviving replica.
        ``seed`` and ``device`` go to every ``ServingEngine`` (the port's
        engine takes a seed where the JAX package's takes ``rng``), so
        every replica draws from the same ``PRNGKey(seed)`` streams.
        Engine kwargs (``max_seq``, ``scheduler_slots``, ...) and fleet
        kwargs (``steal_threshold``, ``tick_timeout_s``, ...) both ride
        ``kw``."""
        fleet_keys = {"steal_threshold", "heartbeat_s", "tick_timeout_s",
                      "breaker_threshold", "breaker_cooldown_s", "metrics"}
        fkw = {k: kw.pop(k) for k in list(kw) if k in fleet_keys}
        engines = []
        for i in range(replicas):
            e = ServingEngine(cfg, params=params, seed=seed, device=device, **kw)
            params = e.params          # replica 0 initialised; share it
            engines.append(e)
        return cls(engines, **fkw)

    # ------------------------------------------------------------ delegation
    # The tier backends and system wiring treat the fleet as an engine.
    @property
    def tokenizer(self):
        return self.engines[0].tokenizer

    @property
    def max_seq(self):
        return self.engines[0].max_seq

    @property
    def page(self):
        return self.engines[0].page

    @property
    def params(self):
        return self.engines[0].params

    @property
    def cfg(self):
        return self.engines[0].cfg

    def warmup(self, *a, **kw):
        if any(e.device.type == "cuda" for e in self.engines):
            # the kernels build at first use (nvcc, tens of seconds): build
            # them all now, before the monitor can time a replica's tick
            from repro_torch.kernels import _build
            _build.build_all()
        for e in self.engines:
            e.warmup(*a, **kw)

    def shutdown(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        for e in self.engines:
            e.shutdown()

    # ------------------------------------------------------------ routing
    def _candidates(self, exclude: set) -> list:
        now = time.perf_counter()
        return [r for r in self.replicas
                if r.idx not in exclude and r.healthy(now)]

    def _route(self, ids, salt, exclude: set):
        """Pick (replica, match_tokens, depth): longest prefix match
        first, then shallowest queue, then lowest pool occupancy. All
        three signals are stale-tolerant reads — a hint race costs one
        suboptimal placement, never correctness."""
        cands = self._candidates(exclude)
        if not cands:
            return None
        scored = [(r, r.match_len(salt, ids), r.depth()) for r in cands]
        scored.sort(key=lambda t: (-t[1], t[2], t[0].occupancy(), t[0].idx))
        return scored[0]

    # ------------------------------------------------------------ submit
    def submit(self, prompt, *, max_new_tokens: int = 32,
               on_token: Optional[Callable[[int, str], None]] = None,
               on_done=None, deadline_s: float = 0.0, rid: str | None = None,
               params: GenerationParams | dict | None = None,
               cache_salt: str = "", on_meta=None) -> FleetHandle:
        """Drop-in for :meth:`ServingEngine.submit`: route to the best
        replica and return immediately. Raises :class:`SchedulerStopped`
        (a ``BackendError``) when every replica is down — the tier chain
        turns that into fallback / a clean 502."""
        self._ensure_monitor()
        gp = GenerationParams.of(params, max_tokens=max_new_tokens)
        tk = self.tokenizer
        ids = tk.encode(prompt) if isinstance(prompt, str) else list(prompt)
        rid = rid or uuid.uuid4().hex[:12]
        sess = _FleetSession(rid, ids, gp, cache_salt, deadline_s,
                             on_token, on_done, on_meta)
        handle = FleetHandle(rid, sess)
        sess.fleet_handle = handle
        with self._lock:
            self._sessions[rid] = sess
        err = self._dispatch(sess, handle, kind="route")
        if err is not None:
            with self._lock:
                self._sessions.pop(rid, None)
            raise err
        return handle

    def _dispatch(self, sess: _FleetSession, handle: FleetHandle,
                  kind: str) -> Optional[Exception]:
        """Place (or re-place) ``sess``. Returns an exception instead of
        raising so failover paths — which run on scheduler threads with
        no caller to catch — can finalize the handle instead."""
        while True:
            pick = self._route(sess.ids, sess.cache_salt, sess.excluded)
            if pick is None:
                return SchedulerStopped(
                    f"no healthy replica (of {len(self.replicas)}) "
                    f"for session {sess.rid}")
            rep, match, depth = pick
            with sess.lock:
                sess.gen += 1
                sess.skip = sess.delivered
                sess.seen = 0
                sess.replica = rep.idx
                sess.match_tokens = match
                sess.attempts += 1
                my_gen = sess.gen
            try:
                h = rep.engine.submit(
                    sess.ids, params=sess.gp, deadline_s=sess.deadline_s,
                    rid=f"{sess.rid}.{sess.attempts}",
                    cache_salt=sess.cache_salt,
                    on_token=self._tok_cb(sess, my_gen, handle),
                    on_done=self._done_cb(sess, my_gen, handle, rep),
                    on_meta=self._meta_cb(sess, my_gen, handle, rep))
            except Exception as e:
                self._note_failure(rep, e)
                sess.excluded.add(rep.idx)
                continue
            rep.failures = 0
            with sess.lock:
                sess.handle = h
                cancel_now = sess.client_cancel
            self.metrics.record(kind, rep.idx, rid=sess.rid,
                                match_tokens=match, queue_depth=depth)
            if cancel_now:
                h.cancel()       # client cancelled during the re-place race
            return None

    # ------------------------------------------------------------ callbacks
    def _tok_cb(self, sess: _FleetSession, my_gen: int, handle: FleetHandle):
        def cb(tid: int, text: str):
            with sess.lock:
                if sess.gen != my_gen or sess.finished:
                    return
                if sess.seen < sess.skip:
                    # replayed prefix of a resumed stream: position
                    # stability + shared params make it identical to
                    # what the caller already has — swallow it
                    sess.seen += 1
                    return
                sess.seen += 1
                sess.delivered += 1
                sess.started = True
                if handle.ttft_s is None:
                    handle.ttft_s = time.perf_counter() - handle.submitted_at
                fwd = sess.on_token
            if fwd is not None:
                fwd(tid, text)
        return cb

    def _meta_cb(self, sess: _FleetSession, my_gen: int, handle: FleetHandle,
                 rep: _Replica):
        def cb(meta: dict):
            with sess.lock:
                if sess.gen != my_gen or sess.finished:
                    return
                handle.prefix_hit_tokens = int(meta.get("prefix_hit_tokens", 0))
                fwd = sess.on_meta
            if fwd is None:
                return
            out = dict(meta)
            out["replica"] = rep.idx
            out["fleet"] = self.metrics.snapshot()
            # pool pressure aggregated across the fleet: the gateway's
            # x-stream-pool-* headers describe ALL the KV behind the
            # tier, not whichever replica answered
            agg = self.pool_stats()
            if agg is not None:
                out.update(agg)
            fwd(out)
        return cb

    def _done_cb(self, sess: _FleetSession, my_gen: int, handle: FleetHandle,
                 rep: _Replica):
        def cb(res: SessionResult):
            with sess.lock:
                if sess.gen != my_gen or sess.finished:
                    return
                client_cancel = sess.client_cancel
            faulted = res.cancelled and not client_cancel
            if not faulted:
                self._finalize(sess, handle, res)
                return
            # replica fault mid-session: breaker bookkeeping, then
            # resume on a healthy replica from the delivered count
            self._note_failure(rep, res.error or "cancelled by broker")
            sess.excluded.add(rep.idx)
            err = self._dispatch(sess, handle, kind="failover")
            if err is not None:
                # nowhere left to resume: surface the fault
                res.error = res.error or str(err)
                self._finalize(sess, handle, res)
        return cb

    def _finalize(self, sess: _FleetSession, handle: FleetHandle,
                  res: SessionResult):
        with sess.lock:
            if sess.finished:
                return
            sess.finished = True
        with self._lock:
            self._sessions.pop(sess.rid, None)
        handle.prefix_hit_tokens = max(handle.prefix_hit_tokens,
                                       res.prefix_hit_tokens)
        handle._result = res
        handle._event.set()
        if sess.on_done is not None:
            try:
                sess.on_done(res)
            except Exception:
                pass

    def _note_failure(self, rep: _Replica, err):
        rep.failures += 1
        if rep.failures >= self.breaker_threshold:
            # open the circuit; after the cooldown one trial half-opens it
            rep.open_until = time.perf_counter() + self.breaker_cooldown_s
            rep.failures = 0

    # ------------------------------------------------------------ monitor
    def _ensure_monitor(self):
        if self._monitor is not None or self._stop.is_set():
            return
        with self._lock:
            if self._monitor is None:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, daemon=True,
                    name="fleet-monitor")
                self._monitor.start()

    def _monitor_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._liveness_pass()
                self._steal_pass()
            except Exception:
                pass    # the monitor must outlive any one bad pass

    def _liveness_pass(self):
        now = time.perf_counter()
        for rep in self.replicas:
            if rep.dead:
                continue
            b = rep.engine.scheduler
            if b is None or b._thread is None or b._shutdown:
                continue
            busy = False
            try:
                busy = bool(b.batcher.queue) or b.batcher._in_flight() > 0
            except Exception:
                pass
            if busy and now - b.last_tick > self.tick_timeout_s:
                # scheduler has work but hasn't completed an iteration:
                # wedged. Retire the replica and move its sessions.
                rep.dead = True
                try:
                    b.kill(f"replica {rep.idx} tick-liveness timeout "
                           f"({self.tick_timeout_s}s)")
                except Exception:
                    pass
                self._failover_replica(rep, "tick-liveness timeout")

    def _failover_replica(self, rep: _Replica, reason: str):
        """Force-fail every fleet session placed on ``rep`` over to a
        healthy replica (used when the broker is too wedged to run its
        own failure callbacks)."""
        with self._lock:
            victims = [s for s in self._sessions.values()
                       if s.replica == rep.idx and not s.finished]
        for sess in victims:
            handle = getattr(sess, "fleet_handle", None)
            with sess.lock:
                if sess.finished or sess.replica != rep.idx:
                    continue
                sess.excluded.add(rep.idx)
            err = self._dispatch(sess, handle, kind="failover")
            if err is not None and handle is not None:
                self._finalize(sess, handle, SessionResult(
                    tokens=[], text="", ttft_s=0.0, total_s=0.0,
                    tok_per_s=0.0, n_prompt=len(sess.ids), n_generated=0,
                    cancelled=True, finish_reason="cancelled",
                    error=f"{reason}; {err}"))

    def _steal_pass(self):
        """Re-queue waiting admissions from overloaded replicas to idle
        ones. Only sessions with no delivered token AND a prefix match
        at or below the steal threshold move — warm sessions stay with
        their KV."""
        now = time.perf_counter()
        depths = {r.idx: r.depth() for r in self.replicas if r.healthy(now)}
        if len(depths) < 2:
            return
        for rep in self.replicas:
            if rep.idx not in depths:
                continue
            slots = getattr(rep.engine, "scheduler_slots", 4)
            if depths[rep.idx] <= slots:
                continue            # not overloaded
            idle = [r for r in self.replicas
                    if r.idx in depths and r.idx != rep.idx
                    and depths[r.idx] < slots
                    and depths[r.idx] + 1 < depths[rep.idx]]
            if not idle:
                continue
            idle.sort(key=lambda r: depths[r.idx])
            with self._lock:
                waiting = [s for s in self._sessions.values()
                           if s.replica == rep.idx and not s.started
                           and not s.finished]
            for sess in waiting:
                if not idle:
                    break
                if sess.match_tokens > self.steal_threshold:
                    continue        # never steal a warm session
                target = idle[0]
                moved = self._steal(sess, rep, target)
                if moved:
                    depths[rep.idx] -= 1
                    depths[target.idx] += 1
                    if depths[target.idx] >= slots:
                        idle.pop(0)
                if depths[rep.idx] <= slots:
                    break

    def _steal(self, sess: _FleetSession, src: _Replica,
               dst: _Replica) -> bool:
        with sess.lock:
            if (sess.finished or sess.client_cancel or sess.started
                    or sess.replica != src.idx):
                return False
            # invalidate the old attempt FIRST: its callbacks go stale
            # the moment gen moves, so a token raced in by src's
            # scheduler is swallowed, not double-delivered
            sess.gen += 1
            sess.skip = sess.delivered
            sess.seen = 0
            old = sess.handle
            my_gen = sess.gen
            sess.replica = dst.idx
            sess.attempts += 1
        if old is not None:
            old.cancel()
        handle = sess.fleet_handle
        depth = dst.depth()
        try:
            h = dst.engine.submit(
                sess.ids, params=sess.gp, deadline_s=sess.deadline_s,
                rid=f"{sess.rid}.{sess.attempts}", cache_salt=sess.cache_salt,
                on_token=self._tok_cb(sess, my_gen, handle),
                on_done=self._done_cb(sess, my_gen, handle, dst),
                on_meta=self._meta_cb(sess, my_gen, handle, dst))
        except Exception as e:
            self._note_failure(dst, e)
            # fall back to a full re-dispatch (anywhere healthy)
            sess.excluded.add(dst.idx)
            err = self._dispatch(sess, handle, kind="steal")
            if err is not None:
                self._finalize(sess, handle, SessionResult(
                    tokens=[], text="", ttft_s=0.0, total_s=0.0,
                    tok_per_s=0.0, n_prompt=len(sess.ids), n_generated=0,
                    cancelled=True, finish_reason="cancelled", error=str(err)))
            return True
        with sess.lock:
            sess.handle = h
            sess.match_tokens = dst.match_len(sess.cache_salt, sess.ids)
        self.metrics.record("steal", dst.idx, rid=sess.rid,
                            match_tokens=sess.match_tokens, queue_depth=depth)
        return True

    # ------------------------------------------------------------ stats
    def pool_stats(self) -> Optional[dict]:
        """Aggregate page-pool pressure across every started replica."""
        occ = hw = cap = 0
        seen = False
        for e in self.engines:
            b = e.scheduler
            if b is None:
                continue
            try:
                st = b.batcher.pool_stats()
            except Exception:
                st = None
            if st is None:
                continue
            seen = True
            occ += st.occupancy
            hw += st.high_water
            cap += st.capacity
        if not seen:
            return None
        return {"pool_occupancy": occ, "pool_high_water": hw,
                "pool_capacity": cap}
