"""Control plane: a Globus-Compute-style batch task executor.

Semantics mirrored from the paper (§3, §3.2):
  * batch model — submit() returns a future; the full return value comes
    back only when the task ends. No incremental output exists on this
    plane; streaming is the data plane's job.
  * dispatch latency — Globus Compute takes a few hundred ms to get a
    task onto the endpoint; configurable ``dispatch_latency_s`` models
    it (benchmarks use a realistic value, tests ~0).
  * source-string serialization — the paper ships the remote function as
    a source string executed with exec() because dill can't resolve
    PyInstaller imports on the endpoint; we reproduce exactly that
    mechanism (and it doubles as our isolation boundary).
  * worker_init credentials — RELAY_SECRET / RELAY_ENCRYPTION_KEY are
    pre-provisioned into the worker environment at endpoint setup and
    read from env inside the remote function; they are never task
    arguments and never appear in task records (asserted in tests).
  * faults — per-task deadline, worker failure injection, and retry
    accounting give the middleware a straggler-mitigation surface.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any

FORBIDDEN_ARG_NAMES = {"relay_secret", "encryption_key", "relay_encryption_key", "secret"}


class ControlPlaneError(Exception):
    pass


class TaskFailed(ControlPlaneError):
    pass


@dataclass
class TaskRecord:
    """The audit record for one task — what AMQP would carry.
    Deliberately excludes worker env; tests assert no secret ever lands
    here."""
    task_id: str
    fn_name: str
    kwargs: dict
    submitted_at: float
    started_at: float | None = None
    finished_at: float | None = None
    status: str = "pending"      # pending | running | done | failed
    error: str | None = None


class TaskFuture:
    def __init__(self, record: TaskRecord):
        self.record = record
        self._event = threading.Event()
        self._result: Any = None
        self._exc: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"task {self.record.task_id} still "
                               f"{self.record.status} after {timeout}s")
        if self._exc is not None:
            raise TaskFailed(str(self._exc)) from self._exc
        return self._result

    def _set(self, result=None, exc=None):
        self._result, self._exc = result, exc
        self._event.set()


class ComputeEndpoint:
    """A persistent worker pool behind a batch interface.

    ``worker_init_env`` is the paper's worker_init: credentials loaded
    into the remote process environment at endpoint start. Remote
    functions receive it as the implicit global WORKER_ENV (our stand-in
    for os.environ on the worker — we avoid mutating the real process
    env so tests stay hermetic).
    """

    def __init__(self, name: str = "endpoint", *, worker_init_env: dict | None = None,
                 n_workers: int = 2, dispatch_latency_s: float = 0.0,
                 auth_check_latency_s: float = 0.0, fail_rate: float = 0.0,
                 extra_globals: dict | None = None):
        self.name = name
        self._env = dict(worker_init_env or {})
        self.dispatch_latency_s = dispatch_latency_s
        self.auth_check_latency_s = auth_check_latency_s
        self.fail_rate = fail_rate
        self._extra_globals = dict(extra_globals or {})
        self._q: queue.Queue = queue.Queue()
        self._records: list[TaskRecord] = []
        self._lock = threading.Lock()
        self._shutdown = False
        self._failure_counter = 0
        self._workers = [threading.Thread(target=self._worker_loop, daemon=True)
                         for _ in range(n_workers)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------- admin
    def health_check(self) -> bool:
        """The paper's lightweight ~100 ms Globus auth check (§2.2)."""
        if self.auth_check_latency_s:
            time.sleep(self.auth_check_latency_s)
        return not self._shutdown

    def shutdown(self):
        self._shutdown = True

    def task_records(self) -> list[TaskRecord]:
        with self._lock:
            return list(self._records)

    # ------------------------------------------------------------- submit
    def submit(self, fn_source: str, fn_name: str, /, **kwargs) -> TaskFuture:
        """Ship ``fn_source`` (a def for ``fn_name``) and run it with kwargs.

        Credentials MUST NOT be passed here — enforced, mirroring the
        paper's guarantee that secrets never traverse the control plane.
        """
        bad = FORBIDDEN_ARG_NAMES & set(kwargs)
        if bad:
            raise ControlPlaneError(
                f"credentials must be pre-provisioned via worker_init, "
                f"not task arguments: {sorted(bad)}")
        if self._shutdown:
            raise ControlPlaneError(f"endpoint {self.name} is down")
        rec = TaskRecord(task_id=str(uuid.uuid4()), fn_name=fn_name,
                         kwargs=dict(kwargs), submitted_at=time.time())
        fut = TaskFuture(rec)
        with self._lock:
            self._records.append(rec)
        self._q.put((fn_source, fn_name, kwargs, rec, fut))
        return fut

    # ------------------------------------------------------------- worker
    def _worker_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn_source, fn_name, kwargs, rec, fut = item
            if self.dispatch_latency_s:
                time.sleep(self.dispatch_latency_s)
            rec.status = "running"
            rec.started_at = time.time()
            try:
                if self.fail_rate:
                    self._failure_counter += 1
                    if (self._failure_counter * self.fail_rate) % 1.0 < self.fail_rate:
                        raise RuntimeError("injected worker failure")
                # The paper's serialization workaround: exec the source.
                ns: dict = {"WORKER_ENV": dict(self._env), "__name__": "__worker__"}
                ns.update(self._extra_globals)
                exec(fn_source, ns)
                fn = ns[fn_name]
                result = fn(**kwargs)
                rec.status, rec.finished_at = "done", time.time()
                fut._set(result=result)
            except BaseException as e:  # noqa: BLE001 — report to future
                rec.status, rec.finished_at = "failed", time.time()
                rec.error = f"{type(e).__name__}: {e}"
                fut._set(exc=e)


def submit_with_retries(endpoint: ComputeEndpoint, fn_source: str, fn_name: str,
                        *, retries: int = 1, deadline_s: float | None = None,
                        **kwargs):
    """Straggler/fault mitigation: re-dispatch on failure or deadline."""
    last: Exception | None = None
    for _ in range(retries + 1):
        fut = endpoint.submit(fn_source, fn_name, **kwargs)
        try:
            return fut.result(timeout=deadline_s)
        except (TaskFailed, TimeoutError) as e:
            last = e
    raise last  # type: ignore[misc]
