"""The port's EngineFleet: cache-aware routing, work stealing and
mid-stream failover across data-parallel ServingEngine replicas (the
cases of ``tests/test_fleet.py``, on the port's engines on the CPU), and
``build_system(replicas=2)`` against the JAX package's with the same
params.

The fleet is a drop-in for the engine's ``submit()``: streams equal a
single engine's with the same params, a warm prefix routes the session
to the replica that owns the KV, sessions matched past the steal
threshold never move, and a replica dying mid-stream resumes elsewhere
with no token duplicated or dropped, greedy and seeded alike.
``submit()`` on a stopped broker raises the typed ``SchedulerStopped``
(a ``BackendError``), which the fleet raises when every replica is down
and the gateway turns into a 502.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import build_system as ref_build_system  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import build_system  # noqa: E402
from repro_torch.core.metrics import FleetMetrics  # noqa: E402
from repro_torch.core.sse import parse_sse  # noqa: E402
from repro_torch.errors import BackendError, SchedulerStopped  # noqa: E402
from repro_torch.models.interop import params_from_numpy  # noqa: E402
from repro_torch.serving import EngineFleet, ServingEngine  # noqa: E402
from repro_torch.serving.fleet import _FleetSession  # noqa: E402


def _cfg():
    return get_smoke_config("minitron-8b").replace(vocab_size=300, vocab_pad_to=64,
                                                   compute_dtype="float32")


@pytest.fixture(scope="module")
def fleet():
    f = EngineFleet.build(_cfg(), replicas=2, max_seq=96, scheduler_slots=4,
                          breaker_cooldown_s=0.5, device="cpu")
    f.warmup()
    yield f
    f.shutdown()


def _revive(fleet, idx):
    """Bring a killed replica back: a fresh broker on the next submit."""
    fleet.engines[idx].shutdown()
    fleet.replicas[idx].open_until = 0.0
    fleet.replicas[idx].dead = False
    fleet.replicas[idx].failures = 0


# --------------------------------------------------------------- identity
def test_fleet_stream_matches_single_engine(fleet):
    """Shared params and position-stable prefill: whichever replica serves
    the session, the stream equals the solo engine's output."""
    prompt = "fleet identity check prompt"
    solo = fleet.engines[0].generate(prompt, max_new_tokens=8)
    streamed = []
    h = fleet.submit(prompt, max_new_tokens=8, on_token=lambda t, s: streamed.append(t))
    res = h.result(timeout=60)
    assert res.error is None and not res.cancelled
    assert res.tokens == solo.tokens
    assert streamed == solo.tokens
    assert fleet.engines[1].params is fleet.engines[0].params


def test_cold_sessions_spread_across_replicas(fleet):
    handles = [fleet.submit(f"cold session number {i} padding words", max_new_tokens=8)
               for i in range(6)]
    results = [h.result(timeout=60) for h in handles]
    assert all(r.error is None and not r.cancelled for r in results)
    assert {h.replica for h in handles} == {0, 1}
    snap = fleet.metrics.snapshot()
    assert sum(snap["routed"]) >= 6 and len(snap["routed"]) == 2


# ---------------------------------------------------------------- routing
def test_warm_prefix_routes_to_owning_replica():
    """A 512-token warm prefix pulls the session onto the replica whose
    radix tree holds its pages, though the other one is idle and would
    win every load tie-break; another tenant's salt matches nothing."""
    f = EngineFleet.build(_cfg(), replicas=2, max_seq=1088, scheduler_slots=4,
                          prefix_cache_pages=272, device="cpu")
    try:
        f.warmup()
        prefix = [i % 250 + 2 for i in range(512)]
        salt = "tenant-a"
        r1 = f.engines[1].submit(prefix + [7, 8], max_new_tokens=4, cache_salt=salt)
        assert r1.result(timeout=120).error is None
        assert f.replicas[1].match_len(salt, prefix + [9, 9]) == 512
        assert f.replicas[0].match_len(salt, prefix + [9, 9]) == 0

        h = f.submit(prefix + [11, 12], max_new_tokens=4, cache_salt=salt)
        assert h.result(timeout=120).error is None
        assert h.replica == 1
        assert h.prefix_hit_tokens == 512
        route = [d for d in f.metrics.decisions() if d.kind == "route"][-1]
        assert route.replica == 1 and route.match_tokens == 512

        h2 = f.submit(prefix + [11, 12], max_new_tokens=4, cache_salt="tenant-b")
        assert h2.result(timeout=120).error is None
        assert h2.prefix_hit_tokens == 0
    finally:
        f.shutdown()


# ----------------------------------------------------------- work stealing
def test_steal_pass_never_moves_warm_sessions():
    """An overloaded replica's waiting sessions move only when their prefix
    match is at or below the threshold; started sessions never do."""
    eng = lambda: types.SimpleNamespace(page=16, scheduler=None,
                                        prefix_cache=None, scheduler_slots=4)
    f = EngineFleet([eng(), eng()], steal_threshold=16)
    f.replicas[0].depth = lambda: 8
    f.replicas[1].depth = lambda: 0
    stolen = []
    f._steal = lambda sess, src, dst: stolen.append(sess.rid) or True

    def sess(rid, match, started=False):
        s = _FleetSession(rid, [1, 2], None, "", 0.0, None, None, None)
        s.replica, s.match_tokens, s.started = 0, match, started
        return s

    f._sessions = {s.rid: s for s in (
        sess("cold", 0), sess("edge", 16), sess("warm", 32),
        sess("started", 0, started=True))}
    f._steal_pass()
    assert "warm" not in stolen
    assert "started" not in stolen
    assert "cold" in stolen and "edge" in stolen


def test_steal_threshold_defaults_to_one_page(fleet):
    assert fleet.steal_threshold == fleet.page


# --------------------------------------------------------------- failover
def _run_with_kill(fleet, prompt, params, killed):
    """Submit and kill the serving replica's broker after the 3rd streamed
    token; returns (handle, result, streamed ids)."""
    streamed, state = [], {}

    def on_tok(tid, s):
        streamed.append(tid)
        h = state.get("h")
        if not killed and len(streamed) >= 3 and h is not None:
            killed.append(h.replica)
            fleet.engines[h.replica].scheduler.kill("test kill")

    h = state["h"] = fleet.submit(prompt, params=params, on_token=on_tok)
    return h, h.result(timeout=120), streamed


@pytest.mark.parametrize("params", [
    {"max_tokens": 16},
    {"max_tokens": 16, "seed": 1234, "temperature": 0.9},
], ids=["greedy", "seeded"])
def test_kill_mid_stream_failover_is_token_identical(fleet, params):
    """A replica dying mid-stream resumes on the survivor and the client
    stream is the unfaulted stream: the resumed attempt replays from the
    prompt and the fleet swallows the first ``delivered`` tokens."""
    prompt = f"failover identity prompt {params.get('seed', 'greedy')}"
    ref = fleet.submit(prompt, params=dict(params)).result(timeout=120)
    assert ref.error is None and len(ref.tokens) == 16

    killed = []
    h, res, streamed = _run_with_kill(fleet, prompt, dict(params), killed)
    try:
        assert res.error is None and not res.cancelled
        assert h.attempts >= 2 and killed and killed[0] != h.replica
        assert streamed == ref.tokens
        assert res.tokens == ref.tokens
        assert any(d.kind == "failover" for d in fleet.metrics.decisions())
    finally:
        _revive(fleet, killed[0])


def test_all_replicas_down_raises_typed_error(fleet):
    for e in fleet.engines:
        e.submit("ensure broker exists", max_new_tokens=1).result(timeout=60)
        e.scheduler.kill("test: all down")
    try:
        with pytest.raises(SchedulerStopped):
            fleet.submit("nowhere to go", max_new_tokens=4)
        assert issubclass(SchedulerStopped, BackendError)
    finally:
        for i in range(len(fleet.engines)):
            _revive(fleet, i)


# ------------------------------------------------------- broker satellite
def test_broker_submit_after_shutdown_raises_scheduler_stopped():
    e = ServingEngine(_cfg(), max_seq=96, device="cpu")
    e.submit("start the broker", max_new_tokens=1).result(timeout=60)
    b = e.scheduler
    b.shutdown()
    with pytest.raises(SchedulerStopped):
        b.submit("too late", max_new_tokens=1)
    e.shutdown()


def test_broker_kill_fails_pending_and_inflight():
    e = ServingEngine(_cfg(), max_seq=96, scheduler_slots=2, device="cpu")
    hs = [e.submit(f"kill drain test {i}", max_new_tokens=32) for i in range(4)]
    e.scheduler.kill("wedged replica")
    for h in hs:
        res = h.result(timeout=30)
        assert res.cancelled and "wedged replica" in str(res.error)
    e.shutdown()


# --------------------------------------------------------------- metrics
def test_fleet_metrics_decision_log():
    m = FleetMetrics(2)
    m.record("route", 0, rid="a", match_tokens=0, queue_depth=1)
    m.record("steal", 1, rid="a", match_tokens=0, queue_depth=0)
    m.record("failover", 1, rid="b", match_tokens=32, queue_depth=2)
    assert m.snapshot() == {"replicas": 2, "routed": [1, 0], "stolen": [0, 1],
                            "failed_over": [0, 1]}
    assert [d.kind for d in m.decisions()] == ["route", "steal", "failover"]
    assert m.decisions()[-1].match_tokens == 32


# --------------------------------------------------- gateway integration
@pytest.fixture(scope="module")
def system2():
    """Two local replicas; HPC and cloud are down, so the local fleet is
    the only live tier."""
    s = build_system(replicas=2, hpc_fail=True, cloud_fail=True, dispatch_latency_s=0.0,
                     max_seq=160, device="cpu")
    yield s
    for e in s.engines.values():
        e.shutdown()
    s.endpoint.shutdown()


def test_gateway_replica_header_and_fleet_meta(system2):
    tok = system2.globus.issue_token("fleet@uic.edu")
    resp = system2.gateway.handle_chat_completions(
        {"model": "stream-local", "max_tokens": 4, "stream": True,
         "stream_options": {"include_usage": True},
         "messages": [{"role": "user", "content": "which replica?"}]}, bearer=tok)
    assert resp.status == 200
    assert resp.headers["x-stream-replica"] in ("0", "1")
    usage = parse_sse("".join(resp.stream))[-1]
    assert usage["stream"]["replica"] in (0, 1)
    assert len(usage["stream"]["fleet"]["routed"]) == 2
    assert int(resp.headers["x-stream-pool-capacity"]) > 0

    nresp = system2.gateway.handle_chat_completions(
        {"model": "stream-local", "max_tokens": 4, "stream": False,
         "messages": [{"role": "user", "content": "non-stream replica"}]}, bearer=tok)
    assert nresp.status == 200
    assert nresp.body["stream"]["replica"] in (0, 1)


def test_gateway_502_when_every_replica_down(system2):
    """Last for the fixture: it kills both local brokers. With HPC and
    cloud down as well, the gateway answers a clean 502."""
    flt = system2.engines["local"]
    assert isinstance(flt, EngineFleet)
    for e in flt.engines:
        e.submit("ensure broker", max_new_tokens=1).result(timeout=60)
        e.scheduler.kill("test: replica down")
    tok = system2.globus.issue_token("down@uic.edu")
    resp = system2.gateway.handle_chat_completions(
        {"model": "stream-local", "max_tokens": 4, "stream": False,
         "messages": [{"role": "user", "content": "anyone home?"}]}, bearer=tok)
    assert resp.status == 502
    assert resp.body["error"]["type"] == "upstream_error"


# ------------------------------------------------------ parity with JAX
def test_build_system_replicas_streams_like_reference():
    """build_system(replicas=2) on the CPU against the JAX package's with
    the reference's params in every replica: the local tier (the default
    xLSTM behind the fleet) streams the same tokens, and a session
    resumed on replica 1 after replica 0 died mid-stream too."""
    f32 = {"compute_dtype": "float32"}
    kw = dict(replicas=2, dispatch_latency_s=0.0, max_seq=160, cloud_ttft_s=0.0,
              hpc_overrides=f32, local_overrides=f32, prefix_cache_pages=16)
    ref = ref_build_system(**kw)
    port = build_system(device="cpu", **kw)
    try:
        flt = port.engines["local"]
        assert isinstance(flt, EngineFleet) and len(flt.engines) == 2
        params = params_from_numpy(jax.tree.map(np.asarray, ref.engines["local"].params))
        for e in flt.engines:
            e.params = params
        msgs = [{"role": "user", "content": "Say hello to the local replica fleet."}]
        streams = []
        for s in (ref, port):
            ids = []
            res = s.backends["local"].stream(msgs, max_tokens=12,
                                             on_token=lambda t, _: ids.append(t))
            assert res.n_completion_tokens == len(ids) > 0
            streams.append(ids)
        assert streams[0] == streams[1]
        prompt = port.engines["local"].tokenizer.encode("failover across the fleet")
        want = ref.engines["local"].submit(prompt, max_new_tokens=12).result(timeout=120)
        killed = []
        h, res, streamed = _run_with_kill(flt, prompt, {"max_tokens": 12}, killed)
        assert res.error is None and killed and h.replica != killed[0]
        assert streamed == res.tokens == want.tokens
    finally:
        for s in (ref, port):
            for e in s.engines.values():
                e.shutdown()
            s.endpoint.shutdown()
