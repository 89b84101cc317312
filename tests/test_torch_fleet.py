"""The port's fleet plane (paddle_tpu_torch.serving.router over the port's
DecodeEngine on device="cpu") against the JAX package: the router's
dispatch policy over fake engines (least-loaded, affinity, health gate,
typed admission, the in-flight bound, SLO deprioritise/shed); chunked
failover over two real engines whose weights come from the JAX
``init_decode_params`` — the replayed output equal bit for bit to the
JAX dense oracle and to the JAX router's tokens under the same kill; the
per-engine HTTP surface (typed 400/429/503/504, /stats, /metrics,
/adopt) and its client; and the router's SIGTERM drain in a subprocess
(``_torch_fleet_drain_worker.py``)."""
import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.inference.decode import reference_generate as jax_ref
from paddle_tpu.serving import FleetRouter as JaxRouter
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig,
                                               params_from_numpy,
                                               reference_generate)
from paddle_tpu_torch.inference.serving import (DeadlineExceeded,
                                                EngineStopped, Overloaded)
from paddle_tpu_torch.observability import parse_prometheus_text
from paddle_tpu_torch.observability.flight_recorder import flight_recorder
from paddle_tpu_torch.serving import (DecodeEngineServer, FleetRouter,
                                      FleetSLOSignal, HTTPReplica,
                                      MalformedPageFrame, MigrationClient,
                                      PrefillWorker, ReplicaUnroutable)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
# the failover drill: the probe session's replica dies after its first
# chunk while two other sessions are routed
PROBE = [7, 3, 1, 2]
OTHERS = [[9, 8], [int(t) for t in
                   np.random.RandomState(5).randint(0, 32, size=13)]]
NEW = 8


# ---------------------------------------------------------------------------
# fake replicas: dispatch policy without real engines
# ---------------------------------------------------------------------------
class _FakeHandle:
    def __init__(self, toks):
        self._toks = toks
        self.meta = {}

    def done(self):
        return True

    def result(self, timeout=None):
        return self._toks


class _FakeEngine:
    """A next-token function of the WHOLE folded context: a replayed
    prefix that lost or doubled a token diverges at once."""

    def __init__(self, pages=0, depth=0):
        self._ready = True
        self._dead = False
        self.queue_depth = depth
        self.served = 0

        class _P:
            pages_in_use = pages
        self.pool = _P()

    @property
    def ready(self):
        return self._ready

    @staticmethod
    def oracle(prompt, n):
        out, ctx = [], list(prompt)
        for _ in range(n):
            t = (sum(ctx) * 7 + len(ctx)) % 97
            out.append(t)
            ctx.append(t)
        return out

    def submit(self, prompt, max_new_tokens=16, deadline_s=None):
        if self._dead:
            raise EngineStopped("engine killed mid-generation")
        self.served += 1
        return _FakeHandle(self.oracle(prompt, max_new_tokens))

    @property
    def counters(self):
        return {}

    def drain(self, timeout=None):
        return True

    def stop(self):
        # a death the health probe has not noticed yet: the probe still
        # answers green, the next dispatch dies typed
        self._dead = True


def test_router_failover_replays_fake_engines_exactly():
    e0, e1 = _FakeEngine(), _FakeEngine()
    r = FleetRouter([e0, e1], chunk_tokens=4)
    killed = []

    def on_chunk(emitted):
        if not killed:
            name = r.session_replica("probe")
            (e0 if name == "local:0" else e1).stop()
            killed.append(name)

    h = r.submit([3, 5, 2], max_new_tokens=12, session="probe",
                 on_chunk=on_chunk)
    assert h.result(timeout=30) == _FakeEngine.oracle([3, 5, 2], 12)
    c = r.counters
    assert c["router_failovers"] >= 1 and c["router_replays"] >= 1
    assert c["router_dispatches"] == 3          # 12 tokens / chunk 4
    assert any(ev.get("kind") == "replica_dead"
               and ev.get("replica") == killed[0]
               for ev in flight_recorder().events())
    st = h.stats()
    assert "ttft_ms" in st and len(st["token_times"]) == 12
    assert r.engine_latency_stats()["n"] == 1


def test_router_least_loaded_dispatch():
    light = _FakeEngine(pages=1, depth=0)
    heavy = _FakeEngine(pages=30, depth=5)
    r = FleetRouter([light, heavy], chunk_tokens=8, affinity=False)
    for i in range(4):
        r.generate([1 + i], max_new_tokens=4, timeout=30)
    assert light.served == 4 and heavy.served == 0


def test_router_session_affinity_beats_load():
    a = _FakeEngine(pages=0)
    b = _FakeEngine(pages=10)
    r = FleetRouter([a, b], chunk_tokens=8)
    r.generate([1], max_new_tokens=4, session="s", timeout=30)
    assert r.session_replica("s") == "local:0"
    a.pool.pages_in_use = 50        # now the worse choice by load
    r.generate([2], max_new_tokens=4, session="s", timeout=30)
    assert r.session_replica("s") == "local:0"
    assert r.counters["router_affinity_hits"] >= 1
    r.generate([3], max_new_tokens=4, session="other", timeout=30)
    assert r.session_replica("other") == "local:1"


def test_router_health_gate_and_typed_admission():
    e0, e1 = _FakeEngine(), _FakeEngine()
    r = FleetRouter([e0, e1], chunk_tokens=8, max_attempts=2,
                    cooldown_s=0.0, sleep=lambda s: None)
    e0._ready = False               # the readiness gate skips it
    r.generate([5], max_new_tokens=4, timeout=30)
    assert e1.served == 1 and e0.served == 0
    with pytest.raises(ValueError):
        r.submit([], max_new_tokens=4)
    with pytest.raises(ValueError):
        r.submit([1], max_new_tokens=0)
    e1._ready = False               # nobody routable: a typed shed
    h = r.submit([6], max_new_tokens=4)
    with pytest.raises(Overloaded):
        h.result(timeout=30)
    assert not r.ready
    assert r.drain(timeout=5.0)
    with pytest.raises(EngineStopped):
        r.submit([7], max_new_tokens=4)


def test_router_max_inflight_sheds():
    gate = threading.Event()

    class _SlowEngine(_FakeEngine):
        def submit(self, prompt, max_new_tokens=16, deadline_s=None):
            gate.wait(timeout=30)
            return super().submit(prompt, max_new_tokens, deadline_s)

    r = FleetRouter([_SlowEngine()], chunk_tokens=8, max_inflight=1)
    h = r.submit([1], max_new_tokens=4)
    try:
        with pytest.raises(Overloaded):
            r.submit([2], max_new_tokens=4)
        assert r.counters["router_sheds"] == 1
    finally:
        gate.set()
    assert h.result(timeout=30)


def test_router_deadline_passed_is_typed():
    t = [0.0]
    r = FleetRouter([_FakeEngine()], chunk_tokens=2, clock=lambda: t[0])

    def on_chunk(emitted):
        t[0] = 10.0                 # the deadline passes mid-generation
    h = r.submit([1], max_new_tokens=6, deadline_s=5.0, on_chunk=on_chunk)
    with pytest.raises(DeadlineExceeded, match="after 2 tokens"):
        h.result(timeout=30)


# ---------------------------------------------------------------------------
# SLO burn signal -> shed/scale
# ---------------------------------------------------------------------------
def _slo_fetch(failed_by_target):
    def fetch(target, timeout=None):
        failed = failed_by_target.get(target, 0)
        return (f"decode_requests {failed_by_target['_requests']}\n"
                f"decode_failed {failed}\n")
    return fetch


def test_fleet_slo_signal_names_burning_engine():
    clock = [0.0]
    samples = {"_requests": 100, "a": 0, "b": 0}
    sig = FleetSLOSignal(["a", "b"], windows=((10.0, 1.0),),
                         clock=lambda: clock[0],
                         fetch=_slo_fetch(samples))
    assert sig.refresh() == set()
    clock[0] = 15.0
    samples.update(_requests=200, b=90)   # b burns, a stays clean
    assert sig.refresh() == {"b"}
    assert sig.burning() == {"b"}
    hint = sig.scale_hint()
    assert hint["burning"] == ["b"] and hint["action"] == "scale_up"


def test_router_deprioritizes_burning_and_sheds_when_all_burn():
    clock = [0.0]
    samples = {"_requests": 100, "local:0": 0, "local:1": 0}
    sig = FleetSLOSignal(["local:0", "local:1"], windows=((10.0, 1.0),),
                         clock=lambda: clock[0],
                         fetch=_slo_fetch(samples))
    sig.refresh()
    e0, e1 = _FakeEngine(pages=0), _FakeEngine(pages=50)
    r = FleetRouter([e0, e1], chunk_tokens=8, slo_signal=sig,
                    shed_on_burn=True)
    clock[0] = 15.0
    samples.update(_requests=200, **{"local:0": 90})  # best-by-load burns
    sig.refresh()
    r.generate([1], max_new_tokens=4, timeout=30)
    assert e1.served == 1 and e0.served == 0  # steered off the burner
    samples.update(**{"local:1": 90})          # now every replica burns
    clock[0] = 16.0
    sig.refresh()
    with pytest.raises(Overloaded):
        r.submit([2], max_new_tokens=4)
    assert r.counters["router_sheds"] >= 1


# ---------------------------------------------------------------------------
# real engines: failover parity against the JAX oracle and JAX router
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jparams():
    return jax_init(JCFG, 3)


@pytest.fixture(scope="module")
def np_params(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


def _drill(router, engines, prompts):
    """Route ``prompts`` (session i each); the probe's (session 0's)
    replica is stopped once its first chunk lands. Returns the tokens."""
    stopped = []

    def on_chunk(emitted):
        if not stopped:
            idx = int(router.session_replica("s0")[-1])
            engines[idx].stop()
            stopped.append(idx)

    handles = [router.submit(p, max_new_tokens=NEW, session=f"s{i}",
                             on_chunk=on_chunk if i == 0 else None)
               for i, p in enumerate(prompts)]
    return [h.result(timeout=60) for h in handles]


def _port_engines(np_params, n=2, **kw):
    out = []
    for _ in range(n):
        e = DecodeEngine(CFG, params=np_params, device="cpu", **GEOM, **kw)
        e.warm()
        e.start()
        out.append(e)
    return out


@pytest.fixture(scope="module")
def jax_drill(jparams):
    """The same drill through the JAX router over two JAX engines, and
    the JAX dense oracle of the probe prompt."""
    engines = []
    for _ in range(2):
        e = JaxEngine(JCFG, params=jparams, **GEOM)
        e.warm()
        e.start()
        engines.append(e)
    router = JaxRouter(engines, chunk_tokens=4, config=JCFG)
    try:
        toks = _drill(router, engines, [PROBE] + OTHERS)
        counters = router.counters
    finally:
        router.stop()
    return toks, counters, jax_ref(JCFG, jparams, PROBE, NEW)


def test_router_failover_over_real_engines_is_bitwise(np_params,
                                                      jax_drill):
    jax_toks, jax_counters, oracle = jax_drill
    engines = _port_engines(np_params)
    router = FleetRouter(engines, chunk_tokens=4, config=CFG)
    try:
        toks = _drill(router, engines, [PROBE] + OTHERS)
        c = router.counters
    finally:
        router.stop()
    assert toks[0] == oracle                 # the JAX dense oracle
    assert toks == jax_toks                  # the JAX router's tokens
    assert c["router_failovers"] >= 1 and c["router_replays"] >= 1
    assert jax_counters["router_failovers"] >= 1
    assert c["router_dispatches"] == len(toks) * NEW // 4


def test_local_replica_surfaces_an_idle_engine_as_engine_stopped(
        np_params):
    """An admitted handle that no scheduler will flush (the engine is
    not running) turns into the typed death the router fails over on,
    not a wait for the 120 s limit; the drill above meets the same
    check after a real stop()."""
    from paddle_tpu_torch.serving import LocalReplica

    eng = DecodeEngine(CFG, params=np_params, device="cpu", **GEOM)
    eng.warm()                      # warmed, never started: nothing runs
    with pytest.raises(EngineStopped, match="stopped mid-chunk"):
        LocalReplica(eng, name="idle").generate_chunk([1, 2], 4, None)
    assert eng.queue_depth == 1     # admitted, never served


# ---------------------------------------------------------------------------
# the per-engine HTTP surface
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served(np_params):
    eng = _port_engines(np_params, n=1)[0]
    srv = DecodeEngineServer(eng, port=0).start()
    yield eng, srv
    srv.stop()
    eng.stop()


def _request(replica, method, path, body=None):
    conn = http.client.HTTPConnection(replica.host, replica.port,
                                      timeout=10)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("X-Paddle-Error")
    finally:
        conn.close()


def test_http_surface_serves_and_rejects_typed(served, jparams):
    eng, srv = served
    replica = HTTPReplica(srv.endpoint)
    assert replica.ready()
    pages, depth = replica.load()
    assert pages >= 0 and depth >= 0
    out = replica.generate_chunk(PROBE, 5, None)
    assert out == jax_ref(JCFG, jparams, PROBE, 5)
    assert _request(replica, "GET", "/healthz")[:2] == (200, b"ok")
    status, body, _ = _request(replica, "GET", "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["ready"] is True
    assert stats["page_size"] == GEOM["page_size"]
    assert stats["vocab_size"] == CFG.vocab_size
    # a malformed frame: a typed 400 naming the error class
    status, _, err = _request(replica, "PUT", "/adopt", b"garbage")
    assert (status, err) == (400, "MalformedPageFrame")
    with pytest.raises(MalformedPageFrame):
        replica.adopt(b"garbage")
    # a bad generate body: a typed 400, not a hung socket
    status, _, err = _request(replica, "PUT", "/generate", b"{not json")
    assert (status, err) == (400, "ValueError")
    # /metrics rides along for the SLO scrape
    status, body, _ = _request(replica, "GET", "/metrics")
    samples = parse_prometheus_text(body.decode())
    assert status == 200 and samples["decode_requests"] >= 1
    assert samples['decode_e2e_ms_bucket{le="+Inf"}'] >= 1
    # the KV routes of the listener stay
    assert _request(replica, "PUT", "/scope/k", b"v")[0] == 200
    assert _request(replica, "GET", "/scope/k")[:2] == (200, b"v")


def test_http_adopt_then_route_hits_the_prefix(served, np_params):
    eng, srv = served
    replica = HTTPReplica(srv.endpoint)
    prompt = [int(t) for t in
              np.random.RandomState(42).randint(0, 32, size=16)]
    shipment = PrefillWorker(CFG, params=np_params, page_size=8,
                             device="cpu").prefill(prompt)
    rep = MigrationClient(replica.adopt).migrate(shipment)
    assert rep["ok"] and rep["adopted"] + rep["shared"] == 2
    hits0 = eng.pool.prefix_hits
    router = FleetRouter([replica], chunk_tokens=4, config=CFG)
    # the port's dense oracle (held to JAX's in test_torch_decode_model)
    assert router.generate(prompt, max_new_tokens=6, timeout=60) == \
        reference_generate(CFG, params_from_numpy(np_params, "cpu"),
                           prompt, 6)
    assert eng.pool.prefix_hits > hits0
    # the SLO signal scrapes the live endpoint. /metrics is the process's
    # registry, which other tests on this worker fill too, so the verdict
    # is read over a window that holds only this request (the cumulative
    # scrape is the base)
    clock = [0.0]
    sig = FleetSLOSignal([srv.endpoint], windows=((10.0, 1.0),),
                         clock=lambda: clock[0])
    sig.refresh()
    router.generate(prompt[:5], max_new_tokens=2, timeout=60)
    clock[0] = 15.0
    assert sig.refresh() == set()
    assert sig.scale_hint()["action"] == "steady"


def test_http_typed_admission_statuses(np_params):
    eng = DecodeEngine(CFG, params=np_params, device="cpu", **GEOM,
                       rate_limit=1e-3, burst=1, min_service_s=0.01)
    eng.warm()
    eng.start()
    srv = DecodeEngineServer(eng, port=0).start()
    replica = HTTPReplica(srv.endpoint, probe_ttl_s=0.0)
    try:
        def gen(body):
            return _request(replica, "PUT", "/generate",
                            json.dumps(body).encode())

        status, _, err = gen({"prompt": [1, 2], "max_new_tokens": 2,
                              "deadline_s": 0.001})
        assert (status, err) == (504, "DeadlineExceeded")
        status, body, _ = gen({"prompt": [1, 2], "max_new_tokens": 2})
        assert status == 200 and len(json.loads(body)["tokens"]) == 2
        status, _, err = gen({"prompt": [1, 2], "max_new_tokens": 2})
        assert (status, err) == (429, "Overloaded")   # the bucket is dry
        with pytest.raises(Overloaded):
            replica.generate_chunk([1, 2], 2, None)
        with pytest.raises(DeadlineExceeded):
            replica.generate_chunk([1, 2], 2, 0.001)
        eng.stop()
        assert replica.ready() is False
        assert _request(replica, "GET", "/readyz")[0] == 503
        status, _, err = gen({"prompt": [1, 2], "max_new_tokens": 2})
        assert (status, err) == (503, "EngineStopped")
        with pytest.raises(EngineStopped):
            replica.generate_chunk([1, 2], 2, None)
    finally:
        srv.stop()
        eng.stop()


def test_http_replica_unroutable_when_dead():
    replica = HTTPReplica("127.0.0.1:1")       # nothing listens there
    assert replica.ready() is False
    assert replica.load() is None
    with pytest.raises(ReplicaUnroutable):
        replica.generate_chunk([1], 2, None)


# ---------------------------------------------------------------------------
# SIGTERM drains the ROUTER duck-typed
# ---------------------------------------------------------------------------
def test_sigterm_drains_router_zero_lost(tmp_path):
    env = dict(os.environ)
    env.update({"PYTHONPATH": _REPO, "DRAIN_REQUESTS": "8",
                "PADDLE_FLIGHTREC_DIR": str(tmp_path)})
    worker = os.path.join(_REPO, "tests", "_torch_fleet_drain_worker.py")
    proc = subprocess.run([sys.executable, worker], env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"DRAINED done=8 ok=8 total=8" in proc.stdout
    dumps = [json.load(open(tmp_path / f)) for f in os.listdir(tmp_path)
             if f.startswith("flightrec_")]
    assert any(d["reason"] == "sigterm_drain" for d in dumps), \
        "the sigterm drain must leave a postmortem dump"
