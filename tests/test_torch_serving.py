"""The port's batch serving (paddle_tpu_torch.inference.serving on the
CPU) against the JAX package: the bucketed ``AnalysisPredictor`` over an
inference blob the port's static graph saves from the JAX tests' program
(a 6 -> 16 -> 3 fc net) with the JAX startup scope's weights carried
across, its outputs against the JAX ``AnalysisPredictor``'s; the
``ServingEngine``'s continuous batching, admission control, deadlines,
chaos-driven retry -> degraded row-by-row leg -> typed failure, drain and
stop; the hardened KV listener; the health probes; and the SIGTERM drain
in a subprocess (``_torch_serving_drain_worker.py``).

The engine is driven synchronously (``run_once``) with an injectable
clock wherever the JAX tests do so: no sleeps. The JAX programs run in
their own ``static.Scope()`` without ``paddle.enable_static()``."""
import http.client
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.static as js
from paddle_tpu.inference import AnalysisPredictor as JaxPredictor
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.static as ts
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed.http_kv import KVClient, KVServer
from paddle_tpu_torch.fault import injector as fault
from paddle_tpu_torch.inference import (AnalysisPredictor,
                                        DeadlineExceeded, EngineStopped,
                                        Overloaded, RequestFailed,
                                        ServingEngine, ServingHealthServer)
from paddle_tpu_torch.utils import unique_name as tun

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRAIN_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "_torch_serving_drain_worker.py")
CPU = ts.CPUPlace()


def _counter(name):
    return profiler.counters_snapshot().get(name, 0)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.disarm_all()


def _net(static, un, seed, in_dim, out_dim, with_mean):
    with un.guard():
        main, startup = static.Program(), static.Program()
        main.random_seed = startup.random_seed = seed
        with static.program_guard(main, startup):
            x = static.data("x", [-1, in_dim])
            if with_mean:
                out = static.nn.fc(x, 4)
                fetches = [out, static.mean(out)]
            else:
                h = static.nn.fc(x, 16, act="relu")
                fetches = [static.nn.fc(h, out_dim)]
    return main, startup, fetches


def save_blobs(root, seed=7, in_dim=6, out_dim=3, with_mean=False):
    """The same program saved twice: by the JAX package from its startup
    scope, and by the port with that scope's weights carried across.
    Returns (port blob dir, JAX blob dir)."""
    main, startup, fetches = _net(js, jun, seed, in_dim, out_dim,
                                  with_mean)
    jscope = js.Scope()
    with js.scope_guard(jscope):
        exe = js.Executor()
        exe.run(startup)
        jdir = os.path.join(root, "jax_blob")
        js.save_inference_model(jdir, ["x"], fetches, exe, main)
    state = {k: np.asarray(v) for k, v in jscope.items() if v is not None}
    tmain, _, tfetches = _net(ts, tun, seed, in_dim, out_dim, with_mean)
    tscope = ts.Scope()
    ts.load_numpy_state(tscope, state, CPU)
    with ts.scope_guard(tscope):
        tdir = os.path.join(root, "blob")
        ts.save_inference_model(tdir, ["x"], tfetches, ts.Executor(CPU),
                                tmain)
    return tdir, jdir


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    return save_blobs(str(tmp_path_factory.mktemp("serving")))


@pytest.fixture()
def blob(blobs):
    return blobs[0]


@pytest.fixture()
def predictor(blob):
    p = AnalysisPredictor(blob, batch_buckets=(1, 2, 4), device="cpu")
    p.warm()
    return p


def _feed(rows, in_dim=6, seed=0):
    return {"x": np.random.RandomState(seed).randn(
        rows, in_dim).astype(np.float32)}


# ---------------------------------------------------------------------------
# AnalysisPredictor: against JAX's, buckets, padding, the row-by-row leg
# ---------------------------------------------------------------------------
def test_predictor_matches_the_jax_analysis_predictor(blobs):
    tdir, jdir = blobs
    ours = AnalysisPredictor(tdir, batch_buckets=(1, 2, 4), device="cpu")
    theirs = JaxPredictor(jdir, batch_buckets=(1, 2, 4))
    from_jax_blob = AnalysisPredictor(jdir, batch_buckets=(1, 2, 4),
                                      device="cpu")
    assert (ours.feed_names, ours.batch_buckets) == \
        (theirs.feed_names, theirs.batch_buckets)
    for rows in (1, 3, 4):
        f = _feed(rows, seed=rows)
        want = theirs.run_batch(f)[0]
        got = ours.run_batch(f)[0]
        assert got.shape == want.shape == (rows, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(from_jax_blob.run_batch(f)[0], want,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(ours.run_eager(f)[0],
                                   theirs.run_eager(f)[0], rtol=0,
                                   atol=1e-5)


def test_predictor_bucket_ladder_and_padding_parity(predictor):
    assert predictor.bucket_for(1) == 1
    assert predictor.bucket_for(2) == 2
    assert predictor.bucket_for(3) == 4
    with pytest.raises(ValueError, match="largest bucket"):
        predictor.bucket_for(5)
    f3 = _feed(3)
    out3 = predictor.run_batch(f3)[0]
    assert out3.shape[0] == 3
    f4 = _feed(4)
    out4 = predictor.run_batch(f4)[0]
    np.testing.assert_allclose(
        out3, predictor.run_batch(f3)[0], rtol=0, atol=0)
    # rows shared between batches of other sizes agree (the model is
    # row-independent; padding must keep it so)
    np.testing.assert_allclose(predictor.run_batch({"x": f4["x"][:3]})[0],
                               out4[:3], atol=1e-6)


def test_predictor_eager_fallback_matches_batched(predictor):
    f = _feed(2, seed=3)
    np.testing.assert_allclose(predictor.run_eager(f)[0],
                               predictor.run_batch(f)[0], atol=1e-5)


def test_predictor_warm_runs_every_bucket(blob):
    p = AnalysisPredictor(blob, batch_buckets=(1, 2, 4), device="cpu")
    assert p.warm() == 3 and p._warmed
    assert p.counters["executor_steps"] == 3
    for rows in (1, 2, 3, 4):
        p.run_batch(_feed(rows))
    assert p.counters["executor_steps"] == 7     # one run a batch
    assert not any(k.startswith("compile_cache") for k in p.counters)
    assert p.memory_stats() == {}                # the CPU has no stats


def test_predictor_verifies_manifest(tmp_path):
    d, _ = save_blobs(str(tmp_path))
    with open(os.path.join(d, "params.pdparams"), "r+b") as f:
        f.truncate(8)
    with pytest.raises(ValueError, match="params.pdparams"):
        AnalysisPredictor(d, device="cpu")


def test_static_load_inference_model_verifies_manifest(tmp_path):
    d, _ = save_blobs(str(tmp_path))
    exe = ts.Executor(CPU)
    ts.load_inference_model(d, exe)       # intact: loads
    with open(os.path.join(d, "__model__"), "ab") as f:
        f.write(b"garbage")
    with pytest.raises(ValueError, match="__model__"):
        ts.load_inference_model(d, exe)


def test_predictor_refuses_a_bad_ladder_and_runs_on_the_card_by_default(
        blob):
    with pytest.raises(ValueError, match="batch_buckets"):
        AnalysisPredictor(blob, batch_buckets=(0, 2), device="cpu")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AnalysisPredictor(blob)


# ---------------------------------------------------------------------------
# continuous batching (sync drive: deterministic, no threads)
# ---------------------------------------------------------------------------
def test_engine_packs_compatible_requests_into_one_batch(predictor):
    eng = ServingEngine(predictor)
    before = dict(predictor.counters)
    h1 = eng.submit(_feed(2, seed=1))
    h2 = eng.submit(_feed(1, seed=2))
    h3 = eng.submit(_feed(1, seed=3))
    assert eng.run_once() == 3          # 2+1+1 rows = one bucket-4 batch
    assert predictor.counters["executor_steps"] - \
        before.get("executor_steps", 0) == 1
    for h, seed, rows in ((h1, 1, 2), (h2, 2, 1), (h3, 3, 1)):
        got = h.result(0)[0]
        assert got.shape[0] == rows
        np.testing.assert_allclose(
            got, predictor.run_batch(_feed(rows, seed=seed))[0],
            atol=1e-6)
    assert eng.counters["serve_requests"] == 3
    assert eng.counters["serve_batches"] == 1
    assert eng.counters["serve_batch_fill_pct"] == 100.0
    assert eng.counters["serve_queue_depth"] == 0
    stats = eng.engine_latency_stats()
    assert stats["n"] == 3 and eng.latency_stats()["n"] == 3


def test_engine_overflow_rides_next_tick(predictor):
    eng = ServingEngine(predictor)
    handles = [eng.submit(_feed(2, seed=i)) for i in range(3)]
    assert eng.run_once() == 2          # 2+2 fills bucket 4; third waits
    assert not handles[2].done()
    assert eng.run_once() == 1
    assert handles[2].result(0)[0].shape[0] == 2
    assert eng.counters["serve_batches"] == 2


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_queue_bound_sheds_with_typed_overloaded(predictor):
    eng = ServingEngine(predictor, max_queue=2)
    eng.submit(_feed(1))
    eng.submit(_feed(1))
    before = eng.counters.get("serve_shed", 0)
    with pytest.raises(Overloaded, match="queue full"):
        eng.submit(_feed(1))
    assert eng.counters["serve_shed"] == before + 1
    eng.run_once()
    assert eng.counters["serve_requests"] == 2


def test_token_bucket_rate_limit_with_injectable_clock(predictor):
    t = [0.0]
    eng = ServingEngine(predictor, rate_limit=2.0, burst=2,
                        clock=lambda: t[0])
    eng.submit(_feed(1, seed=1))
    eng.submit(_feed(1, seed=2))
    with pytest.raises(Overloaded, match="rate limit"):
        eng.submit(_feed(1, seed=3))
    t[0] = 0.5                           # one token refilled (2/s)
    eng.submit(_feed(1, seed=4))
    with pytest.raises(Overloaded):
        eng.submit(_feed(1, seed=5))
    assert eng.counters["serve_shed"] == 2


def test_oversized_and_malformed_requests_rejected_at_submit(predictor):
    eng = ServingEngine(predictor)
    with pytest.raises(ValueError, match="largest batch"):
        eng.submit(_feed(9))
    with pytest.raises(ValueError, match="feed names"):
        eng.submit({"y": np.zeros((1, 6), np.float32)})
    with pytest.raises(ValueError, match="zero rows"):
        eng.submit({"x": np.zeros((0, 6), np.float32)})


def test_zero_rate_limit_is_an_error_not_disabled(predictor):
    with pytest.raises(ValueError, match="rate_limit"):
        ServingEngine(predictor, rate_limit=0)
    with pytest.raises(ValueError, match="burst"):
        ServingEngine(predictor, rate_limit=10, burst=0)


def test_sub_one_rate_limit_still_serves(predictor):
    t = [0.0]
    eng = ServingEngine(predictor, rate_limit=0.5, clock=lambda: t[0])
    eng.submit(_feed(1, seed=1))
    with pytest.raises(Overloaded, match="rate limit"):
        eng.submit(_feed(1, seed=2))
    t[0] = 2.0                           # one token refilled (0.5/s)
    eng.submit(_feed(1, seed=3))
    assert eng.run_once() == 2


# ---------------------------------------------------------------------------
# deadlines (injectable clock — zero sleeps)
# ---------------------------------------------------------------------------
def test_unmakeable_deadline_expires_at_admission(predictor):
    eng = ServingEngine(predictor, min_service_s=0.010,
                        clock=lambda: 0.0)
    before = eng.counters.get("serve_deadline_expired", 0)
    with pytest.raises(DeadlineExceeded, match="cannot be met"):
        eng.submit(_feed(1), deadline_s=0.005)
    assert eng.counters["serve_deadline_expired"] == before + 1


def test_queued_request_dropped_the_moment_deadline_passes(predictor):
    t = [0.0]
    eng = ServingEngine(predictor, clock=lambda: t[0])
    h_live = eng.submit(_feed(1, seed=1), deadline_s=100.0)
    h_dead = eng.submit(_feed(1, seed=2), deadline_s=1.0)
    t[0] = 2.0                           # past h_dead's deadline only
    assert eng.run_once() == 1
    with pytest.raises(DeadlineExceeded, match="deadline passed"):
        h_dead.result(0)
    assert h_live.result(0)[0].shape[0] == 1
    assert eng.counters["serve_deadline_expired"] == 1


def test_default_deadline_applies(predictor):
    t = [0.0]
    eng = ServingEngine(predictor, default_deadline_s=1.0,
                        clock=lambda: t[0])
    h = eng.submit(_feed(1))
    t[0] = 5.0
    eng.run_once()
    with pytest.raises(DeadlineExceeded):
        h.result(0)


# ---------------------------------------------------------------------------
# chaos: injected dispatch failure -> retry -> degraded row-by-row leg ->
# typed failure on an exhausted budget
# ---------------------------------------------------------------------------
def test_chaos_dispatch_fault_retry_then_degraded_fallback(
        predictor, monkeypatch):
    monkeypatch.setenv("PADDLE_FAULT_SPEC", "serve.dispatch:2")
    fault.load_env_spec()
    eng = ServingEngine(predictor, retry_attempts=2,
                        sleep=lambda d: None)
    base = {k: _counter(k) for k in ("retry_attempts", "faults_injected")}
    h = eng.submit(_feed(2, seed=5))
    assert eng.run_once() == 1
    got = h.result(0)[0]
    np.testing.assert_allclose(
        got, predictor.run_eager(_feed(2, seed=5))[0], atol=1e-6)
    assert eng.counters["serve_degraded"] == 1
    assert eng.counters.get("serve_failed", 0) == 0
    assert _counter("retry_attempts") - base["retry_attempts"] == 1
    assert _counter("faults_injected") - base["faults_injected"] == 2
    assert eng.counters["faults_injected"] == _counter("faults_injected")
    # faults consumed: the next request rides the batched path clean
    h2 = eng.submit(_feed(2, seed=6))
    eng.run_once()
    assert h2.error() is None
    assert eng.counters["serve_degraded"] == 1


def test_degraded_fallback_handles_scalar_fetch(tmp_path, monkeypatch):
    d, _ = save_blobs(str(tmp_path), seed=11, with_mean=True)
    p = AnalysisPredictor(d, batch_buckets=(1, 2), device="cpu")
    p.warm()
    monkeypatch.setenv("PADDLE_FAULT_SPEC", "serve.dispatch:2")
    fault.load_env_spec()
    eng = ServingEngine(p, retry_attempts=2, sleep=lambda d: None)
    h = eng.submit(_feed(2, seed=3))
    assert eng.run_once() == 1
    vals = h.result(0)
    assert vals[0].shape == (2, 4)
    assert np.asarray(vals[1]).ndim == 0         # delivered unsliced
    assert eng.counters["serve_degraded"] == 1
    assert eng.counters.get("serve_failed", 0) == 0


def test_chaos_exhausted_budget_fails_typed(predictor, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv("PADDLE_FAULT_SPEC",
                       "serve.dispatch:2,serve.fallback:1")
    monkeypatch.setenv("PADDLE_FLIGHTREC_DIR", str(tmp_path))
    fault.load_env_spec()
    eng = ServingEngine(predictor, retry_attempts=2,
                        sleep=lambda d: None)
    h = eng.submit(_feed(1, seed=9))
    eng.run_once()
    with pytest.raises(RequestFailed, match="fallback failed too"):
        h.result(0)
    assert eng.counters["serve_failed"] == 1
    assert any(f.startswith("flightrec_") for f in os.listdir(tmp_path))


def test_chaos_mixed_batch_partial_failure(predictor):
    fault.arm("serve.dispatch", times=2)
    fault.arm("serve.fallback", times=1)
    eng = ServingEngine(predictor, retry_attempts=2,
                        sleep=lambda d: None)
    h1 = eng.submit(_feed(1, seed=1))
    h2 = eng.submit(_feed(1, seed=2))
    eng.run_once()
    assert isinstance(h1.error(), RequestFailed)
    assert h2.error() is None and h2.result(0)[0].shape[0] == 1
    assert eng.counters["serve_failed"] == 1
    assert eng.counters["serve_degraded"] == 1


def test_respond_fault_fails_only_that_request(predictor):
    fault.arm("serve.respond", times=1)
    eng = ServingEngine(predictor)
    h1 = eng.submit(_feed(1, seed=1))
    h2 = eng.submit(_feed(1, seed=2))
    eng.run_once()
    assert isinstance(h1.error(), fault.InjectedFault)
    assert h2.error() is None


def test_assemble_fault_is_transient_not_fatal(predictor):
    fault.arm("serve.assemble", times=1)
    eng = ServingEngine(predictor)
    h = eng.submit(_feed(1))
    assert eng.run_once() == 0           # faulted tick: queue intact
    assert eng.queue_depth == 1
    assert eng.run_once() == 1
    assert h.error() is None


# ---------------------------------------------------------------------------
# drain / stop
# ---------------------------------------------------------------------------
def test_drain_flushes_queue_then_refuses_admission(predictor):
    eng = ServingEngine(predictor)
    handles = [eng.submit(_feed(1, seed=i)) for i in range(5)]
    assert eng.drain() is True
    assert all(h.done() and h.error() is None for h in handles)
    with pytest.raises(EngineStopped):
        eng.submit(_feed(1))


def test_stop_keeps_queue_and_start_resumes(predictor):
    """stop() is not a flush (queued requests stay queued) and a later
    start() reopens admission and serves the backlog — with exactly one
    scheduler thread."""
    eng = ServingEngine(predictor)
    handles = [eng.submit(_feed(1, seed=i)) for i in range(3)]
    eng.start()
    eng.stop()
    with pytest.raises(EngineStopped):
        eng.submit(_feed(1, seed=7))
    eng.start()
    for h in handles:
        assert h.result(timeout=30)[0].shape[0] == 1
    assert eng.submit(_feed(1, seed=8)).result(timeout=30)
    assert sum(1 for t in threading.enumerate()
               if t.name == "serving-scheduler") == 1
    assert eng.drain(timeout=30) is True


def test_sigterm_drains_and_exits_zero(tmp_path):
    """SIGTERM -> stop admitting -> flush in-flight -> exit 0, zero
    admitted requests lost (subprocess: the worker signals itself)."""
    env = dict(os.environ)
    env.update({"PYTHONPATH": _REPO, "DRAIN_REQUESTS": "12",
                "PADDLE_FLIGHTREC_DIR": str(tmp_path)})
    out = subprocess.run([sys.executable, _DRAIN_WORKER], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, (out.stdout, out.stderr[-2000:])
    assert "DRAINED done=12 ok=12 total=12" in out.stdout, out.stdout
    assert any(f.startswith("flightrec_") for f in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# KV/health server hardening
# ---------------------------------------------------------------------------
def test_kv_server_rejects_oversized_body():
    srv = KVServer(0, max_body_bytes=64)
    srv.start()
    try:
        port = srv.http_server.server_address[1]
        c = KVClient(f"127.0.0.1:{port}")
        c.put("ok/key", b"x" * 32)
        assert c.get("ok/key") == b"x" * 32
        before = _counter("kv_rejected_oversize")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("PUT", "/big", body=b"y" * 128)
        assert conn.getresponse().status == 413
        conn.close()
        assert _counter("kv_rejected_oversize") == before + 1
        assert c.get("ok/key") == b"x" * 32      # still serving
    finally:
        srv.stop()


def test_kv_server_rejects_negative_and_missing_content_length():
    srv = KVServer(0, max_body_bytes=64)
    srv.start()
    try:
        port = srv.http_server.server_address[1]
        for length, status in (("-1", 400), (None, 411)):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=5)
            conn.putrequest("PUT", "/neg")
            if length is not None:
                conn.putheader("Content-Length", length)
            conn.endheaders()
            assert conn.getresponse().status == status
            conn.close()
    finally:
        srv.stop()


def test_kv_server_times_out_stalled_connection():
    srv = KVServer(0, request_timeout=0.2)
    srv.start()
    try:
        port = srv.http_server.server_address[1]
        before = _counter("kv_conn_timeouts")
        sk = socket.create_connection(("127.0.0.1", port), timeout=5)
        # half a PUT: headers promise 10 body bytes, send 2, stall
        sk.sendall(b"PUT /stall HTTP/1.1\r\nContent-Length: 10\r\n\r\nab")
        deadline = time.monotonic() + 5
        sk.settimeout(0.5)
        closed = False
        while time.monotonic() < deadline:
            try:
                if sk.recv(256) == b"":
                    closed = True
                    break
            except socket.timeout:
                continue
        assert closed, "stalled connection was not closed"
        assert _counter("kv_conn_timeouts") == before + 1
        sk.close()
    finally:
        srv.stop()


def test_health_and_readiness_probes(predictor):
    eng = ServingEngine(predictor).start()
    hs = ServingHealthServer(eng).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", hs.port,
                                          timeout=5)
        conn.request("GET", "/healthz")
        assert conn.getresponse().read() == b"ok"
        conn.request("GET", "/readyz")
        assert conn.getresponse().status == 200
        conn.request("PUT", "/scope/k", body=b"v")
        assert conn.getresponse().status == 200
        conn.request("GET", "/scope/k")
        assert conn.getresponse().read() == b"v"
        assert eng.infer(_feed(2, seed=4), timeout=30)[0].shape == (2, 3)
        eng.drain(timeout=10)
        conn.request("GET", "/readyz")
        assert conn.getresponse().status == 503    # draining: not ready
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200    # ...but still alive
        conn.close()
    finally:
        hs.stop()
        eng.stop()


def test_health_server_stop_without_start_does_not_hang(predictor):
    eng = ServingEngine(predictor)
    ServingHealthServer(eng).stop()


def test_readyz_not_ready_before_warm_or_start(blob):
    p = AnalysisPredictor(blob, batch_buckets=(1, 2), device="cpu")
    eng = ServingEngine(p)
    assert eng.ready is False          # scheduler not running
    eng.start()
    try:
        assert eng.ready is False      # running but not warmed
        p.warm()
        assert eng.ready is True
        eng.stop()
        assert eng.ready is False      # stopped again
    finally:
        eng.stop()
