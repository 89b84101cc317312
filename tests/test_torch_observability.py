"""The port's host observability and fault planes (paddle_tpu_torch.
observability, .fault, .distributed.http_kv) against the JAX package:
the Prometheus exposition byte for byte for the same series, its parser,
SLO burn rates and verdicts, the federated exposition, the fault-spec
parser's triggers, trace headers both ways, the flight recorder's dump,
and the http_kv listener's /metrics and traced requests. All stdlib on
both sides: nothing here touches a device."""
import json
import os
import socket

import pytest

from paddle_tpu.fault import injector as jinjector
from paddle_tpu.observability import federation as jfed
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed.http_kv import KVClient, KVServer
from paddle_tpu_torch.fault import injector as tinjector
from paddle_tpu_torch.fault.retry import (Backoff, Retrier, env_backoff,
                                          env_max_attempts, retry)
from paddle_tpu_torch.observability import federation as tfed
from paddle_tpu_torch.observability.flight_recorder import FlightRecorder
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import server as tserver
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import tracing as ttracing


def _fill(m):
    """The same declared and auto-created series on a fresh registry of
    module ``m`` (either package's metrics)."""
    reg = m.MetricsRegistry(max_label_sets=3)
    c = reg.counter("decode_requests", help="requests admitted")
    c.inc(7)
    g = reg.gauge("kv_pages_in_use", help="pages\nresident")
    g.set(12.5)
    lc = reg.counter("ps_rpcs", help='rpcs "by" op', labels=("op",))
    for op, n in (("pull", 3), ("push", 1), ("b\\a\"d", 2)):
        lc.inc(n, op=op)
    lc.inc(4, op="overflowing")            # past max_label_sets
    lg = reg.gauge("slo_burning", labels=("objective",))
    lg.set(1, objective="e2e")
    lg.set(0, objective="errors")
    h = reg.histogram("decode_e2e_ms", help="e2e")
    for v in (0.05, 3.0, 3.0, 47.0, 900.0, 20000.0):
        h.observe(v)
    reg.histogram("serve_e2e_ms")          # declared, never observed
    lh = reg.histogram("decode_tick_phase_ms", labels=("phase",),
                       buckets=(1.0, 2.5, 10.0))
    lh.observe(0.5, phase="fetch")
    lh.observe(7.0, phase="host")
    lh.observe(70.0, phase="host")
    reg.inc_scalar("retry_attempts", 2)    # auto-created counter
    reg.set_scalar("weird name-1", 0.25)   # auto-created gauge
    return reg


def test_render_prometheus_is_byte_equal_to_jax():
    ours, theirs = _fill(tmetrics), _fill(jmetrics)
    text = ours.render_prometheus()
    assert text == theirs.render_prometheus()
    assert tmetrics.render_prometheus(ours) == text
    assert tmetrics.CONTENT_TYPE == jmetrics.CONTENT_TYPE
    assert ours.flat_snapshot() == theirs.flat_snapshot()
    assert ours.flat_snapshot()["metrics_label_overflow"] == 1
    assert '{op="__overflow__"} 4' in text


def test_parse_prometheus_text_round_trip():
    text = _fill(tmetrics).render_prometheus()
    got = tmetrics.parse_prometheus_text(text)
    assert got == jmetrics.parse_prometheus_text(text)
    assert got['decode_e2e_ms_bucket{le="+Inf"}'] == 6
    assert got["kv_pages_in_use"] == 12.5
    assert got['decode_tick_phase_ms_count{phase="host"}'] == 2
    # interleaved junk and comments are skipped, not fatal
    assert tmetrics.parse_prometheus_text(
        "# HELP x y\nnot a sample\nx 1\n") == {"x": 1.0}


def test_registry_semantics_match_jax():
    for m in (tmetrics, jmetrics):
        reg = m.MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("bad name")
        c = reg.counter("c", labels=("a",))
        with pytest.raises(ValueError):
            reg.gauge("c")                      # another kind
        with pytest.raises(ValueError):
            c.inc(-1, a="x")
        c.inc(2, a="x")
        assert reg.get("c") is c and c.value(a="x") == 2
        before = reg.flat_snapshot()
        reg.inc_scalar("n", 3)
        assert reg.flat_delta(before) == {"n": 3}
        reg.reset_values()
        assert c.value(a="x") == 0 and reg.flat_snapshot() == {}
    assert tmetrics.percentile_from_buckets(
        [(1.0, 2), (10.0, 4), (float("inf"), 4)], 75) == \
        jmetrics.percentile_from_buckets(
            [(1.0, 2), (10.0, 4), (float("inf"), 4)], 75)


def _scrapes():
    """Three cumulative scrapes (t = 0, 100, 400 s) of two families."""
    out = []
    for t, good, slow, req, failed in ((0.0, 10, 0, 10, 0),
                                       (100.0, 40, 5, 60, 2),
                                       (400.0, 50, 45, 160, 30)):
        text = "".join(
            f'decode_e2e_ms_bucket{{le="{le}"}} {n}\n'
            for le, n in (("10", good), ("100", good + slow // 2),
                          ("1000", good + slow), ("+Inf", good + slow)))
        text += f"decode_requests {req}\ndecode_failed {failed}\n"
        out.append((t, jmetrics.parse_prometheus_text(text)))
    return out


@pytest.mark.parametrize("windows", [((300.0, 14.4), (3600.0, 6.0)),
                                     ((50.0, 1.0), (200.0, 0.5))])
def test_slo_burn_rates_equal_jax(windows):
    objs = {}
    for name, m in (("port", tslo), ("jax", jslo)):
        objs[name] = [
            m.Objective("lat", hist="decode_e2e_ms", percentile=90,
                        threshold_ms=50.0),
            m.Objective("err", numerator="decode_failed",
                        denominator="decode_requests", max_ratio=0.05)]
    ev = {"port": tslo.SLOEvaluator(objs["port"], windows=windows,
                                    publish=False),
          "jax": jslo.SLOEvaluator(objs["jax"], windows=windows,
                                   publish=False)}
    for t, samples in _scrapes():
        for e in ev.values():
            e.add_snapshot(samples, t=t)
        got = [v.to_dict() for v in ev["port"].evaluate()]
        assert got == [v.to_dict() for v in ev["jax"].evaluate()]
    assert ev["port"].burning() == ev["jax"].burning()
    samples = _scrapes()[-1][1]
    assert tslo.extract_histogram(samples, "decode_e2e_ms") == \
        jslo.extract_histogram(samples, "decode_e2e_ms")
    assert tslo.counter_value(samples, "decode_failed") == 30


def test_slo_objectives_and_publishing_match_jax():
    rows = json.dumps([{"name": "a", "hist": "x_ms", "percentile": 95,
                        "threshold_ms": 10},
                       {"name": "b", "numerator": "f", "denominator": "r",
                        "max_ratio": 0.1}])
    for m in (tslo, jslo):
        parsed = m.objectives_from_json(rows)
        assert [(o.name, o.kind, o.budget) for o in parsed] == \
            [("a", "latency", pytest.approx(0.05)), ("b", "error_rate", 0.1)]
        with pytest.raises(ValueError):
            m.Objective("c", hist="x")          # no threshold
        with pytest.raises(ValueError):
            m.SLOEvaluator([])
    assert [o.name for o in tslo.default_objectives()] == \
        [o.name for o in jslo.default_objectives()]
    ev = tslo.SLOEvaluator([tslo.Objective(
        "port_burn_probe", numerator="decode_failed",
        denominator="decode_requests", max_ratio=0.05)],
        windows=((10.0, 1.0),))
    before = profiler.counters_snapshot().get("slo_breaches", 0)
    for t, samples in _scrapes():
        ev.add_snapshot(samples, t=t)
    assert ev.evaluate()[0].burning
    reg = tmetrics.default_registry()
    assert reg.get("slo_burning").value(objective="port_burn_probe") == 1
    assert profiler.counters_snapshot()["slo_breaches"] == before + 1


def _member_text(i):
    reg = _fill(tmetrics)
    reg.counter("decode_failed").inc(i)
    return reg.render_prometheus()


def test_federated_render_equals_jax():
    texts = {"a:1": _member_text(1), "b:2": _member_text(4),
             "dead:3": None}

    def fetch(target, timeout=None):
        if texts[target] is None:
            raise ConnectionError("member is dark")
        return texts[target]

    clock = [100.0]
    fed = {"port": tfed.FederatedMetrics(list(texts), clock=lambda:
                                         clock[0], fetch=fetch),
           "jax": jfed.FederatedMetrics(list(texts), clock=lambda:
                                        clock[0], fetch=fetch)}
    ups = {k: f.scrape_once() for k, f in fed.items()}
    assert ups["port"] == ups["jax"] == {"a:1": True, "b:2": True,
                                         "dead:3": False}
    clock[0] = 103.5
    text = fed["port"].render()
    assert text == fed["jax"].render()
    assert fed["port"].merged_samples() == fed["jax"].merged_samples()
    assert fed["port"].staleness() == {"a:1": 3.5, "b:2": 3.5,
                                       "dead:3": None}
    assert 'federation_target_up{instance="dead:3"} 0' in text
    # the merged exposition parses back and the SLO plane reads one member
    samples = tmetrics.parse_prometheus_text(text)
    assert tslo.counter_value(samples, "decode_failed",
                              instance="b:2") == 4


def test_federation_server_serves_the_union():
    member = KVServer(0)
    member.start()
    try:
        port = member.http_server.server_address[1]
        tmetrics.default_registry().counter("fed_probe_total").inc(3)
        srv = tfed.FederationServer([f"127.0.0.1:{port}"], interval_s=60)
        srv.start()
        try:
            text = tfed.scrape_text(f"127.0.0.1:{srv.port}")
        finally:
            srv.stop()
    finally:
        member.stop()
    assert f'fed_probe_total{{instance="127.0.0.1:{port}"}} 3' in text
    assert f'federation_target_up{{instance="127.0.0.1:{port}"}} 1' in text


@pytest.mark.parametrize("spec", [
    "serve.dispatch:2",
    "ckpt.rename:2:OSError:injected, serve.*:1@3",
    "http_kv.request:1@2:TimeoutError",
])
def test_fault_spec_parser_gives_jax_triggers(spec):
    def triggers(inj):
        return {n: (t.times, t.exc_type.__name__, t.message, t.after)
                for n, t in inj._triggers.items()}

    ours = tinjector.FaultInjector(spec)
    assert triggers(ours) == triggers(jinjector.FaultInjector(spec))
    for bad in ("serve.dispatch", "p:x", "p:1:NotAnError"):
        with pytest.raises(ValueError):
            tinjector.FaultInjector(bad)


def test_fault_point_fires_counts_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_FLIGHTREC_DIR", str(tmp_path))
    inj = tinjector.FaultInjector()
    inj.arm("serve.*", times=2, after=1, exc=OSError)
    before = profiler.counters_snapshot().get("faults_injected", 0)
    inj.point("serve.dispatch")               # skipped (after=1)
    assert inj.armed("serve.dispatch") == 2
    for _ in range(2):
        with pytest.raises(OSError):
            inj.point("serve.dispatch")
    inj.point("serve.dispatch")               # spent
    assert profiler.counters_snapshot()["faults_injected"] == before + 2
    dump = json.load(open(tmp_path / f"flightrec_{os.getpid()}.json"))
    assert dump["reason"] == "fault_injected:serve.dispatch"
    assert dump["events"][-1]["kind"] == "fault_injected"
    assert "faults_injected" in dump["counters"]


def test_trace_headers_round_trip_both_ways():
    ctx = ttracing.SpanContext(0x1234abcd, 0x77)
    back = jtracing.SpanContext.from_headers(ctx.to_headers())
    assert (back.trace_id, back.span_id) == (0x1234abcd, 0x77)
    jctx = jtracing.SpanContext(0xfeed, 0xbeef)
    mine = ttracing.SpanContext.from_headers(jctx.to_headers())
    assert mine.to_wire() == jctx.to_wire()
    assert ttracing.SpanContext.from_headers({}) is None
    assert ttracing.SpanContext.from_headers(
        {"X-Paddle-Trace": "zz"}) is None
    assert ttracing.SpanContext.from_wire(0, 5) is None
    assert not ttracing.trace_enabled()


def test_spans_inflight_table_and_context_manager():
    clock = [0.0]
    root = ttracing.Span("router.request", root=True, clock=lambda:
                         clock[0])
    assert any(r["span"] == format(root.span_id, "016x")
               for r in ttracing.inflight_snapshot())
    with ttracing.span("child", parent=root) as sp:
        assert ttracing.current_context().span_id == sp.span_id
        assert sp.trace_id == root.trace_id
    assert sp.status == "ok"
    with pytest.raises(KeyError):
        with ttracing.Span("typed") as sp2:
            raise KeyError("x")
    assert sp2.status == "KeyError"
    clock[0] = 0.25
    root.end()
    assert root.duration_ms == 250.0
    assert all(r["span"] != format(root.span_id, "016x")
               for r in ttracing.inflight_snapshot())


def test_flight_recorder_ring_and_dump(tmp_path):
    fr = FlightRecorder(capacity=3, dir=str(tmp_path),
                            clock=lambda: 5.0)
    for i in range(5):
        fr.record("step", i=i)
    assert [e["i"] for e in fr.events()] == [2, 3, 4]
    path = fr.note_error(ValueError("boom"), where="test")
    dump = json.load(open(path))
    assert dump["reason"] == "typed_error:ValueError"
    assert dump["events"][-1]["error"] == "ValueError"
    assert len(dump["events"]) == 3


def test_retry_env_knobs_and_giveup(monkeypatch):
    monkeypatch.setenv("PADDLE_RETRY_MAX_ATTEMPTS", "5")
    monkeypatch.setenv("PADDLE_RETRY_BASE_DELAY_S", "0.5")
    assert env_max_attempts(4) == 5
    assert env_backoff(0.05, 1.0).base == 0.5
    r = Retrier(sleep=lambda d: None, name="probe",
                backoff=Backoff(jitter=0.0))
    assert r.max_attempts == 5
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("down")

    before = profiler.counters_snapshot()
    with pytest.raises(OSError):
        r.call(flaky)
    delta = profiler.counters_delta(before)
    assert len(calls) == 5
    assert delta["retry_attempts"] == 4 and delta["retry_giveups"] == 1
    assert retry(max_attempts=2)(lambda: 3)() == 3


def test_kv_server_metrics_route_and_traced_requests():
    import http.client

    srv = KVServer(0)
    srv.start()
    try:
        port = srv.http_server.server_address[1]
        c = KVClient(f"127.0.0.1:{port}")
        with ttracing.span("client.op"):
            c.put("scope/k", "v1")
        assert c.get("scope/k") == b"v1"
        assert c.get("scope/absent") is None
        c.delete("scope/k")
        assert srv.http_server.get_deleted_size("scope") == 1
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == tmetrics.CONTENT_TYPE
        samples = tmetrics.parse_prometheus_text(body)
        assert samples["kv_request_ms_count"] >= 4
        c.put("scope/ready", b"1")
        assert c.wait("scope/ready", timeout=5) == b"1"
        with pytest.raises(TimeoutError):
            c.wait("scope/absent2", timeout=0.05, poll=0.01)
    finally:
        srv.stop()


def test_metrics_server_is_env_gated(monkeypatch):
    monkeypatch.delenv("PADDLE_METRICS_PORT", raising=False)
    assert tserver.maybe_start_metrics_server() is None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("PADDLE_METRICS_PORT", str(port))
    try:
        srv = tserver.maybe_start_metrics_server()
        assert srv is not None and srv.port == port
        assert tserver.maybe_start_metrics_server() is srv   # idempotent
        tmetrics.default_registry().counter("env_server_probe").inc()
        text = tfed.scrape_text(f"127.0.0.1:{port}")
        assert "env_server_probe 1" in text
    finally:
        tserver.stop_metrics_server()
    monkeypatch.setenv("PADDLE_METRICS_PORT", "not-a-port")
    with pytest.warns(RuntimeWarning):
        assert tserver.maybe_start_metrics_server() is None
