"""Cluster metrics federation: scrape N ``/metrics`` endpoints, merge
every family under an ``instance`` label, and re-serve the union on one
listener — the fleet-level scrape target the per-engine endpoints roll
up into.

A copy of ``paddle_tpu/observability/federation.py``. Degradation
contract: a dead endpoint is DATA, not a failure. The federator keeps
the target's last good samples, flips ``federation_target_up{instance}``
to 0 and publishes ``federation_scrape_age_s{instance}``; a scrape of
the federator itself never errors because a member died mid-scrape.
Stdlib + :mod:`.metrics`; the listener rides ``KVHTTPServer``.
"""
from __future__ import annotations

import http.client
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FederatedMetrics", "FederationServer", "scrape_text"]


def scrape_text(endpoint: str, timeout: float = 5.0) -> str:
    """One GET /metrics -> raw exposition text (raises OSError-family
    on a dead endpoint — the caller's staleness policy decides)."""
    host, _, port = endpoint.replace("http://", "").rpartition(":")
    conn = http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode("utf-8", "replace")
        if resp.status != 200:
            raise ConnectionError(f"GET /metrics on {endpoint} -> "
                                  f"HTTP {resp.status}")
        return body
    finally:
        conn.close()


def _inject_instance(sample_key: str, instance: str) -> str:
    """``name{a="b"}`` -> ``name{a="b",instance="..."}`` (and bare
    ``name`` -> ``name{instance="..."}``). A sample that ALREADY
    carries an instance label (a federated member that is itself a
    federator) keeps it — Prometheus honor_labels semantics; a second
    instance label would be a duplicate label name, which scrapers
    reject outright."""
    if 'instance="' in sample_key:
        return sample_key
    esc = instance.replace("\\", "\\\\").replace('"', '\\"')
    if sample_key.endswith("}"):
        return f'{sample_key[:-1]},instance="{esc}"}}'
    return f'{sample_key}{{instance="{esc}"}}'


def _parse_exposition(text: str) -> Tuple[Dict[str, float],
                                          Dict[str, Tuple[str, str]]]:
    """(samples, family meta): sample lines exactly as
    ``parse_prometheus_text`` sees them, plus ``# TYPE``/``# HELP``
    headers keyed by family name so the merged re-render keeps them."""
    from .metrics import parse_prometheus_text

    meta: Dict[str, Tuple[str, str]] = {}
    help_lines: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                meta[parts[2]] = (parts[3], help_lines.get(parts[2], ""))
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                help_lines[parts[2]] = parts[3] if len(parts) > 3 else ""
    return parse_prometheus_text(text), meta


class _Target:
    __slots__ = ("endpoint", "samples", "meta", "last_ok", "up",
                 "failures")

    def __init__(self, endpoint: str):
        self.endpoint = endpoint
        self.samples: Dict[str, float] = {}
        self.meta: Dict[str, Tuple[str, str]] = {}
        self.last_ok: Optional[float] = None
        self.up = False
        self.failures = 0


class FederatedMetrics:
    """Scrape-and-merge core (the server below and tools drive it).

    ``targets``: "host:port" endpoints. ``scrape_once()`` polls every
    target (dead ones keep their last good samples and flip the
    staleness gauges); ``render()`` emits the merged exposition —
    every member sample re-labeled with ``instance``, family TYPE/HELP
    headers taken from the first member that declares them, plus the
    federator's own meta-family (up/age per instance).

    ``clock`` and ``fetch`` are injectable (CI: fake time, canned
    scrapes). The merged output round-trips through
    ``parse_prometheus_text``, so ``slo.py`` evaluates objectives
    against a federated scrape exactly like a direct one."""

    def __init__(self, targets: Sequence[str], clock=time.time,
                 fetch=None, timeout: float = 5.0):
        if not targets:
            raise ValueError("federation needs at least one target "
                             "endpoint")
        self._targets = [_Target(str(t)) for t in targets]
        self._clock = clock
        self._fetch = fetch or scrape_text   # None = real HTTP scrape
        self._timeout = float(timeout)
        self._lock = threading.Lock()

    @property
    def targets(self) -> List[str]:
        return [t.endpoint for t in self._targets]

    def scrape_once(self) -> Dict[str, bool]:
        """Poll every target once — CONCURRENTLY, so one dark member
        costs one timeout for the whole cycle, not a serialized
        timeout per corpse that inflates every healthy member's
        scrape age. Returns {endpoint: up}; never raises for a dead
        member — staleness is recorded instead."""
        from .catalog import LABELED_GAUGES
        from .metrics import default_registry

        reg = default_registry()
        # declarations come FROM the catalog: help/labels literals must
        # not fork between here and slo.py (a label mismatch is a
        # runtime ValueError in whichever runs second)
        up_g = reg.gauge("federation_target_up",
                         help=LABELED_GAUGES["federation_target_up"][0],
                         labels=LABELED_GAUGES["federation_target_up"][1])
        age_g = reg.gauge(
            "federation_scrape_age_s",
            help=LABELED_GAUGES["federation_scrape_age_s"][0],
            labels=LABELED_GAUGES["federation_scrape_age_s"][1])

        def one(t: _Target) -> None:
            try:
                text = self._fetch(t.endpoint, timeout=self._timeout)
                samples, meta = _parse_exposition(text)
            except (OSError, http.client.HTTPException, ValueError):
                reg.inc_scalar("federation_scrape_failures")
                with self._lock:
                    t.up = False
                    t.failures += 1
            else:
                reg.inc_scalar("federation_scrapes")
                with self._lock:
                    t.samples, t.meta = samples, meta
                    t.last_ok = self._clock()
                    t.up = True

        if len(self._targets) == 1:
            one(self._targets[0])
        else:
            threads = [threading.Thread(target=one, args=(t,),
                                        daemon=True,
                                        name=f"fed-scrape-{i}")
                       for i, t in enumerate(self._targets)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        results: Dict[str, bool] = {}
        for t in self._targets:
            up_g.set(1 if t.up else 0, instance=t.endpoint)
            age_g.set(round(self._clock() - t.last_ok, 3)
                      if t.last_ok is not None else -1,
                      instance=t.endpoint)
            results[t.endpoint] = t.up
        return results

    def staleness(self) -> Dict[str, Optional[float]]:
        """{endpoint: seconds since last good scrape} (None = never)."""
        now = self._clock()
        with self._lock:
            return {t.endpoint: (None if t.last_ok is None
                                 else round(now - t.last_ok, 3))
                    for t in self._targets}

    def merged_samples(self) -> Dict[str, float]:
        """The union view as ``parse_prometheus_text`` keys — every
        member sample with its ``instance`` label injected."""
        out: Dict[str, float] = {}
        with self._lock:
            for t in self._targets:
                for key, v in t.samples.items():
                    out[_inject_instance(key, t.endpoint)] = v
        return out

    def render(self) -> str:
        """Merged Prometheus text exposition, GROUPED BY FAMILY: each
        family's HELP/TYPE header immediately precedes ALL of its
        instance-labeled samples (the text format requires one
        contiguous group per metric — interleaving members' copies of
        a family is invalid exposition, like a duplicate TYPE line),
        then the federator's own up/age families."""
        from .metrics import _fmt_value

        lines: List[str] = []
        with self._lock:
            families: Dict[str, Tuple[str, str]] = {}
            for t in self._targets:
                for fam, (kind, help_) in t.meta.items():
                    if fam in ("federation_target_up",
                               "federation_scrape_age_s"):
                        # members declare these via the catalog too;
                        # the headers are appended once below — a
                        # duplicate TYPE line is invalid exposition
                        continue
                    families.setdefault(fam, (kind, help_))
            # group every member sample under its family: histogram
            # samples (fam_bucket/_sum/_count) fold back onto fam so
            # the whole family is one contiguous block
            groups: Dict[str, Dict[str, float]] = {}
            for t in self._targets:
                for key, v in t.samples.items():
                    base = key.split("{", 1)[0]
                    fam = base
                    for suffix in ("_bucket", "_sum", "_count"):
                        if base.endswith(suffix) and \
                                base[:-len(suffix)] in families:
                            fam = base[:-len(suffix)]
                            break
                    groups.setdefault(fam, {})[
                        _inject_instance(key, t.endpoint)] = v
            # the federator's OWN gauges join the same grouped
            # emission: a member that is itself a federator exposes
            # these families too, and they must land in ONE group
            now = self._clock()
            families["federation_target_up"] = ("gauge", "")
            families["federation_scrape_age_s"] = ("gauge", "")
            for t in self._targets:
                groups.setdefault("federation_target_up", {})[
                    _inject_instance("federation_target_up",
                                     t.endpoint)] = 1 if t.up else 0
                age = (round(now - t.last_ok, 3)
                       if t.last_ok is not None else -1)
                groups.setdefault("federation_scrape_age_s", {})[
                    _inject_instance("federation_scrape_age_s",
                                     t.endpoint)] = age
            for fam in sorted(groups):
                meta = families.get(fam)
                if meta is not None:
                    kind, help_ = meta
                    if help_:
                        lines.append(f"# HELP {fam} {help_}")
                    lines.append(f"# TYPE {fam} {kind}")
                samples = groups[fam]
                for key in sorted(samples):
                    lines.append(f"{key} {_fmt_value(samples[key])}")
        return "\n".join(lines) + "\n"


class FederationServer:
    """One listener re-serving the merged union: GET ``/metrics`` is
    the federated exposition (a background loop keeps scraping members
    every ``interval_s``; a member death mid-scrape degrades to
    staleness, never to a 5xx)."""

    def __init__(self, targets: Sequence[str], port: int = 0,
                 host: str = "127.0.0.1", interval_s: float = 5.0,
                 clock=time.time, fetch=None):
        from ..distributed.http_kv import KVHandler, KVHTTPServer

        self.federation = FederatedMetrics(targets, clock=clock,
                                           fetch=fetch)
        fed = self.federation

        class _Handler(KVHandler):
            def do_GET(handler):  # noqa: N805 (handler-local self)
                if handler.path == "/metrics":
                    from .metrics import CONTENT_TYPE

                    body = fed.render().encode("utf-8")
                    handler.send_response(200)
                    handler.send_header("Content-Type", CONTENT_TYPE)
                    handler.send_header("Content-Length", str(len(body)))
                    handler.end_headers()
                    handler.wfile.write(body)
                    return
                KVHandler.do_GET(handler)

        self._server = KVHTTPServer(port, _Handler, host=host,
                                    max_body_bytes=1 << 20,
                                    request_timeout=10.0)
        self._interval = float(interval_s)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "FederationServer":
        self.federation.scrape_once()   # serve data from the first GET
        t1 = threading.Thread(target=self._scrape_loop, daemon=True,
                              name="metrics-federation")
        t2 = threading.Thread(target=self._server.serve_forever,
                              daemon=True, name="federation-http")
        self._threads = [t1, t2]
        t1.start()
        t2.start()
        return self

    def _scrape_loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.federation.scrape_once()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)
        self._server.server_close()
        self._threads = []
