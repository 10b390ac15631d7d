"""Serving fleet: the port's gateway and supervisor against the JAX
package's, case for case.

The stub-replica cases of ``tests/test_fleet.py`` — routing, the
breaker's eject and half-open recovery, retry, hedging, admission 429s,
drain, the metrics in both formats, trace and request-id propagation,
the supervisor's crash restart, backoff and drain — run once per
package with one set of expectations: the gateway in-process against
``http.server`` stub replicas, the supervisor over stub worker
processes. The gateway's own routes that the port answers without a
prober or controller (``/api/probes``, ``/api/rollout``,
``/api/autoscale``) answer as the JAX gateway's, and ``RTPU_PROBER=1``
is refused until the prober is ported. Every gateway, stub and worker a
test starts is stopped."""

import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from routest_tpu.core.config import FleetConfig as JFleetConfig
from routest_tpu.obs.trace import parse_traceparent as jparse
from routest_tpu.serve.fleet import gateway as jgw
from routest_tpu.serve.fleet import supervisor as jsup
from routest_tpu_torch.core.config import FleetConfig as TFleetConfig
from routest_tpu_torch.obs.trace import parse_traceparent as tparse
from routest_tpu_torch.serve.fleet import gateway as tgw
from routest_tpu_torch.serve.fleet import supervisor as tsup

PKGS = {
    "jax": types.SimpleNamespace(FleetConfig=JFleetConfig, gw=jgw,
                                 sup=jsup, parse_traceparent=jparse),
    "port": types.SimpleNamespace(FleetConfig=TFleetConfig, gw=tgw,
                                  sup=tsup, parse_traceparent=tparse),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (stub servers and the gateways' handler threads end when their
    sockets close)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 15.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


# ── stub replica ──────────────────────────────────────────────────────

class _StubHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def _send(self, code, payload, headers=()):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._send(200, {"ok": True, "port": self.server.server_port})

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        srv = self.server
        if srv.delay_s:
            time.sleep(srv.delay_s)
        with srv.counter_lock:
            srv.hits += 1
            srv.seen_headers.append({k.lower(): v
                                     for k, v in self.headers.items()})
        if srv.fail_with:
            self._send(srv.fail_with, {"error": "stub failure"})
        else:
            self._send(200, {"eta_minutes_ml": 1.0,
                             "port": srv.server_port})


class _StubServer(http.server.ThreadingHTTPServer):
    """A stub replica that remembers its connections, so stopping it
    also ends the handler threads parked on keep-alive connections (a
    gateway's pooled connection, or one a late hedge put back)."""

    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _StubHandler)
        self.conns = set()
        self.conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self.conns_lock:
            self.conns.add(request)
        super().process_request(request, client_address)

    def stop(self):
        self.shutdown()
        self.server_close()
        with self.conns_lock:
            conns, self.conns = list(self.conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Stubs:
    """Stub replicas started by one test, all stopped at its end."""

    def __init__(self):
        self.servers = []

    def start(self, delay_s=0.0):
        srv = _StubServer()
        srv.delay_s = delay_s
        srv.fail_with = None
        srv.hits = 0
        srv.seen_headers = []
        srv.counter_lock = threading.Lock()
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        self.servers.append((srv, t))
        return srv

    def stop(self):
        for srv, t in self.servers:
            srv.stop()
            t.join(timeout=5)


@pytest.fixture()
def stubs():
    s = _Stubs()
    yield s
    s.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gateway(pkg, targets, **cfg_overrides):
    cfg = pkg.FleetConfig(**{"hedge": False, **cfg_overrides})
    gw = pkg.gw.Gateway(targets, cfg)
    httpd = gw.serve("127.0.0.1", 0)
    return gw, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, path, payload, timeout=15.0, headers=None):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _get(base, path, timeout=10.0):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as resp:
        return resp.status, resp.read()


def _stop_gateway(gw):
    """Drain a gateway and close its pooled upstream connections (the
    JAX gateway's drain leaves them open, and each holds a stub's
    handler thread)."""
    gw.drain(timeout=5)
    with gw._lock:
        for r in gw.replicas:
            r.drop_conns()


def _targets(*servers):
    return [("127.0.0.1", s.server_port) for s in servers]


# ── gateway: routing ─────────────────────────────────────────────────

def test_gateway_routes_across_replicas_and_tags_response(pkg, stubs):
    s1, s2 = stubs.start(), stubs.start()
    gw, base = _gateway(pkg, _targets(s1, s2))
    try:
        seen_ports, seen_tags = set(), set()
        for _ in range(8):
            status, body, headers = _post(base, "/api/predict_eta", {"x": 1})
            assert status == 200
            seen_ports.add(body["port"])
            seen_tags.add(headers.get("X-Fleet-Replica"))
        assert seen_ports == {s1.server_port, s2.server_port}
        assert seen_tags == {"r0", "r1"}
    finally:
        _stop_gateway(gw)


def test_gateway_prefers_least_outstanding(pkg, stubs):
    slow, fast = stubs.start(delay_s=0.5), stubs.start()
    gw, base = _gateway(pkg, _targets(slow, fast))
    try:
        threads = [threading.Thread(target=_post,
                                    args=(base, "/api/predict_eta", {}))
                   for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.2)  # fast's parked request done; slow's still held
        for _ in range(4):
            status, body, _ = _post(base, "/api/predict_eta", {"x": 1})
            assert status == 200
            assert body["port"] == fast.server_port
        for t in threads:
            t.join(timeout=10)
    finally:
        _stop_gateway(gw)


# ── gateway: circuit breaker ─────────────────────────────────────────

def test_breaker_ejects_on_5xx_and_recovers_half_open(pkg, stubs):
    sick, ok = stubs.start(), stubs.start()
    gw, base = _gateway(pkg, _targets(sick, ok), eject_after=3,
                        cooldown_s=0.3)
    try:
        sick.fail_with = 500
        for i in range(12):
            _post(base, "/api/predict_eta", {"i": i})
        snap = gw.snapshot()
        assert snap["replicas"]["r0"]["state"] == "open"
        assert snap["replicas"]["r0"]["ejections"] == 1
        for _ in range(4):
            status, body, _ = _post(base, "/api/predict_eta", {"x": 1})
            assert status == 200 and body["port"] == ok.server_port
        sick.fail_with = None
        time.sleep(0.35)
        for _ in range(6):
            assert _post(base, "/api/predict_eta", {"x": 2})[0] == 200
        assert gw.snapshot()["replicas"]["r0"]["state"] == "closed"
    finally:
        _stop_gateway(gw)


def test_breaker_reopens_on_failed_probe(pkg, stubs):
    sick, ok = stubs.start(), stubs.start()
    gw, base = _gateway(pkg, _targets(sick, ok), eject_after=2,
                        cooldown_s=0.2)
    try:
        sick.fail_with = 503
        for i in range(8):
            _post(base, "/api/predict_eta", {"i": i})
        assert gw.snapshot()["replicas"]["r0"]["state"] == "open"
        time.sleep(0.25)
        for i in range(4):
            _post(base, "/api/predict_eta", {"i": i})
        snap = gw.snapshot()["replicas"]["r0"]
        assert snap["state"] == "open"
        assert snap["ejections"] == 1
    finally:
        _stop_gateway(gw)


def test_dead_replica_retries_to_healthy_one(pkg, stubs):
    dead_port = _free_port()
    ok = stubs.start()
    gw, base = _gateway(pkg, [("127.0.0.1", dead_port),
                              ("127.0.0.1", ok.server_port)],
                        eject_after=3, cooldown_s=60.0)
    try:
        for i in range(10):
            status, body, _ = _post(base, "/api/predict_eta", {"i": i})
            assert status == 200 and body["port"] == ok.server_port
        snap = gw.snapshot()
        assert snap["fleet"]["retries"] >= 1
        assert snap["replicas"]["r0"]["state"] == "open"
        status, _, _ = _post(base, "/api/optimize_route", {"x": 1})
        assert status == 200
    finally:
        _stop_gateway(gw)


# ── gateway: admission control ───────────────────────────────────────

def test_saturated_queue_sheds_429_with_retry_after(pkg, stubs):
    slow = stubs.start(delay_s=0.6)
    gw, base = _gateway(pkg, _targets(slow), max_inflight=1, queue_depth=1)
    try:
        results = []
        lock = threading.Lock()

        def fire():
            status, _, headers = _post(base, "/api/predict_eta", {},
                                       timeout=30)
            with lock:
                results.append((status, headers))

        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        statuses = sorted(s for s, _ in results)
        assert statuses.count(429) >= 3
        assert statuses.count(200) >= 1
        for status, headers in results:
            if status == 429:
                assert headers.get("Retry-After")
        assert gw.snapshot()["fleet"]["shed"] >= 3
    finally:
        _stop_gateway(gw)


def test_deadline_shed_is_fast(pkg, stubs):
    slow = stubs.start(delay_s=0.8)
    gw, base = _gateway(pkg, _targets(slow), max_inflight=1, queue_depth=8)
    try:
        t = threading.Thread(target=_post,
                             args=(base, "/api/predict_eta", {}))
        t.start()
        time.sleep(0.1)
        t0 = time.perf_counter()
        status, _, _ = _post(base, "/api/predict_eta", {},
                             headers={"X-Deadline-Ms": "100"})
        waited = time.perf_counter() - t0
        assert status == 429
        assert waited < 0.5
        t.join(timeout=10)
    finally:
        _stop_gateway(gw)


# ── gateway: hedging ─────────────────────────────────────────────────

def test_hedged_requests_cut_slow_replica_tail(pkg, stubs):
    slow, fast = stubs.start(delay_s=0.7), stubs.start()
    gw, base = _gateway(pkg, _targets(slow, fast), hedge=True,
                        hedge_min_ms=60.0)
    try:
        lat = []
        for i in range(6):
            t0 = time.perf_counter()
            status, _, _ = _post(base, "/api/predict_eta", {"i": i})
            lat.append(time.perf_counter() - t0)
            assert status == 200
        snap = gw.snapshot()["fleet"]
        assert snap["hedges"] >= 1
        assert snap["hedge_wins"] >= 1
        assert min(lat) < 0.3
        assert sum(lat) < 6 * 0.7
    finally:
        _stop_gateway(gw)


# ── gateway: trace / correlation propagation ─────────────────────────

def test_gateway_mints_request_id_and_propagates_trace_context(pkg, stubs):
    stub = stubs.start()
    gw, base = _gateway(pkg, _targets(stub))
    try:
        status, _, headers = _post(base, "/api/predict_eta", {"x": 1})
        assert status == 200
        rid = headers.get("X-Request-ID")
        assert rid and len(rid) == 16
        assert headers.get("X-RTPU-Replica") == "r0"
        assert headers.get("X-Fleet-Replica") == "r0"
        seen = stub.seen_headers[-1]
        assert seen.get("x-request-id") == rid
        ctx = pkg.parse_traceparent(seen.get("traceparent", ""))
        assert ctx is not None
        assert headers.get("X-Trace-Id") in (None, ctx.trace_id)
    finally:
        _stop_gateway(gw)


def test_gateway_honors_client_request_id_and_trace(pkg, stubs):
    stub = stubs.start()
    gw, base = _gateway(pkg, _targets(stub))
    trace_id = "ab" * 16
    try:
        status, _, headers = _post(
            base, "/api/predict_eta", {"x": 1},
            headers={"X-Request-ID": "my-rid.1",
                     "traceparent": f"00-{trace_id}-{'2' * 16}-01"})
        assert status == 200
        assert headers.get("X-Request-ID") == "my-rid.1"
        seen = stub.seen_headers[-1]
        assert seen.get("x-request-id") == "my-rid.1"
        tp = seen.get("traceparent", "")
        assert tp.startswith(f"00-{trace_id}-")
        assert f"-{'2' * 16}-" not in tp
        status, _, headers = _post(
            base, "/api/predict_eta", {"x": 1},
            headers={"X-Request-ID": "bad id!"})
        assert headers.get("X-Request-ID") != "bad id!"
        assert stub.seen_headers[-1].get("x-request-id") != "bad id!"
    finally:
        _stop_gateway(gw)


# ── gateway: metrics and its own routes ──────────────────────────────

def test_metrics_json_and_prometheus(pkg, stubs):
    s1, s2 = stubs.start(), stubs.start()
    gw, base = _gateway(pkg, _targets(s1, s2))
    try:
        for i in range(6):
            _post(base, "/api/predict_eta", {"i": i})
        status, raw = _get(base, "/api/metrics")
        assert status == 200
        snap = json.loads(raw)
        fleet = snap["fleet"]
        for key in ("inflight", "queued", "shed", "retries", "hedges",
                    "replica_count", "draining"):
            assert key in fleet
        assert set(snap["replicas"]) == {"r0", "r1"}
        for r in snap["replicas"].values():
            for key in ("state", "outstanding", "requests", "errors",
                        "ejections", "latency"):
                assert key in r
            if r["latency"]["count"]:
                assert "p95_ms" in r["latency"]
        status, raw = _get(base, "/api/metrics?format=prometheus")
        assert status == 200
        text = raw.decode()
        assert "routest_fleet_inflight 0" in text
        assert 'routest_fleet_replica_requests{replica="r0"}' in text
        assert 'routest_fleet_replica_up{replica="r1"} 1' in text
        assert "# TYPE routest_fleet_shed counter" in text
        assert pkg.gw._prometheus_fleet_text(snap).endswith("\n")
        # ?replicas=1 embeds each replica's /api/metrics and version
        status, raw = _get(base, "/api/metrics?replicas=1")
        snap = json.loads(raw)
        assert set(snap["replica_metrics"]) == {"r0", "r1"}
        assert snap["replica_metrics"]["r0"]["port"] == s1.server_port
        assert set(snap["versions"]) == {"r0", "r1"}
    finally:
        _stop_gateway(gw)


def test_prometheus_fleet_text_matches():
    snap = {"fleet": {"inflight": 2, "queued": 1, "replica_count": 2,
                      "capacity_units": 2.0, "uptime_s": 3.5, "shed": 4,
                      "retries": 1, "hedges": 0, "hedge_wins": 0,
                      "restarts": 2},
            "replicas": {
                f"r{i}": {"requests": 10 + i, "errors": i, "ejections": 0,
                          "outstanding": 1, "chips": 1, "capacity": 1.0,
                          "state": "open" if i else "closed",
                          "latency": {"count": 3, "p50_ms": 1.5,
                                      "p95_ms": 2.5, "p99_ms": 3.0}}
                for i in range(2)}}
    assert tgw._prometheus_fleet_text(snap) == \
        jgw._prometheus_fleet_text(snap)


@pytest.mark.parametrize("path", ["/api/probes", "/api/rollout",
                                  "/api/autoscale", "/api/slo",
                                  "/api/timeline?scope=fleet"])
def test_gateway_routes_answer_as_jax(stubs, path, monkeypatch):
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    monkeypatch.setenv("RTPU_SLO", "0")
    stub = stubs.start()
    answers = {}
    for name in ("jax", "port"):
        gw, base = _gateway(PKGS[name], _targets(stub))
        try:
            status, raw = _get(base, path)
            answers[name] = (status, json.loads(raw))
        finally:
            _stop_gateway(gw)
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] == 200


def test_port_gateway_refuses_the_prober(stubs, monkeypatch):
    monkeypatch.setenv("RTPU_PROBER", "1")
    gw = tgw.Gateway(_targets(stubs.start()),
                     TFleetConfig(hedge=False))
    with pytest.raises(RuntimeError, match="Queue A item 10, part b"):
        gw.serve("127.0.0.1", 0)


# ── gateway: graceful drain ──────────────────────────────────────────

def test_drain_finishes_inflight_then_refuses(pkg, stubs):
    slow = stubs.start(delay_s=0.6)
    gw, base = _gateway(pkg, _targets(slow))
    done = []

    def long_request():
        done.append(_post(base, "/api/predict_eta", {}, timeout=30))

    t = threading.Thread(target=long_request)
    t.start()
    time.sleep(0.15)
    gw.drain(timeout=10)
    _stop_gateway(gw)
    t.join(timeout=10)
    assert done and done[0][0] == 200
    with pytest.raises(Exception):
        _post(base, "/api/predict_eta", {}, timeout=2)


# ── supervisor (multi-process, stub worker) ──────────────────────────

_STUB_WORKER = """
import http.server, json, os
class H(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a):
        pass
    def _send(self, code, payload):
        b = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(b)))
        self.end_headers()
        self.wfile.write(b)
    def do_GET(self):
        self._send(200, {"ok": True, "pid": os.getpid()})
    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        self._send(200, {"eta_minutes_ml": 1.0, "pid": os.getpid()})
srv = http.server.ThreadingHTTPServer(("127.0.0.1", int(os.environ["PORT"])), H)
srv.daemon_threads = True
srv.serve_forever()
"""


def _stub_supervisor(pkg, n=1, **kw):
    ports = [_free_port() for _ in range(n)]
    sup = pkg.sup.ReplicaSupervisor(
        ports, command=lambda p: [sys.executable, "-c", _STUB_WORKER],
        probe_interval_s=0.15, backoff_base_s=0.2, backoff_cap_s=1.0, **kw)
    return sup, ports


def _worker_pid(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/up",
                                timeout=2) as resp:
        return json.loads(resp.read())["pid"]


def test_default_worker_is_the_packages_server():
    assert tsup.default_worker_command(5101)[1:] == [
        "-m", "routest_tpu_torch.serve"]
    assert jsup.default_worker_command(5101)[1:] == [
        "-m", "routest_tpu.serve"]


def test_supervisor_restarts_crashed_worker(pkg):
    sup, ports = _stub_supervisor(pkg)
    try:
        sup.start()
        assert sup.ready(timeout=30)
        pid1 = _worker_pid(ports[0])
        os.kill(pid1, signal.SIGKILL)
        deadline = time.time() + 30
        pid2 = None
        while time.time() < deadline:
            try:
                pid2 = _worker_pid(ports[0])
                if pid2 != pid1:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        assert pid2 is not None and pid2 != pid1
        snap = sup.snapshot()["r0"]
        assert snap["alive"] and snap["restarts"] == 1
    finally:
        sup.drain(timeout=10)


def test_supervisor_backoff_is_capped_exponential(pkg):
    sup, _ = _stub_supervisor(pkg)
    r = sup._replicas[0]
    delays = []
    for crash in range(1, 12):
        r.consecutive_crashes = crash
        delays.append(sup._backoff_s(r))
    assert delays[0] == pytest.approx(0.2)
    assert delays[1] == pytest.approx(0.4)
    assert max(delays) == pytest.approx(1.0)
    assert delays == sorted(delays)


def test_supervisor_drain_terminates_children(pkg):
    sup, ports = _stub_supervisor(pkg, n=2)
    try:
        sup.start()
        assert sup.ready(timeout=30)
        pids = [_worker_pid(p) for p in ports]
        sup.drain(timeout=10)
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
        assert all(not s["alive"] for s in sup.snapshot().values())
    finally:
        sup.drain(timeout=5)


def test_gateway_plus_supervisor_ride_through_worker_kill(pkg):
    sup, ports = _stub_supervisor(pkg, n=2)
    gw = None
    try:
        sup.start()
        assert sup.ready(timeout=30)
        gw = pkg.gw.Gateway(
            [("127.0.0.1", p) for p in ports],
            pkg.FleetConfig(hedge=False, eject_after=2, cooldown_s=0.3),
            supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        victim = _worker_pid(ports[0])
        errors = []
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                try:
                    status, _, _ = _post(base, "/api/predict_eta", {},
                                         timeout=10)
                    if status != 200:
                        errors.append(status)
                except OSError as e:
                    errors.append(str(e)[:60])
                time.sleep(0.01)

        t = threading.Thread(target=pump)
        t.start()
        time.sleep(0.3)
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 30
        recovered = False
        while time.time() < deadline:
            try:
                if _worker_pid(ports[0]) != victim:
                    recovered = True
                    break
            except OSError:
                pass
            time.sleep(0.1)
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        assert recovered, "supervisor never restarted the killed worker"
        assert not errors, f"client-visible errors during kill: {errors[:5]}"
        snap = gw.snapshot()
        assert snap["fleet"]["restarts"] >= 1
        assert snap["replicas"]["r0"]["supervisor"]["alive"]
    finally:
        if gw is not None:
            _stop_gateway(gw)
        sup.drain(timeout=10)


def test_fleet_module_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, routest_tpu_torch.serve.fleet.__main__; "
         "print(sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith(('jax.', 'routest_tpu.')) or m == 'routest_tpu'))"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
