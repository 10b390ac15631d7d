"""Dynamic fleet: the port's autoscaler, gateway membership and rollout
controller against the JAX package's.

The autoscaler's policy gives the same decisions, pressure reasons and
quiet verdicts as the JAX one on one seeded ``Signals`` sequence (the
actuation stamps applied the way ``_scale_up``/``_scale_down`` apply
them), and holds the same way while a rollout is active. Gateway
membership (half-open joins, monotonic ids, drain-before-drop) and the
autoscaler's loop over stub worker processes run once per package with
one set of expectations, as ``tests/test_fleet_dynamic.py`` drives them.
The rollout controller, over the stub workers of ``tests/test_rollout.py``,
walks the same transitions in both packages — a promotion, a rollback on
a degraded model check, a rollback on a boot crash loop — and writes the
same flight-recorder bundle naming the offending version. Every
gateway, worker and thread a test starts is stopped."""

import http.server
import json
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from routest_tpu import chaos as jchaos
from routest_tpu.core.config import AutoscaleConfig as JAutoscaleConfig
from routest_tpu.core.config import FleetConfig as JFleetConfig
from routest_tpu.core.config import RecorderConfig as JRecorderConfig
from routest_tpu.core.config import RolloutConfig as JRolloutConfig
from routest_tpu.obs import recorder as jrec
from routest_tpu.serve.fleet import autoscaler as jauto
from routest_tpu.serve.fleet import gateway as jgw
from routest_tpu.serve.fleet import rollout as jroll
from routest_tpu.serve.fleet import supervisor as jsup
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.core.config import AutoscaleConfig as TAutoscaleConfig
from routest_tpu_torch.core.config import FleetConfig as TFleetConfig
from routest_tpu_torch.core.config import RecorderConfig as TRecorderConfig
from routest_tpu_torch.core.config import RolloutConfig as TRolloutConfig
from routest_tpu_torch.obs import recorder as trec
from routest_tpu_torch.serve.fleet import autoscaler as tauto
from routest_tpu_torch.serve.fleet import gateway as tgw
from routest_tpu_torch.serve.fleet import rollout as troll
from routest_tpu_torch.serve.fleet import supervisor as tsup

PKGS = {
    "jax": types.SimpleNamespace(
        FleetConfig=JFleetConfig, AutoscaleConfig=JAutoscaleConfig,
        RolloutConfig=JRolloutConfig, RecorderConfig=JRecorderConfig,
        gw=jgw, sup=jsup, auto=jauto, roll=jroll, rec=jrec, chaos=jchaos),
    "port": types.SimpleNamespace(
        FleetConfig=TFleetConfig, AutoscaleConfig=TAutoscaleConfig,
        RolloutConfig=TRolloutConfig, RecorderConfig=TRecorderConfig,
        gw=tgw, sup=tsup, auto=tauto, roll=troll, rec=trec, chaos=tchaos),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 15.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


class _Obj:
    def __init__(self, **kw):
        self.__dict__.update(kw)


# ── autoscaler policy: one seeded signal sequence ────────────────────

_POLICY = dict(enabled=True, min_replicas=1, max_replicas=4, tick_s=0.1,
               up_queue_frac=0.25, up_outstanding=8.0, up_burn=6.0,
               up_stable_ticks=2, up_step=1, up_cooldown_s=10.0,
               down_outstanding=1.0, down_stable_ticks=3, down_step=1,
               down_cooldown_s=30.0)


def _signal_sequence(n=400, seed=13):
    """Regimes of load (hot, warm, calm) with random dwell, as the
    signals a gateway would read; replicas follow the decisions."""
    rng = np.random.default_rng(seed)
    out = []
    regime = "calm"
    for _ in range(n):
        if rng.random() < 0.08:
            regime = ("hot", "warm", "calm")[int(rng.integers(0, 3))]
        if regime == "hot":
            queued, outstanding = int(rng.integers(0, 64)), \
                int(rng.integers(4, 40))
            burn = float(rng.uniform(0, 12))
        elif regime == "warm":
            queued, outstanding = int(rng.integers(0, 3)), \
                int(rng.integers(0, 10))
            burn = float(rng.uniform(0, 7))
        else:
            queued, outstanding, burn = 0, int(rng.integers(0, 2)), 0.0
        out.append(dict(pending=int(rng.random() < 0.1), queued=queued,
                        queue_depth=64, inflight=min(32, outstanding),
                        max_inflight=32, outstanding=outstanding,
                        burn_fast=burn,
                        capacity=float(rng.choice([0.0, 1.0, 2.0]))))
    return out


def _run_policy(pkg):
    scaler = pkg.auto.Autoscaler(_Obj(), _Obj(),
                                 pkg.AutoscaleConfig(**_POLICY))
    replicas = 1
    out = []
    for t, raw in enumerate(_signal_sequence()):
        sig = pkg.auto.Signals(replicas=replicas, **raw)
        now = float(t)
        reasons = scaler.pressure(sig)
        quiet = scaler.quiet(sig)
        decision = scaler.decide(sig, now=now)
        if decision == "up":
            scaler._last_up, scaler._up_ticks = now, 0
            replicas += 1
        elif decision == "down":
            scaler._last_down, scaler._down_ticks = now, 0
            replicas -= 1
        out.append((decision, reasons, quiet, scaler._up_ticks,
                    scaler._down_ticks, round(sig.outstanding_per_capacity,
                                              9)))
    return out


def test_autoscaler_policy_matches_on_a_seeded_sequence():
    got, want = _run_policy(PKGS["port"]), _run_policy(PKGS["jax"])
    assert got == want
    decisions = [d for d, *_ in want]
    assert decisions.count("up") >= 2 and decisions.count("down") >= 2


def test_autoscaler_holds_while_rollout_active(pkg):
    rollout = _Obj(active=lambda: True)
    gw = _Obj(rollout=rollout, autoscaler=None)
    scaler = pkg.auto.Autoscaler(_Obj(), gw, pkg.AutoscaleConfig(
        enabled=True, up_stable_ticks=1, tick_s=0.1))
    scaler._up_ticks = 99
    assert scaler.tick() is None
    assert scaler._up_ticks == 0
    assert scaler.tick() is None
    holds = [h for h in scaler._history if h.get("direction") == "hold"]
    assert [h["reason"] for h in holds] == ["rollout_active"]


# ── stub replicas (in-process) and workers (processes) ───────────────

class _StubHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code, payload):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
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
        self._send(200, {"eta_minutes_ml": 1.0, "port": srv.server_port})


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


@pytest.fixture()
def stubs():
    servers = []

    def start(delay_s=0.0):
        srv = _StubServer()
        srv.delay_s = delay_s
        srv.hits = 0
        srv.counter_lock = threading.Lock()
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        servers.append((srv, t))
        return srv

    yield start
    for srv, t in servers:
        srv.stop()
        t.join(timeout=5)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(gw):
    httpd = gw.serve("127.0.0.1", 0)
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop_gateway(gw):
    gw.drain(timeout=5)
    with gw._lock:
        for r in gw.replicas:
            r.drop_conns()


def _gateway(pkg, targets, **cfg):
    gw = pkg.gw.Gateway(targets, pkg.FleetConfig(**{"hedge": False, **cfg}))
    return gw, _serve(gw)


def _post(base, path, payload, timeout=15.0):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(base, path, timeout=15.0):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


# ── gateway: dynamic registration ────────────────────────────────────

def test_add_replica_enters_half_open_then_joins_rotation(pkg, stubs):
    s1, s2 = stubs(), stubs()
    gw, base = _gateway(pkg, [("127.0.0.1", s1.server_port)])
    try:
        rid = gw.add_replica("127.0.0.1", s2.server_port)
        assert rid == "r1"
        assert gw.snapshot()["replicas"][rid]["state"] == "half_open"
        for _ in range(20):
            assert _post(base, "/api/predict_eta", {})[0] == 200
        assert gw.snapshot()["replicas"][rid]["state"] == "closed"
        assert s2.hits > 0 and s1.hits > 0
        with pytest.raises(ValueError, match="already registered"):
            gw.add_replica("127.0.0.1", 1, rid="r0")
        assert gw.add_replica("127.0.0.1", 2, rid="r7") == "r7"
        assert gw.add_replica("127.0.0.1", 3) == "r8"
    finally:
        _stop_gateway(gw)


def test_remove_replica_drains_outstanding_before_dropping(pkg, stubs):
    slow, fast = stubs(delay_s=0.6), stubs()
    gw, base = _gateway(pkg, [("127.0.0.1", slow.server_port),
                              ("127.0.0.1", fast.server_port)])
    try:
        results = []
        t = threading.Thread(target=lambda: results.append(
            _post(base, "/api/predict_eta", {}, timeout=10)))
        t.start()
        deadline = time.time() + 3
        while time.time() < deadline:
            with gw._lock:
                if any(r.outstanding > 0 and r.port == slow.server_port
                       for r in gw.replicas):
                    break
            time.sleep(0.01)
        assert gw.remove_replica("r0", timeout=5.0)
        t.join(timeout=10)
        assert results and results[0][0] == 200
        assert {r.id for r in gw.replicas} == {"r1"}
        assert gw.remove_replica("r0") is False
        with gw._lock:
            gw.replicas[0].draining = True
        assert _post(base, "/api/predict_eta", {})[0] == 503
    finally:
        _stop_gateway(gw)


_STUB_WORKER = """
import http.server, json, os, time
VERSION = os.environ.get("RTPU_VERSION") or None
MODEL_STATUS = os.environ.get("STUB_MODEL_STATUS", "ok")
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
        bare = self.path.split("?", 1)[0]
        if bare == "/api/health":
            self._send(200, {"checks": {"model": {
                "status": MODEL_STATUS, "generation": 1,
                "fingerprint": "stub-" + (VERSION or "none")}},
                "status": MODEL_STATUS})
        else:
            self._send(200, {"ok": True, "version": VERSION,
                             "pid": os.getpid()})
    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        self._send(200, {"eta_minutes_ml": 1.0, "version": VERSION})
srv = http.server.ThreadingHTTPServer(("127.0.0.1", int(os.environ["PORT"])), H)
srv.daemon_threads = True
srv.serve_forever()
"""


def _stub_supervisor(pkg, n=1):
    ports = [_free_port() for _ in range(n)]
    sup = pkg.sup.ReplicaSupervisor(
        ports, command=lambda p: [sys.executable, "-c", _STUB_WORKER],
        probe_interval_s=0.15, backoff_base_s=0.2, backoff_cap_s=1.0)
    return sup, ports


# ── autoscaler loop over stub workers ────────────────────────────────

def test_autoscaler_scales_stub_fleet_up_and_down(pkg):
    sup, ports = _stub_supervisor(pkg, n=1)
    gw = scaler = None
    try:
        sup.start()
        assert sup.ready(timeout=30)
        gw = pkg.gw.Gateway([("127.0.0.1", ports[0])],
                            pkg.FleetConfig(hedge=False, max_inflight=2,
                                            queue_depth=8), supervisor=sup)
        base = _serve(gw)
        scaler = pkg.auto.Autoscaler(sup, gw, pkg.AutoscaleConfig(
            enabled=True, min_replicas=1, max_replicas=2, tick_s=0.1,
            up_queue_frac=0.25, up_outstanding=4.0, up_burn=999.0,
            up_stable_ticks=1, up_step=1, up_cooldown_s=0.5,
            down_outstanding=1.0, down_stable_ticks=3,
            down_cooldown_s=0.5, startup_timeout_s=60.0,
            drain_timeout_s=5.0))
        assert gw.autoscaler is scaler
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                try:
                    _post(base, "/api/predict_eta", {}, timeout=10)
                except OSError:
                    pass

        pumps = [threading.Thread(target=pump) for _ in range(6)]
        for t in pumps:
            t.start()
        try:
            deadline = time.time() + 30
            joined = False
            while time.time() < deadline and not joined:
                scaler.tick()
                with gw._lock:
                    joined = len(gw.replicas) == 2
                time.sleep(0.05)
            assert joined, "autoscaler never grew the stub fleet"
        finally:
            stop.set()
            for t in pumps:
                t.join(timeout=10)
        deadline = time.time() + 30
        shrunk = False
        while time.time() < deadline and not shrunk:
            scaler.tick()
            with gw._lock:
                shrunk = len(gw.replicas) == 1
            time.sleep(0.05)
        assert shrunk, "autoscaler never scaled back down"
        assert sup.replica_count() == 1
        hist = scaler.snapshot()["history"]
        assert any(h.get("phase") == "joined" for h in hist)
        assert any(h.get("direction") == "down"
                   and h.get("phase") == "stopped" for h in hist)
    finally:
        if scaler is not None:
            scaler.stop()
        if gw is not None:
            _stop_gateway(gw)
        sup.drain(timeout=10)


# ── rollout controller over stub workers ─────────────────────────────

_ROLLOUT = dict(canary_fraction=0.5, canary_replicas=1, bake_s=1.5,
                tick_s=0.1, max_unavailable=1, min_canary_requests=5,
                max_error_rate=0.05, max_error_ratio=3.0,
                latency_threshold_ms=1500.0, max_latency_regression=0.25,
                crash_restarts=2, boot_timeout_s=30.0,
                health_timeout_s=5.0, drain_timeout_s=5.0)

SCENARIOS = {
    "promote": ({"RTPU_VERSION": "v2"}, None, "done"),
    "degraded_model": ({"RTPU_VERSION": "v2",
                        "STUB_MODEL_STATUS": "degraded"}, None,
                       "rolled_back"),
    "boot_crash_loop": ({"RTPU_VERSION": "v2"},
                        "replica.boot.v2:error=1.0", "rolled_back"),
}


def _rollout_run(pkg, tmp_path, scenario, monkeypatch):
    monkeypatch.setenv("RTPU_SLO", "0")
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    env, chaos_spec, _ = SCENARIOS[scenario]
    pkg.rec.configure_recorder(pkg.rec.FlightRecorder(pkg.RecorderConfig(
        dir=str(tmp_path / "pm"), min_interval_s=0.0)))
    if chaos_spec:
        pkg.chaos.configure(pkg.chaos.ChaosEngine(spec=chaos_spec, seed=11))
    sup, ports = _stub_supervisor(pkg, n=2)
    gw = None
    try:
        sup.start()
        assert sup.ready(timeout=30)
        gw = pkg.gw.Gateway([("127.0.0.1", p) for p in ports],
                            pkg.FleetConfig(hedge=False), supervisor=sup)
        base = _serve(gw)
        ctl = pkg.roll.RolloutController(sup, gw,
                                         pkg.RolloutConfig(**_ROLLOUT))
        statuses = []
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                statuses.append(_post(base, "/api/predict_eta", {},
                                      timeout=10)[0])
                time.sleep(0.005)

        t = threading.Thread(target=pump)
        t.start()
        try:
            assert ctl.start("v2", env=env)
            assert ctl.start("v3") is False
            final = ctl.wait(timeout=90)
        finally:
            stop.set()
            t.join(timeout=10)
        snap = ctl.snapshot()
        transitions = [(h.get("event"), h.get("from"), h.get("to"),
                        h.get("trigger"), h.get("reason"), h.get("ok"))
                       for h in snap["history"]]
        bundle = None
        if snap["last_bundle"]:
            with open(f"{snap['last_bundle']}/manifest.json") as f:
                manifest = json.load(f)
            bundle = (manifest["reason"],
                      {k: manifest["detail"].get(k) for k in
                       ("event", "trigger", "offending_version",
                        "reason")})
        with gw._lock:
            versions = sorted(str(r.version) for r in gw.replicas)
        _, api = _get(base, "/api/rollout")
        return {"final": final, "transitions": transitions,
                "bundle": bundle, "versions": versions,
                "api_state": api["state"],
                "errors_5xx": [s for s in statuses if s >= 500]}
    finally:
        if chaos_spec:
            pkg.chaos.configure(None)
        pkg.rec.configure_recorder(None)
        if gw is not None:
            _stop_gateway(gw)
        sup.drain(timeout=10)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_rollout_transitions_and_bundle_match(tmp_path, scenario,
                                              monkeypatch):
    got = _rollout_run(PKGS["port"], tmp_path / "port", scenario,
                       monkeypatch)
    want = _rollout_run(PKGS["jax"], tmp_path / "jax", scenario,
                        monkeypatch)
    assert got == want
    assert got["final"] == SCENARIOS[scenario][2]
    assert got["errors_5xx"] == []
    if scenario == "promote":
        assert got["versions"] == ["v2", "v2"] and got["bundle"] is None
    else:
        assert got["versions"] == ["None", "None"]
        trigger = {"degraded_model": "verify_failed",
                   "boot_crash_loop": "boot_crash_loop"}[scenario]
        assert got["bundle"] == ("rollout_rollback", {
            "event": "rollback", "trigger": trigger,
            "offending_version": "v2", "reason": trigger})
