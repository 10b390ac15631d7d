"""The port's fleet with real replicas on the CPU.

Two ``python -m routest_tpu_torch.serve`` replicas (``ROUTEST_DEVICE=
cpu``) under the port's supervisor, behind the port's gateway, sharing
the port's TCP broker through ``REDIS_URL``: a 64-row
``/api/predict_eta_batch`` and a single ``/api/predict_eta`` through the
gateway give the JAX app's JSON in process on the same bodies (same
keys and strings; minutes within rtol 1e-4 / atol 1e-3, both CPU paths
computing in f32; completion times within 1 s), a tracker event
confirmed on one replica reaches an SSE stream held through the gateway
on the other, an RTW1 frame rides the gateway's wire channel (no HTTP
fallback) to answers bitwise the JSON path's, and a killed replica is restarted by the supervisor while
the gateway answers every request without a 5xx. Then ``python -m
routest_tpu_torch.serve.fleet`` itself boots one CPU replica, answers
through its gateway and drains to exit 0 on SIGTERM, and a replica
whose wire-channel port (``PORT + RTPU_WIRE_PORT_OFFSET``) lies past
65535 still serves HTTP; one spawned on a port a client connection of
this host left in TIME_WAIT cannot bind it (the reference's fault), so
the supervisor's ``add_replica`` picks a port outside the host's
ephemeral range, where no client TIME_WAIT sits, and a replica spawned
there binds while such TIME_WAITs stand. Every wait is
bounded; every process, socket and thread is reaped at module end."""

import datetime as dt
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import FleetConfig
from routest_tpu_torch.data.features import encode_requests
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.serve import netbus, wirecodec
from routest_tpu_torch.serve.fleet.gateway import Gateway
from routest_tpu_torch.serve.fleet import supervisor
from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "eta_mlp.msgpack")
BUCKETS = (8, 64)
WIRE_OFFSET = 1000


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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_pair(offset):
    """A free port whose wire-channel port (``+ offset``) is free too."""
    while True:
        port = _free_port()
        if port + offset > 65535:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + offset))
            except OSError:
                continue
        return port


def _replica_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RTPU_FLEET", "RTPU_GATEWAY"))}
    env.update({"ROUTEST_DEVICE": "cpu", "ETA_MODEL_PATH": ARTIFACT,
                "RTPU_BATCH_BUCKETS": ",".join(map(str, BUCKETS)),
                "OMP_NUM_THREADS": "1", **extra})
    return env


@pytest.fixture(scope="module")
def fleet():
    broker, _ = netbus.start_broker()
    ports = [_free_pair(WIRE_OFFSET) for _ in range(2)]
    wire = {"RTPU_WIRE": "1", "RTPU_WIRE_PORT_OFFSET": str(WIRE_OFFSET)}
    sup = ReplicaSupervisor(
        ports, env=_replica_env(
            REDIS_URL=f"tcp://127.0.0.1:{broker.port}", **wire),
        cwd=REPO, probe_interval_s=0.25, backoff_base_s=0.2,
        backoff_cap_s=2.0)
    gw = None
    try:
        sup.start()
        assert sup.ready(timeout=90), "replicas never answered /up"
        with pytest.MonkeyPatch.context() as mp:
            for k, v in wire.items():   # the gateway reads them once
                mp.setenv(k, v)
            gw = Gateway([("127.0.0.1", p) for p in ports],
                         FleetConfig(hedge=False, eject_after=2,
                                     cooldown_s=0.3), supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        yield {"gw": gw, "sup": sup, "ports": ports,
               "base": f"http://127.0.0.1:{httpd.server_address[1]}"}
    finally:
        if gw is not None:
            gw.drain(timeout=10)
        sup.drain(timeout=30)
        with broker._subs_lock:
            handlers = {h for hs in broker._subs.values() for h in hs}
        broker.shutdown()
        broker.server_close()
        for h in handlers:
            try:
                h.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


@pytest.fixture(scope="module")
def jax_client():
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    app = jax_create_app(JConfig(), eta_service=jsvc)
    yield Client(app)
    # The JAX app has no close(): stop its tickers and loops by hand.
    for part in (app.slo, app.timeline, app.efficiency, app.change_ledger):
        if part is not None:
            part.stop()
    if app.dispatch is not None and app.dispatch.reopt is not None:
        app.dispatch.reopt.stop()


def _request(base, method, path, body=None, headers=None, timeout=60.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"{base}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _same_json(got, want):
    """Same keys and strings; minutes within rtol 1e-4 / atol 1e-3;
    completion times within 1 s."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        if key.startswith("eta_completion_time"):
            gs, ws = (g, w) if isinstance(w, list) else ([g], [w])
            assert len(gs) == len(ws), key
            for a, b in zip(gs, ws):
                delta = dt.datetime.fromisoformat(a) \
                    - dt.datetime.fromisoformat(b)
                assert abs(delta.total_seconds()) <= 1.0, (key, a, b)
        elif key.startswith("eta_minutes"):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-4, atol=1e-3, err_msg=key)
        else:
            assert g == w, key


def _batch_body(n, seed):
    rng = np.random.default_rng(seed)
    return {"distance_m": rng.uniform(100, 40_000, n).round(1).tolist(),
            "weather": rng.choice(["Sunny", "Cloudy", "Stormy", "Windy",
                                   "Fog"], n).tolist(),
            "traffic": rng.choice(["Low", "Medium", "High", "Jam",
                                   "Gridlock"], n).tolist(),
            "driver_age": rng.integers(18, 70, n).tolist(),
            "pickup_time": [f"2026-10-{10 + i % 9:02d}T{i % 24:02d}:"
                            f"{(7 * i) % 60:02d}:00" for i in range(n)]}


_ONE = {"summary": {"distance": 12_500}, "weather": "Stormy",
        "traffic": "Jam", "pickup_time": "2026-10-16T08:30:00+08:00",
        "driver_age": 41}


@pytest.mark.parametrize("path,body", [
    ("/api/predict_eta_batch", _batch_body(64, seed=3)),
    ("/api/predict_eta", _ONE)], ids=["batch64", "single"])
def test_gateway_answers_as_the_jax_app(fleet, jax_client, path, body):
    status, got = _request(fleet["base"], "POST", path, body)
    want = jax_client.post(path, json=body)
    assert status == want.status_code == 200
    _same_json(got, want.get_json())


def _wire_counts():
    fams = get_registry().snapshot()

    def series(name, label):
        return {s["labels"][label]: s["value"]
                for s in fams.get(name, {}).get("series", [])}

    return (series("rtpu_wire_conns_total", "event"),
            series("rtpu_wire_frames_total", "direction"))


def test_a_wire_frame_rides_the_gateway_channel(fleet):
    body = _batch_body(64, seed=5)
    pickups = [dt.datetime.fromisoformat(p) for p in body["pickup_time"]]
    rows = encode_requests(
        weather=body["weather"], traffic=body["traffic"],
        weekday=[p.weekday() for p in pickups],
        hour=[p.hour for p in pickups],
        distance_km=[d / 1000.0 for d in body["distance_m"]],
        driver_age=[float(a) for a in body["driver_age"]])
    pickup_ms = np.asarray([np.datetime64(p, "ms") for p in pickups],
                           "datetime64[ms]").astype(np.int64)
    frame = wirecodec.encode_eta_request(np.asarray(rows, np.float32),
                                         pickup_ms)
    conns0, frames0 = _wire_counts()
    req = urllib.request.Request(
        f"{fleet['base']}/api/predict_eta_batch", data=frame,
        method="POST", headers={"Content-Type": wirecodec.WIRE_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == wirecodec.WIRE_CONTENT_TYPE
        wire = wirecodec.decode_eta_response(resp.read())
    conns, frames = _wire_counts()
    assert conns.get("fallback_http", 0) == conns0.get("fallback_http", 0)
    assert frames.get("sent", 0) == frames0.get("sent", 0) + 1
    status, js = _request(fleet["base"], "POST", "/api/predict_eta_batch",
                          body)
    assert status == 200
    for key, col in [("eta_minutes_ml", wire["minutes"])] + [
            (f"eta_minutes_ml_{k}", v) for k, v in wire["bands"].items()]:
        assert np.round(col, 4).tolist() == js[key], key
    iso = np.datetime_as_string(
        np.asarray(wire["completion_ms"]).astype("datetime64[ms]"),
        unit="s")
    assert [str(x) for x in iso] == js["eta_completion_time_ml"]


def _sse_frames(base, path, headers, n, timeout=30.0):
    host, port = base.rsplit("//", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        assert resp.status == 200
        raw = resp.read()        # max_events closes the stream
    finally:
        conn.close()
    frames = [f for f in raw.decode().split("\n\n") if f.startswith("id:")]
    assert len(frames) == n, raw[:500]
    return [json.loads(f.split("data: ", 1)[1]) for f in frames]


def test_sse_crosses_replicas_through_the_broker(fleet):
    gw, ports = fleet["gw"], fleet["ports"]
    coords = [[121.0437, 14.6760], [121.0244, 14.5547]]
    body = {"driver_details": {"driver_name": "fleet-sse",
                               "vehicle_type": "car"},
            "route_details": {
                "geometry": {"coordinates": coords},
                "properties": {"summary": {"distance": 14_000.0,
                                           "duration": 1500.0},
                               "destinations": ["A", "B"]}},
            "sim_seed": 3}
    # Published on r0, directly.
    status, out = _request(f"http://127.0.0.1:{ports[0]}", "POST",
                           "/api/confirm_route", body)
    assert status == 200, out
    # Read through the gateway from r1 (every pick goes to r1).
    gw.set_canary({"r1"}, 1.0)
    try:
        frames = _sse_frames(
            fleet["base"], "/api/realtime_feed?channel=fleet-sse"
            "&max_events=1", {"Last-Event-ID": "0"}, 1)
    finally:
        gw.clear_canary()
    assert frames[0]["assigned_driver"] == "fleet-sse"
    assert frames[0]["remaining_routes"] == coords
    with gw._lock:
        r1 = next(r for r in gw.replicas if r.id == "r1")
        assert r1.requests >= 1


def test_a_killed_replica_restarts_with_no_5xx(fleet):
    sup, base = fleet["sup"], fleet["base"]
    statuses, errors = [], []
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                statuses.append(_request(base, "POST", "/api/predict_eta",
                                         _ONE, timeout=30)[0])
            except OSError as e:
                errors.append(str(e)[:80])
            time.sleep(0.01)

    t = threading.Thread(target=pump)
    t.start()
    try:
        time.sleep(0.3)
        assert sup.kill_replica(1)
        deadline = time.monotonic() + 60.0
        restarted = False
        while time.monotonic() < deadline:
            snap = sup.snapshot()["r1"]
            if snap["restarts"] >= 1 and snap["alive"] \
                    and sup._probe(fleet["ports"][1]):
                restarted = True
                break
            time.sleep(0.2)
        time.sleep(0.5)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert restarted, "the supervisor never restarted the killed replica"
    assert statuses and all(s < 500 for s in statuses), \
        sorted(set(statuses))
    assert not errors, errors[:3]
    # And it serves again through the gateway.
    fleet["gw"].set_canary({"r1"}, 1.0)
    try:
        assert _request(base, "POST", "/api/predict_eta", _ONE)[0] == 200
    finally:
        fleet["gw"].clear_canary()


def test_the_fleet_entry_point_boots_serves_and_drains():
    gw_port = _free_port()
    env = _replica_env(RTPU_FLEET_REPLICAS="1",
                       RTPU_GATEWAY_PORT=str(gw_port),
                       RTPU_FLEET_BASE_PORT=str(_free_port()))
    env.pop("REDIS_URL", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "routest_tpu_torch.serve.fleet"], cwd=REPO,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        base = f"http://127.0.0.1:{gw_port}"
        deadline = time.monotonic() + 90.0
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status, health = _request(base, "GET", "/api/health",
                                          timeout=5)
                if status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.3)
        assert health is not None and health["status"] == "ok", lines[-5:]
        assert health["checks"]["model"]["scoring"]["device"] == "cpu"
        assert health["checks"]["engine"]["mesh"]["placement"] == "s0:host"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
    events = [json.loads(x) for x in lines if x.startswith("{")]
    plan = next(e for e in events if e.get("event") == "placement_plan")
    assert (plan["platform"], plan["chips"], plan["layout"]) == \
        ("cpu", 1, "host")
    assert any(e.get("event") == "fleet_stopped" for e in events)


def test_a_wire_port_past_the_range_leaves_http_serving():
    # A supervisor's fresh port near the top of the range plus the
    # offset names no port: the channel is skipped, the replica serves.
    port = next(p for p in range(65535, 64535, -1) if _bindable(p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "routest_tpu_torch.serve"], cwd=REPO,
        env=_replica_env(PORT=str(port), RTPU_WIRE="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(proc.stderr), daemon=True)
    reader.start()
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90.0
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status = _request(base, "POST", "/api/predict_eta", _ONE,
                                  timeout=5)[0]
                break
            except OSError:
                time.sleep(0.3)
        assert status == 200, lines[-5:]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
    assert any('"event": "wire_channel_bind_failed"' in x for x in lines)


def _bindable(port):
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def _client_time_wait_port():
    """A loopback port held in TIME_WAIT by a closed client connection
    (the client closed first, as ``urllib`` and ``http.client`` callers
    do)."""
    with socket.socket() as srv:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        client = socket.create_connection(srv.getsockname())
        port = client.getsockname()[1]
        accepted, _ = srv.accept()
        client.close()
        time.sleep(0.1)
        accepted.close()
    return port


def test_a_fresh_port_in_client_time_wait_fails_the_replica_bind():
    # The supervisor's fresh-port scheme (both packages) can hand a
    # replica such a port: it exits 1 and its respawns on the same port
    # fail until the TIME_WAIT ends (ROADMAP Queue C 14).
    port = _client_time_wait_port()
    out = subprocess.run(
        [sys.executable, "-m", "routest_tpu_torch.serve"], cwd=REPO,
        env=_replica_env(PORT=str(port)), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1
    assert "Address already in use" in out.stderr


@pytest.mark.parametrize("span,where", [
    ((20000, 60999), "below"), ((10500, 60999), "above"),
    ((1024, 65000), "none"), (None, "os")])
def test_free_port_lies_outside_the_ephemeral_range(monkeypatch, span,
                                                    where):
    monkeypatch.setattr(supervisor, "ephemeral_port_range", lambda: span)
    if where == "none":
        with pytest.raises(RuntimeError, match="ephemeral range"):
            supervisor.free_port()
        return
    ports = {supervisor.free_port() for _ in range(20)}
    for port in ports:
        if where == "below":
            assert 10000 <= port < span[0]
        elif where == "above":
            assert span[1] < port <= 65535
        else:
            assert 0 < port <= 65535
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))      # free when picked


def test_add_replica_binds_outside_the_range_past_client_time_waits():
    # ROADMAP Queue C 14, repaired in the port: the ports client
    # connections left in TIME_WAIT are ephemeral, and a replica that
    # add_replica() spawns without a port lands outside that range.
    span = supervisor.ephemeral_port_range()
    assert span is not None
    low, high = span
    waits = [_client_time_wait_port() for _ in range(4)]
    assert all(low <= p <= high for p in waits)
    sup = ReplicaSupervisor([], env=_replica_env(ROUTEST_WARM_BUCKETS="0"),
                            cwd=REPO, probe_interval_s=0.25,
                            backoff_base_s=0.2, backoff_cap_s=2.0)
    try:
        sup.start()
        index, port = sup.add_replica()
        assert not low <= port <= high and port not in waits
        assert sup.wait_port_ready(port, timeout=120)
        status = sup.replica_status(index)
        assert status["alive"] and status["restarts"] == 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/ping",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["ok"]
    finally:
        sup.drain(timeout=30)
