"""The realtime loop and the live-traffic endpoints: the port's app
(``serve/app.py``, the port on the CPU) against the JAX app on the same
request bodies.

``/api/confirm_route``, ``/api/update_tracker``, ``/api/probe`` and
``/api/live`` give the same status codes and the same JSON (timings and
wall-clock stamps apart), health's bus block is the JAX app's
``checks.redis``, and the SSE frames of a seeded simulation are
byte-equal between the two apps (``dt.datetime.now`` pinned in both
``sim`` modules). ``Last-Event-ID`` resumes by header and by query. Both
apps run on their default config, dispatch on: a confirmed route whose
destinations carry lat/lon registers for re-optimization, and both apps
answer with the same ``dispatch_id``. Every test that reads a stream bounds it
with ``max_events`` and reads it on a thread with its own timeout, so a
hang fails that test alone."""

import datetime as dt
import http.client
import json
import socket
import threading
import time
import types

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu import live as jlive
from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.config import load_live_config as jload_live_config
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve import sim as jsim
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch import live as tlive
from routest_tpu_torch.core.config import Config, ServeConfig, load_live_config
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.serve import bus as tbus
from routest_tpu_torch.serve import sim as tsim
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.wsgi import make_server

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8, 64)
TICKS = (0.001, 0.003)     # simulation tick interval, seconds
STREAM_TIMEOUT_S = 30.0
BF16 = (2e-2, 0.5)
F32 = (1e-4, 0.1 + 1e-9)


class _PinnedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 17, 9, 30, 0)


@pytest.fixture
def pinned_sim_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=_PinnedClock,
                                  timedelta=dt.timedelta)
    for module in (jsim, tsim):
        monkeypatch.setattr(module, "dt", clock)


@pytest.fixture(scope="module")
def services():
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    return jsvc, tsvc


def _jconfig(live=None):
    return JConfig(**({"live": live} if live is not None else {}))


def _tconfig(live=None):
    return Config(serve=ServeConfig(device="cpu"),
                  **({"live": live} if live is not None else {}))


@pytest.fixture(scope="module")
def clients(services):
    jsvc, tsvc = services
    japp = jax_create_app(_jconfig(), eta_service=jsvc, bus=JBus(),
                          sim_tick_range=TICKS)
    tapp = create_app(_tconfig(), eta_service=tsvc, bus=tbus.InMemoryBus(),
                      sim_tick_range=TICKS)
    return Client(japp), Client(tapp)


def _both(clients, method, path, **kw):
    jclient, tclient = clients
    jr = getattr(jclient, method)(path, **kw)
    tr = getattr(tclient, method)(path, **kw)
    return jr, tr


def _bus(client):
    """The bus behind a test client's app (the JAX app keeps it on its
    server state)."""
    app = client.application
    return app.state.bus if hasattr(app, "state") else app.bus


def _read(client, url, headers=None, timeout=STREAM_TIMEOUT_S):
    """The whole body of a (bounded) stream, read on a thread: a stream
    that does not end within ``timeout`` fails the test."""
    out = {}

    def run():
        r = client.get(url, headers=headers or {})
        out["status"] = r.status_code
        out["headers"] = dict(r.headers)
        out["body"] = r.get_data()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"stream {url} did not end in {timeout} s"
    return out


def _route_details(n=9):
    coords = [[121.0 + 0.004 * i, 14.55 + 0.003 * i] for i in range(n)]
    return {
        "type": "Feature",
        "geometry": {"type": "LineString", "coordinates": coords},
        "properties": {"destinations": [{"lat": 14.58, "lon": 121.03}],
                       "summary": {"duration": 1234.5, "distance": 9876.5,
                                   "trips": 2}},
    }


def _driver(name="Sim"):
    return {"driver_name": name, "vehicle_type": "car"}


# ---------------------------------------------------------------------------
# confirm_route / update_tracker
# ---------------------------------------------------------------------------

CONFIRM_BODIES = {
    "no_body": None,
    "empty": {},
    "driver_only": {"driver_details": _driver()},
    "empty_structures": {"driver_details": {}, "route_details": {}},
    "no_coordinates": {"driver_details": _driver(),
                       "route_details": {"geometry": {"coordinates": []},
                                         "properties": {"summary": {}}}},
    "summary_not_dict": {"driver_details": _driver(), "route_details": {
        "geometry": {"coordinates": [[121.0, 14.5]]},
        "properties": {"summary": [1], "destinations": []}}},
    "route_not_dict": {"driver_details": _driver(), "route_details": "x"},
    "no_vehicle": {"driver_details": {"driver_name": "A"},
                   "route_details": _route_details()},
    "no_destinations": {"driver_details": _driver(), "route_details": {
        "geometry": {"coordinates": [[121.0, 14.5]]},
        "properties": {"summary": {"duration": 1, "distance": 1}}}},
    "bad_seed": {"driver_details": _driver("seedless"),
                 "route_details": _route_details(), "sim_seed": "7"},
    "float_seed": {"driver_details": _driver("seedless"),
                   "route_details": _route_details(), "sim_seed": 1.5},
    "good": {"driver_details": _driver("confirm-good"),
             "route_details": _route_details(3)},
    "good_seeded": {"driver_details": _driver("confirm-seeded"),
                    "route_details": _route_details(3), "sim_seed": 3},
}


@pytest.mark.parametrize("name", sorted(CONFIRM_BODIES))
def test_confirm_route_answers_match(clients, name):
    jr, tr = _both(clients, "post", "/api/confirm_route",
                   json=CONFIRM_BODIES[name])
    assert tr.status_code == jr.status_code, name
    assert tr.get_json() == jr.get_json(), name
    if name.startswith("good"):
        # the destinations carry lat/lon: registered for re-optimization
        assert tr.get_json()["status"] == "route simulation initialized."
        assert tr.get_json()["dispatch_id"].startswith("d")
        assert set(tr.get_json()) == {"status", "dispatch_id"}
    else:
        assert tr.status_code == 400


def _tracker(**kw):
    body = {"route_id": "trk", "route": [[121.0, 14.5], [121.01, 14.51]],
            "destinations": [{"lat": 14.51, "lon": 121.01}],
            "driver_name": "trk", "vehicle_type": "car", "duration": 600.0,
            "distance": 5000.0, "trips": 1,
            "pickup_time": "2026-07-29T08:00:00"}
    body.update(kw)
    return body


TRACKER_BODIES = {
    "no_body": None,
    "empty": {},
    "route_id_only": {"route_id": "x"},
    "pickup_not_str": _tracker(pickup_time={"a": 1}),
    "pickup_not_iso": _tracker(pickup_time="yesterday"),
    "duration_not_num": _tracker(duration="long"),
    "duration_huge": _tracker(duration=1e300),
    "no_vehicle": {k: v for k, v in _tracker().items()
                   if k != "vehicle_type"},
    "good": _tracker(),
    "good_no_trips": {k: v for k, v in _tracker().items() if k != "trips"},
}


@pytest.mark.parametrize("name", sorted(TRACKER_BODIES))
def test_update_tracker_answers_match(clients, name):
    jr, tr = _both(clients, "post", "/api/update_tracker",
                   json=TRACKER_BODIES[name])
    assert tr.status_code == jr.status_code, name
    assert tr.get_json() == jr.get_json(), name
    assert (tr.status_code == 200) == name.startswith("good")


# ---------------------------------------------------------------------------
# /api/probe, /api/live, health
# ---------------------------------------------------------------------------

PROBE_BODIES = {
    "no_body": None,
    "empty": {},
    "obs_not_list": {"obs": "1,2"},
    "obs_empty": {"obs": []},
    "observations_empty": {"observations": []},
    "too_many": {"obs": [[0, 1.0]] * 4097},
    "pair_short": {"obs": [[1]]},
    "pair_long": {"obs": [[1, 2.0, 3]]},
    "pair_not_list": {"obs": [7]},
    "edge_float": {"obs": [[1.5, 2.0]]},
    "edge_str": {"obs": [["1", 2.0]]},
    "speed_str": {"obs": [[1, "fast"]]},
    "hour_bad": {"obs": [[1, 2.0]], "hour": "noon", "t": 1000.0},
    "good": {"obs": [[1, 2.0], [3, 4]], "t": 1000.0, "driver": "d9",
             "hour": 27},
    "good_observations": {"observations": [[2, 5.5]], "t": 1001.0},
    "good_origin": {"obs": [[4, 3.0]], "t": 1002.0, "origin_region": "eu",
                    "driver": 17},
    "max_batch": {"obs": [[i, 1.0 + i % 7] for i in range(4096)],
                  "t": 1003.0},
}


@pytest.mark.parametrize("name", sorted(PROBE_BODIES))
def test_probe_answers_and_events_match(clients, name):
    subs = [_bus(c).subscribe("rtpu.probes") for c in clients]
    try:
        jr, tr = _both(clients, "post", "/api/probe",
                       json=PROBE_BODIES[name])
        assert tr.status_code == jr.status_code, name
        assert tr.get_json() == jr.get_json(), name
        events = [s.get(timeout=0.05) for s in subs]
        assert events[1] == events[0], name
        assert (events[1] is not None) == name.startswith(("good", "max"))
    finally:
        for s in subs:
            s.close()


def test_probe_default_time_stamp(clients):
    subs = [_bus(c).subscribe("rtpu.probes") for c in clients]
    try:
        before = time.time()
        jr, tr = _both(clients, "post", "/api/probe",
                       json={"obs": [[1, 2.0]]})
        assert tr.get_json() == jr.get_json() == {"status": "published",
                                                  "count": 1}
        events = [s.get(timeout=0.05) for s in subs]
    finally:
        for s in subs:
            s.close()
    stamps = [ev.pop("t") for ev in events]
    assert events[1] == events[0] == {"driver": "http", "obs": [[1, 2.0]]}
    assert all(before <= t <= time.time() for t in stamps)


def test_live_disabled_matches(clients):
    jr, tr = _both(clients, "get", "/api/live?metric=1")
    assert tr.status_code == jr.status_code == 200
    assert tr.get_json() == jr.get_json() == {"enabled": False}


def test_health_bus_block(clients):
    jr, tr = _both(clients, "get", "/api/health")
    jbus = dict(jr.get_json()["checks"]["redis"])
    tbus_block = dict(tr.get_json()["checks"]["redis"])
    assert isinstance(tbus_block.pop("latency_ms"), int)
    jbus.pop("latency_ms")
    assert tbus_block == jbus == {"status": "ok", "backend": "memory"}
    assert "live" not in tr.get_json()["checks"]["engine"]


def _strip(d):
    """A payload without wall-clock stamps and timings (``*_s``,
    ``*_unix``), which differ between any two runs."""
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items()
                if not (k.endswith("_s") or k.endswith("_unix"))}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def _wait(cond, what, timeout=120.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.02)


def _close(got, want, tol, what):
    assert abs(got - want) <= tol[1] + tol[0] * abs(want), (what, got, want)


def test_live_enabled_probe_flip_and_route(services, monkeypatch):
    """RTPU_LIVE on both apps over the same 300-node router: probes in
    over HTTP, one customizer cycle, then /api/live, health's live block
    and a ``use_ml_eta`` road route under the live metric."""
    jsvc, tsvc = services
    graph = generate_road_graph(n_nodes=300, seed=7)
    jrouter = jrr.RoadRouter(graph=graph, use_gnn=False,
                             use_transformer=False)
    trouter = trr.RoadRouter(graph=graph, use_gnn=False,
                             use_transformer=False, device="cpu")
    monkeypatch.setattr(jrr, "_default_router", jrouter)
    monkeypatch.setitem(trr._default_routers, "cpu", trouter)
    env = {"RTPU_LIVE": "1", "RTPU_LIVE_CUSTOMIZE_S": "3600",
           "RTPU_LIVE_MIN_OBS_EDGES": "5"}
    japp = jax_create_app(_jconfig(jload_live_config(env)),
                          eta_service=jsvc, bus=JBus(), sim_tick_range=TICKS)
    tapp = create_app(_tconfig(load_live_config(env)), eta_service=tsvc,
                      bus=tbus.InMemoryBus(), sim_tick_range=TICKS)
    jclient, tclient = Client(japp), Client(tapp)
    try:
        _wait(lambda: japp.live.ready and tapp.live.ready, "live boot")
        assert tapp.live.router is trouter
        rng = np.random.default_rng(4)
        now = time.time()
        n_batches = 12
        for k in range(n_batches):
            edges = rng.integers(0, len(trouter.senders), 40)
            body = {"obs": [[int(e), float(rng.uniform(1.0, 12.0))]
                            for e in edges], "t": now, "hour": 8,
                    "driver": f"d{k}"}
            jr, tr = (c.post("/api/probe", json=body)
                      for c in (jclient, tclient))
            assert tr.status_code == jr.status_code == 200
            assert tr.get_json() == jr.get_json()
        _wait(lambda: (japp.live.ingester.batches == n_batches
                       and tapp.live.ingester.batches == n_batches),
              "probe ingest")
        jres = japp.live.customizer.run_once(now=now + 1.0)
        tres = tapp.live.customizer.run_once(now=now + 1.0)
        assert tres["flipped"] and jres["flipped"]
        assert _strip(tres) == _strip(jres)
        assert trouter.live_epoch == jrouter.live_epoch == 1
        assert tlive.metric_epoch() == jlive.metric_epoch() == 1
        jl = jclient.get("/api/live?metric=1").get_json()
        tl = tclient.get("/api/live?metric=1").get_json()
        assert _strip(tl) == _strip(jl)
        assert tl["epoch"] == 1 and tl["n_edges"] == len(trouter.senders)
        jh = jclient.get("/api/health").get_json()["checks"]["engine"]
        th = tclient.get("/api/health").get_json()["checks"]["engine"]
        assert th["live"] == jh["live"]
        assert th["live"]["epoch"] == 1 and th["live"]["flips"] == 1
        assert th["road_router"]["live"]["epoch"] == 1
        # a road route under the live metric: same order, meters and
        # live pricing; durations in the f32 class, the ETA in bf16's
        pts = [(float(trouter.coords[i, 0]), float(trouter.coords[i, 1]))
               for i in (3, 40, 77, 150, 222)]
        body = {"source_point": {"lat": pts[0][0], "lon": pts[0][1]},
                "destination_points": [{"lat": la, "lon": lo, "payload": 1}
                                       for la, lo in pts[1:]],
                "driver_details": {"driver_name": "L", "vehicle_type": "car",
                                   "vehicle_capacity": 99,
                                   "maximum_distance": 1e6},
                "road_graph": True, "use_ml_eta": True,
                "pickup_time": "2026-10-17T08:00:00"}
        jr = jclient.post("/api/optimize_route", json=body)
        tr = tclient.post("/api/optimize_route", json=body)
        assert tr.status_code == jr.status_code == 200
        jp, tp = jr.get_json()["properties"], tr.get_json()["properties"]
        assert tp["leg_cost_model"] == jp["leg_cost_model"] == \
            "live+freeflow"
        assert tp["optimized_order"] == jp["optimized_order"]
        assert tp["summary"]["distance"] == jp["summary"]["distance"]
        _close(tp["summary"]["duration"], jp["summary"]["duration"], F32,
               "duration")
        _close(tp["eta_minutes_ml"], jp["eta_minutes_ml"], BF16, "eta")
        assert (tr.get_json()["geometry"]["coordinates"]
                == jr.get_json()["geometry"]["coordinates"])
    finally:
        for a in (japp, tapp):
            if a.live is not None:
                a.live.stop()
        tlive.set_metric_epoch(0)
        jlive.set_metric_epoch(0)


# ---------------------------------------------------------------------------
# SSE
# ---------------------------------------------------------------------------

def test_seeded_simulation_frames_byte_equal(clients, pinned_sim_clock):
    route = _route_details(12)
    body = {"driver_details": _driver("sse-seeded"), "route_details": route,
            "sim_seed": 11}
    jr, tr = _both(clients, "post", "/api/confirm_route", json=body)
    assert tr.status_code == jr.status_code == 200
    url = "/api/realtime_feed?channel=sse-seeded&max_events=12"
    # Last-Event-ID 0: the whole ring replays, then the stream goes live
    # — every tick arrives however far the simulation has got.
    got = [_read(c, url, {"Last-Event-ID": "0"}) for c in clients]
    assert got[1]["status"] == got[0]["status"] == 200
    assert "text/event-stream" in got[1]["headers"]["Content-Type"]
    assert got[1]["headers"]["Cache-Control"] == "no-cache"
    assert got[1]["body"] == got[0]["body"]
    frames = got[1]["body"].decode().split("\n\n")[:-1]
    assert len(frames) == 12
    assert frames[0].startswith("id: 1\ndata: ")
    first = json.loads(frames[0].split("data: ", 1)[1])
    assert first["start_time"] == "2026-10-17T09:30:00"
    assert first["remaining_routes"] == route["geometry"]["coordinates"]
    assert first["total_trips"] == 2


def test_sim_seeded_replays_like_jax(pinned_sim_clock):
    import random

    data = {"driver_details": _driver("rep"),
            "route_details": _route_details(6)}
    runs = []
    for module in (jsim, tsim):
        rng = random.Random(5)
        events = []
        n = module.simulate_route(data, lambda ch, ev: events.append(
            (ch, ev)), tick_range_s=(0.0, 0.001), rng=rng)
        runs.append((n, events, rng.random()))
    assert runs[1] == runs[0] and runs[1][0] == 6
    got = []
    t = tsim.start_simulation(data, lambda ch, ev: got.append(ch),
                              tick_range_s=(0.0, 0.001), seed=3)
    t.join(timeout=10.0)
    assert got == ["rep"] * 6


def _publish_ticks(clients, channel, n):
    for k in range(n):
        body = _tracker(route_id=channel, driver_name=f"{channel}-{k}")
        jr, tr = _both(clients, "post", "/api/update_tracker", json=body)
        assert tr.status_code == jr.status_code == 200


@pytest.mark.parametrize("how", ["header", "query"])
def test_last_event_id_resumes(clients, how):
    channel = f"resume-{how}"
    _publish_ticks(clients, channel, 3)
    base = f"/api/realtime_feed?channel={channel}&max_events=2"
    if how == "header":
        got = [_read(c, base, {"Last-Event-ID": "1"}) for c in clients]
    else:
        got = [_read(c, base + "&last_event_id=1") for c in clients]
    assert got[1]["body"] == got[0]["body"]
    frames = got[1]["body"].decode().split("\n\n")[:-1]
    assert [f.split("\n")[0] for f in frames] == ["id: 2", "id: 3"]
    assert f'"{channel}-1"' in frames[0] and f'"{channel}-0"' not in \
        got[1]["body"].decode()


def test_garbage_last_event_id_streams_live(clients):
    """A malformed Last-Event-ID starts live (no replay) on both apps."""
    channel = "resume-garbage"
    _publish_ticks(clients, channel, 2)
    url = f"/api/realtime_feed?channel={channel}&max_events=1"
    bodies = []
    for c in clients:
        out = {}
        t = threading.Thread(target=lambda c=c: out.update(
            _read(c, url, {"Last-Event-ID": "garbage"})), daemon=True)
        t.start()
        bus = _bus(c)
        _wait(lambda: bus._subscribers.get(channel), "subscription", 10.0)
        bus.publish(channel, {"tick": "live"})
        t.join(STREAM_TIMEOUT_S)
        assert not t.is_alive()
        bodies.append(out["body"])
    assert bodies[1] == bodies[0] == b'id: 3\ndata: {"tick": "live"}\n\n'


def test_sse_streams_through_the_stdlib_server(services):
    """The port's own server streams: no Content-Length, frames arrive
    as they are published, and an open stream does not count toward the
    drain's in-flight handlers."""
    _, tsvc = services
    bus = tbus.InMemoryBus()
    app = create_app(_tconfig(), eta_service=tsvc, bus=bus)
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = {}

    def reader():
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=STREAM_TIMEOUT_S)
        conn.request("GET", "/api/realtime_feed?channel=wire&max_events=2")
        resp = conn.getresponse()
        out["status"] = resp.status
        out["length"] = resp.getheader("Content-Length")
        out["type"] = resp.getheader("Content-Type")
        out["first"] = resp.readline() + resp.readline() + resp.readline()
        out["rest"] = resp.read()
        conn.close()

    t = threading.Thread(target=reader, daemon=True)
    try:
        t.start()
        _wait(lambda: bus._subscribers.get("wire"), "subscription", 10.0)
        assert app.inflight == 0
        bus.publish("wire", {"n": 1})
        _wait(lambda: "first" in out, "first frame", 10.0)
        bus.publish("wire", {"n": 2})
        t.join(STREAM_TIMEOUT_S)
        assert not t.is_alive()
    finally:
        server.shutdown()
        server.server_close()
    assert out["status"] == 200 and out["length"] is None
    assert out["type"] == "text/event-stream"
    assert out["first"] == b'id: 1\ndata: {"n": 1}\n\n'
    assert out["rest"] == b'id: 2\ndata: {"n": 2}\n\n'
    _wait(lambda: not bus._subscribers.get("wire"), "unsubscribe", 10.0)


# ---------------------------------------------------------------------------
# The bus on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("url", ["redis://localhost:6379/0",
                                 "rediss://cache.example:6380",
                                 "tcp://127.0.0.1:7000"])
def test_make_bus_refuses_a_redis_url(url):
    """A configured bus that does not answer fails the boot; a Redis URL
    is named with its password redacted."""
    match = "REDIS_URL"
    if url.startswith("redis"):
        # a user and password, on a local port where nothing listens
        scheme, rest = url.split("://", 1)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        db = rest.partition("/")[2]
        url = (f"{scheme}://default:s3cret-pw@localhost:{port}"
               + (f"/{db}" if db else ""))
        match = r"REDIS_URL='redis.*default:<redacted>@.*does not answer"
    with pytest.raises(RuntimeError, match=match) as err:
        tbus.make_bus(url)
    assert "s3cret-pw" not in str(err.value)
    with pytest.raises(RuntimeError, match=match) as err:
        create_app(Config(serve=ServeConfig(device="cpu", redis_url=url)),
                   eta_service=object(), store=object())
    assert "s3cret-pw" not in str(err.value)
    assert isinstance(tbus.make_bus(None), tbus.InMemoryBus)
    assert isinstance(tbus.make_bus(""), tbus.InMemoryBus)


def test_bus_replay_and_bounds_match_jax():
    buses = (JBus(history=4), tbus.InMemoryBus(history=4))
    for bus in buses:
        for i in range(10):
            bus.publish("c", {"i": i})
    got = []
    for bus in buses:
        with bus.subscribe("c", last_event_id=0) as sub:
            got.append([(sub.get(0.05), sub.last_id) for _ in range(5)])
    assert got[1] == got[0]
    assert [e for e, _ in got[1][:4]] == [{"i": i} for i in range(6, 10)]
    assert got[1][4] == (None, 10)
    big = tbus.InMemoryBus()
    keeper = big.subscribe("keeper")
    big.publish("keeper", {"k": 1})
    for i in range(big.MAX_CHANNELS + 300):
        big.publish(f"junk-{i}", {"i": i})
    assert len(big._history) <= big.MAX_CHANNELS
    assert "keeper" in big._history
    keeper.close()
    assert "keeper" not in big._subscribers
