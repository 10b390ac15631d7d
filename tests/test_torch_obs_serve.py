"""The replica's observability routes and fault points: the port's app
(``serve/app.py`` on the CPU) against the JAX app on the same requests.

Both apps run on their default config read from one environment, with
fresh process singletons (tracer, flight recorder, change ledger,
goodput ledger) per package, no SLO ticker (``RTPU_SLO_TICK_S=0``), the
timeline ticked by hand at explicit instants, no model warm-up, and a
missing kernel record (both watchdogs degrade to ``no_artifact``).
The nine routes — ``/api/trace``, ``/api/slo``, ``/api/efficiency``,
``/api/changes``, ``/api/incidents``, ``/api/timeline``, ``POST
/api/debug/profile``, ``GET /api/debug/probe_subgraph``, ``POST
/api/debug/snapshot`` — answer with the same status and the same JSON
once ids, clocks, device identity and measured seconds are taken out.
Under injected faults at ``device.compute``, ``store.http`` and
``model.load`` the two apps answer with the same status codes and
bodies, and the port never scores on another device: the third
``device.compute`` request is bitwise the port's own fault-free answer.
Every background thread the apps start is stopped at the end."""

import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu import chaos as jchaos
from routest_tpu.core.config import load_config as jload_config
from routest_tpu.core.config import load_efficiency_config as jload_eff
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.obs import efficiency as jeff
from routest_tpu.obs import ledger as jledger
from routest_tpu.obs import recorder as jrecorder
from routest_tpu.obs import trace as jtrace
from routest_tpu.obs.registry import MetricsRegistry as JRegistry
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.core.config import load_config, load_efficiency_config
from routest_tpu_torch.obs import efficiency as teff
from routest_tpu_torch.obs import ledger as tledger
from routest_tpu_torch.obs import recorder as trecorder
from routest_tpu_torch.obs import trace as ttrace
from routest_tpu_torch.obs.registry import MetricsRegistry
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.bus import InMemoryBus
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """One environment for both apps, and fresh process singletons."""
    tmp = tmp_path_factory.mktemp("obs_serve")
    mp = pytest.MonkeyPatch()
    for name, value in {
            "ROUTEST_DEVICE": "cpu", "ROUTEST_WARM_BUCKETS": "0",
            "RTPU_BATCH_BUCKETS": "8,64", "RTPU_SLO_TICK_S": "0",
            "RTPU_RECORDER_DIR": str(tmp / "pm"),
            "RTPU_RECORDER_FOLLOWUP_S": "0",
            "RTPU_RECORDER_MIN_INTERVAL_S": "0",
            "RTPU_STORE_BACKOFF_MS": "0", "RTPU_STORE_COOLDOWN_S": "600",
            "RTPU_EFF_KERNEL_ARTIFACT": str(tmp / "absent.json"),
            "RTPU_PROFILE_MIN_INTERVAL_S": "0",
            "RTPU_LEDGER_PUBLISH": "0", "RTPU_FASTLANE_CACHE": "1"}.items():
        mp.setenv(name, value)
    saved = []
    for mod, attr in ((jrecorder, "_recorder"), (trecorder, "_recorder"),
                      (jledger, "_ledger"), (tledger, "_ledger"),
                      (jeff, "_ledger"), (teff, "_ledger"),
                      (jtrace, "_tracer"), (ttrace, "_tracer")):
        saved.append((mod, attr, getattr(mod, attr)))
    for mod in (jrecorder, trecorder):
        mod.configure_recorder(mod.FlightRecorder())
    mp.setattr(jledger, "_ledger", jledger.ChangeLedger())
    mp.setattr(tledger, "_ledger", tledger.ChangeLedger())
    mp.setattr(jeff, "_ledger", jeff.GoodputLedger(jload_eff(),
                                                   registry=JRegistry()))
    mp.setattr(teff, "_ledger", teff.GoodputLedger(
        load_efficiency_config(), registry=MetricsRegistry()))
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(sample_rate=1.0, buffer_size=4096)
        tr._rng = random.Random(1)
        mod.configure_tracer(tr)
    yield tmp
    for mod in (jrecorder, trecorder):
        mod.configure_recorder(None)
    for mod, attr, value in saved:
        setattr(mod, attr, value)
    mp.undo()


def _close(app):
    for part in (app.slo, app.timeline, app.efficiency, app.change_ledger):
        if part is not None:
            part.stop()
    if app.dispatch is not None and app.dispatch.reopt is not None:
        app.dispatch.reopt.stop()


@pytest.fixture(scope="module")
def apps(env):
    before = set(threading.enumerate())
    jcfg, tcfg = jload_config(), load_config()
    japp = jax_create_app(jcfg, eta_service=JEtaService(
        jcfg.serve, model_path=ARTIFACT), bus=JBus())
    tapp = create_app(tcfg, eta_service=EtaService(
        tcfg.serve, model_path=ARTIFACT, device="cpu"), bus=InMemoryBus())
    for app in (japp, tapp):
        app.timeline.stop()   # ticked by hand below
    yield japp, tapp
    _close(japp)
    tapp.close()
    _join_profiles()
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0   # others' transient threads end
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module")
def clients(apps):
    return tuple(Client(a) for a in apps)


def _both(clients, method, path, **kw):
    jr = getattr(clients[0], method)(path, **kw)
    tr = getattr(clients[1], method)(path, **kw)
    assert tr.status_code == jr.status_code, (path, tr.get_data(),
                                              jr.get_data())
    return jr, tr


def _join_profiles():
    for t in threading.enumerate():
        if t.name == "triggered-profiler":
            t.join(timeout=10.0)


_TIMING = {"start_unix", "duration_ms", "thread", "ts", "dur",
           "last_transition_unix", "device_s", "queue_s", "compute_s",
           "rate", "written_unix", "uptime_s", "latency_ms", "pid", "tid",
           # a process-wide counter of the services built so far
           "model_generation"}


def _scrub(tree, ids=None):
    """Drop clock and measured-time fields; rename trace/span/request ids
    by first appearance."""
    ids = {} if ids is None else ids
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in _TIMING:
                continue
            if k in ("trace_id", "span_id", "parent_id", "request_id",
                     "X-Trace-Id") and isinstance(v, str):
                out[k] = ids.setdefault(v, f"id{len(ids)}")
            else:
                out[k] = _scrub(v, ids)
        return out
    if isinstance(tree, list):
        return [_scrub(v, ids) for v in tree]
    return tree


def _rows_body(seed, n):
    rng = np.random.default_rng(seed)
    return {"distance_m": [float(v) for v in rng.uniform(500, 30000, n)],
            "weather": ["Sunny"] * n, "traffic": ["High"] * n,
            "driver_age": [float(v) for v in rng.uniform(20, 60, n)],
            "pickup_time": ["2026-10-17T09:30:00"] * n}


# ── the nine routes ───────────────────────────────────────────────────

def test_trace_route_follows_one_request(clients):
    jr, tr = _both(clients, "post", "/api/predict_eta_batch",
                   json=_rows_body(1, 5),
                   headers={"traceparent": TRACEPARENT})
    assert tr.status_code == 200
    trace_id = TRACEPARENT.split("-")[1]
    assert tr.headers["X-Trace-Id"] == jr.headers["X-Trace-Id"] == trace_id
    jt, tt = _both(clients, "get", f"/api/trace?trace_id={trace_id}")
    tspans = tt.get_json()["spans"]
    assert _scrub(tspans) == _scrub(jt.get_json()["spans"])
    names = [s["name"] for s in tspans]
    for name in ("replica.request", "replica.handler", "fastlane.predict",
                 "batcher.queue_wait", "batcher.flush", "batcher.pad",
                 "batcher.device_compute"):
        assert name in names
    assert {s["trace_id"] for s in tspans} == {trace_id}
    jc, tc = _both(clients, "get",
                   f"/api/trace?trace_id={trace_id}&format=chrome")
    assert _scrub(tc.get_json()) == _scrub(jc.get_json())
    jl, tl = _both(clients, "get", "/api/trace?limit=3")
    assert tl.get_json()["count"] == jl.get_json()["count"] == 3


def test_slo_route_matches(clients):
    for i in range(4):
        _both(clients, "post", "/api/predict_eta",
              json={"summary": {"distance": 1000 + i}})
    jr, tr = _both(clients, "get", "/api/slo")
    j, t = jr.get_json(), tr.get_json()
    # The store objective reads each package's process registry, whose
    # history differs between the two test processes' packages.
    assert "availability:store" in t["objectives"]
    for doc in (j, t):
        doc["objectives"].pop("availability:store")
    assert _scrub(t) == _scrub(j)


def test_efficiency_route_matches(clients):
    _both(clients, "post", "/api/predict_eta_batch",
          json=_rows_body(2, 40))
    jr, tr = _both(clients, "get", "/api/efficiency")
    j, t = jr.get_json(), tr.get_json()
    assert t["ledger"]["identity"]["backend"] == "cpu"
    # eta_score only: the process ledger also hears other modules' apps
    # (a re-optimization pass, a golden batch) if any still run
    assert _scrub(t["ledger"]["programs"]["eta_score"]) == \
        _scrub(j["ledger"]["programs"]["eta_score"])
    assert (t["enabled"], t["watchdog"]) == (j["enabled"], j["watchdog"])
    eta = t["ledger"]["programs"]["eta_score"]
    assert eta["rows"] > 0 and eta["padded_rows"] >= eta["rows"]
    assert t["watchdog"]["status"] == "no_artifact"
    jh, th = _both(clients, "get", "/api/health")
    assert th.get_json()["checks"]["engine"]["efficiency"] == \
        jh.get_json()["checks"]["engine"]["efficiency"] == {
            "ledger": True, "watchdog": "degraded",
            "status": "no_artifact", "pages": 0}


def test_changes_route_matches(clients):
    now = time.time()
    # A version label of their own keeps these events apart from any a
    # background thread of another module's app records meanwhile.
    for led in (jledger, tledger):
        led.record_change("model.swap", version="obs", ts=now - 20,
                          detail={"generation": 7})
        led.record_change("live.flip", version="obs", ts=now - 10,
                          detail={"epoch": 2})
        led.record_change("model.road_swap", replica="elsewhere",
                          version="obs", ts=now - 5)
    for query in ("", "&kind=model", "&replica=elsewhere", "&limit=1",
                  f"&since={now - 15}", "&limit=bad"):
        jr, tr = _both(clients, "get", "/api/changes?version=obs" + query)
        j, t = jr.get_json(), tr.get_json()
        for doc in (j, t):
            for e in doc["events"]:
                e.pop("id")
            doc.pop("ledger")
        assert t == j and t["count"] >= 1


def test_snapshot_and_incidents_match(clients, apps):
    jr, tr = _both(clients, "post", "/api/debug/snapshot")
    j, t = jr.get_json(), tr.get_json()
    for doc in (j, t):
        assert os.path.isdir(doc.pop("bundle"))
    assert (t["recorder"]["enabled"], t["recorder"]["requests_buffered"]) \
        == (j["recorder"]["enabled"], j["recorder"]["requests_buffered"])
    ji, ti = _both(clients, "get", "/api/incidents")
    j, t = ji.get_json(), ti.get_json()
    assert t["enabled"] == j["enabled"]
    manual = []
    for doc in (j, t):
        # this test's bundle (another module's app may page meanwhile)
        incs = [i for i in doc["incidents"] if i["reason"] == "manual_api"]
        for inc in incs:
            inc.pop("bundle")
            for s in inc["suspects"]:
                for key in ("age_s", "proximity", "score"):
                    s.pop(key)
                s["event"].pop("id")
        manual.append(incs)
    assert _scrub(manual[1]) == _scrub(manual[0]) and manual[1]


def test_timeline_route_matches(clients, apps):
    t0 = (int(time.time()) // 10 + 10) * 10.0
    for app in apps:
        app.timeline.tick(t0)
    for i in range(3):
        _both(clients, "post", "/api/predict_eta",
              json={"summary": {"distance": 2000 + i}})
    for app in apps:
        app.timeline.tick(t0 + 10.0)
    jr, tr = _both(clients, "get",
                   "/api/timeline?family=request_duration&window=600")
    j, t = jr.get_json(), tr.get_json()

    def counts(doc):
        # Latency buckets, sums and percentiles are each app's measured
        # seconds; the counts per route are what both apps observed.
        return [{name: [(s["labels"], s["count"]) for s in fam["series"]]
                 for name, fam in f["families"].items()}
                for f in doc["frames"]] + [doc["step_s"], doc["slots"],
                                           doc["watcher"]]
    assert counts(t) == counts(j)
    assert [f["t"] for f in t["frames"]] == [f["t"] for f in j["frames"]]
    frames = t["frames"]
    assert frames and "request_duration_seconds" in frames[-1]["families"]
    jd, td = _both(clients, "get", "/api/timeline?family=nothing&step=60")
    assert _scrub(td.get_json()) == _scrub(jd.get_json())


def test_debug_profile_matches(clients):
    bad = _both(clients, "post", "/api/debug/profile",
                json={"duration_s": "long"})
    assert bad[1].status_code == 400 and \
        bad[1].get_json() == bad[0].get_json()
    jr, tr = _both(clients, "post", "/api/debug/profile",
                   json={"duration_s": 0.05})
    assert tr.status_code == 202
    j, t = jr.get_json(), tr.get_json()
    assert t["profiler"].pop("device_trace_error") is None
    for doc in (j, t):
        doc["profiler"].pop("last_bundle")
    assert t == j
    _join_profiles()


def _small_routers():
    graph = generate_road_graph(n_nodes=64, seed=3)
    return (jrr.RoadRouter(graph=graph, use_gnn=False,
                           use_transformer=False),
            trr.RoadRouter(graph=graph, use_gnn=False,
                           use_transformer=False, device="cpu"))


def test_probe_subgraph_matches(clients, monkeypatch):
    # Another test file in this process may have built default routers.
    monkeypatch.setattr(jrr, "_default_router", None)
    monkeypatch.setattr(trr, "_default_routers", {})
    jr, tr = _both(clients, "get", "/api/debug/probe_subgraph")
    assert tr.status_code == 503 and tr.get_json() == jr.get_json()
    jrouter, trouter = _small_routers()
    monkeypatch.setattr(jrr, "_default_router", jrouter)
    monkeypatch.setitem(trr._default_routers, "cpu", trouter)
    wps = "wp=14.59,121.05&wp=14.6,121.06&wp=14.58,121.04"
    jr, tr = _both(clients, "get", f"/api/debug/probe_subgraph?{wps}")
    assert tr.status_code == 200 and tr.get_json() == jr.get_json()
    assert len(tr.get_json()["snapped"]) == 3
    jr, tr = _both(clients, "get", "/api/debug/probe_subgraph?wp=14.5")
    assert tr.status_code == 400 and tr.get_json() == jr.get_json()
    monkeypatch.setenv("RTPU_PROBER_SUBGRAPH_MAX_EDGES", "10")
    jr, tr = _both(clients, "get", "/api/debug/probe_subgraph")
    assert tr.status_code == 413 and tr.get_json() == jr.get_json()


# ── fault points on the serving path ──────────────────────────────────

@pytest.fixture
def chaos_spec():
    def arm(spec):
        jchaos.configure(jchaos.ChaosEngine(spec=spec, seed=0))
        tchaos.configure(tchaos.ChaosEngine(spec=spec, seed=0))
    yield arm
    jchaos.configure(None)
    tchaos.configure(None)


def test_device_compute_faults_answer_as_the_jax_app(clients, apps,
                                                     chaos_spec):
    chaos_spec("device.compute:error=1@2")
    # A faulted flush surfaces as the JAX app surfaces it: a 503 with
    # the same body on the batch route and on the single-row route.
    jr, tr = _both(clients, "post", "/api/predict_eta_batch",
                   json=_rows_body(100, 3))
    assert tr.status_code == 503
    assert tr.get_json() == jr.get_json() == {"error": "model unavailable"}
    jr, tr = _both(clients, "post", "/api/predict_eta",
                   json={"summary": {"distance": 4321}})
    assert tr.status_code == 503 and tr.get_json() == jr.get_json()
    answers = [_both(clients, "post", "/api/predict_eta_batch",
                     json=_rows_body(102, 3))]
    assert answers[0][1].status_code == 200
    # The third answer is the port's own fault-free scoring, bitwise.
    tapp = apps[1]
    tapp.eta._fastlane.invalidate()
    again = clients[1].post("/api/predict_eta_batch",
                            json=_rows_body(102, 3))
    assert again.get_json()["eta_minutes_ml"] == \
        answers[0][1].get_json()["eta_minutes_ml"]


def test_store_http_faults_journal_then_recover(clients, apps, chaos_spec):
    chaos_spec("store.http:error=1.0@3")
    body = {"source_point": {"lat": 14.5836, "lon": 121.0409},
            "destination_points": [{"lat": 14.55, "lon": 121.05,
                                    "payload": 1}],
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 9e9,
                               "maximum_distance": 9e9}}
    jr, tr = _both(clients, "post", "/api/optimize_route", json=body)
    jp, tp = jr.get_json()["properties"], tr.get_json()["properties"]
    assert (tp.get("saved"), tp.get("degraded")) == \
        (jp.get("saved"), jp.get("degraded")) == (True, True)
    # The breaker's cooldown ends (its clock moved on, not slept out).
    for app in apps:
        store = app.state.store if hasattr(app, "state") else app.store
        store._inner._open_until = time.monotonic()
    jh, th = _both(clients, "get", "/api/health")   # ping closes it
    tstore = th.get_json()["checks"]["store"]
    jstore = jh.get_json()["checks"]["supabase"]
    assert tstore["status"] == jstore["status"] == "ok"
    assert tstore["resilience"] == jstore["resilience"]
    jr, tr = _both(clients, "get", "/api/history?limit=100")
    titems, jitems = tr.get_json()["items"], jr.get_json()["items"]
    assert tp["request_id"] in [r["request_id"] for r in titems]  # replayed
    assert jp["request_id"] in [r["request_id"] for r in jitems]
    assert len(titems) == len(jitems)


def test_model_load_fault_degrades_as_the_jax_app(env, chaos_spec):
    chaos_spec("model.load:error=1.0@1")
    jcfg, tcfg = jload_config(), load_config()
    jsvc = JEtaService(jcfg.serve, model_path=ARTIFACT)
    tsvc = EtaService(tcfg.serve, model_path=ARTIFACT, device="cpu")
    japp = jax_create_app(jcfg, eta_service=jsvc, bus=JBus())
    tapp = create_app(tcfg, eta_service=tsvc, bus=InMemoryBus())
    try:
        jc, tc = Client(japp), Client(tapp)
        jr = jc.post("/api/predict_eta", json={"summary": {"distance": 900}})
        tr = tc.post("/api/predict_eta", json={"summary": {"distance": 900}})
        assert tr.status_code == jr.status_code == 503
        assert tr.get_json() == jr.get_json() == {
            "error": "model unavailable"}
        jm = jc.get("/api/health").get_json()["checks"]["model"]
        tm = tc.get("/api/health").get_json()["checks"]["model"]
        assert (tm["status"], tm["error"]) == (jm["status"], jm["error"])
        assert tm["error"].startswith("chaos injected at model.load")
    finally:
        _close(japp)
        tapp.close()


def test_request_records_reach_the_recorder(clients):
    before = trecorder.get_recorder().snapshot()["requests_buffered"]
    clients[1].get("/api/ping", headers={"X-RTPU-Probe": "eta"})
    recs = trecorder.get_recorder().requests_snapshot()
    assert len(recs) == min(before + 1, 512)
    assert recs[-1]["path"] == "/api/ping" and recs[-1]["probe"] == "eta"
    assert recs[-1]["trace_id"]
    metrics = clients[1].get("/api/metrics").get_json()
    assert "GET /api/ping" not in metrics["http"]["routes"] or \
        metrics["http"]["routes"]["GET /api/ping"]["count"] == 0
    probe = metrics["registry"]["rtpu_probe_replica_requests_total"]
    assert any(s["labels"]["route"] == "GET /api/ping"
               for s in probe["series"])
    assert json.dumps(metrics)   # serializable
