"""Dispatch over HTTP, the dispatcher's pages and the ops routes: the
port's app (``serve/app.py``, route optimization and dispatch on the
CPU) against the JAX app, both on their default config (dispatch on).

``POST /api/dispatch`` in matrix, geographic and ``complete`` modes,
its validation, ``GET /api/dispatch`` (``created_unix`` masked), and
``POST /api/confirm_route``'s registration give the same status codes
and the same JSON — in geographic mode up to the float32 haversine
class, as for the optimize endpoints: the port's great-circle matrix is
torch's ``sin``/``cos``, not XLA's, and differs in the last bit of some
entries, so ``cost``, ``baseline_cost`` and ``penalty`` (seconds summed
from that matrix) agree within 1e-6 of the route's cost plus the 0.001
rounding step, while every plan's stops, trips and lanes are equal;
``RTPU_DISPATCH=0`` gives the same 503 and
``{"enabled": false}``. The pages and ``lib`` scripts are the same bytes
under the same content types, ``/up`` answers, ``/api/version`` has the
same keys with only the runtime label differing (``torch`` for ``jax``),
and ``/api/metrics`` has the same structure, route names and
``routest_http_*`` Prometheus families after the same requests."""

import re
import threading
import time

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.config import load_dispatch_config as jload_dispatch
from routest_tpu.data.locations import SEED_LOCATIONS as SEED
from routest_tpu.optimize import vrp as jvrp
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.core.config import load_dispatch_config
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.bus import InMemoryBus
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8,)
TICKS = (0.001, 0.002)


@pytest.fixture(scope="module")
def services():
    return (JEtaService(JServeConfig(batch_buckets=BUCKETS),
                        model_path=ARTIFACT),
            EtaService(ServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT, device="cpu"))


def _apps(services, jconfig=None, tconfig=None):
    jsvc, tsvc = services
    japp = jax_create_app(jconfig or JConfig(), eta_service=jsvc, bus=JBus(),
                          sim_tick_range=TICKS)
    tapp = create_app(tconfig or Config(serve=ServeConfig(device="cpu")),
                      eta_service=tsvc, bus=InMemoryBus(),
                      sim_tick_range=TICKS)
    return japp, tapp


@pytest.fixture(scope="module")
def apps(services):
    japp, tapp = _apps(services)
    yield japp, tapp
    for app in (japp, tapp):
        if app.dispatch.reopt is not None:
            app.dispatch.reopt.stop()


@pytest.fixture(scope="module")
def clients(apps):
    return tuple(Client(a) for a in apps)


def _both(clients, method, path, **kw):
    jr = getattr(clients[0], method)(path, **kw)
    tr = getattr(clients[1], method)(path, **kw)
    assert tr.status_code == jr.status_code, (path, tr.get_data())
    return jr, tr


_FLOAT_KEYS = ("cost", "baseline_cost", "penalty")


def _same(got, want, scale=None, path=""):
    """Equal JSON trees; with ``scale`` (a geographic answer's cost), the
    float fields summed from the haversine matrix within ``1e-6 *
    scale`` plus the 0.001 rounding step."""
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], scale, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, scale, f"{path}[{i}]")
    elif scale is not None and key in _FLOAT_KEYS:
        assert abs(got - want) <= 1e-3 + 1e-6 * scale, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _matrix(n, seed=0, scale=60.0):
    rng = np.random.default_rng(seed)
    pts = rng.random((n + 1, 2)) * scale
    m = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    return np.round(m, 3).astype(np.float32)


def _pt(i, payload=1):
    return {"lat": SEED[i][1], "lon": SEED[i][2], "payload": payload}


def _geo(n, start=1, capacity=10, max_distance=300_000, driver="dina",
         **extra):
    body = {"source_point": {"lat": SEED[0][1], "lon": SEED[0][2]},
            "destination_points": [_pt(1 + (start - 1 + i) % 20,
                                       payload=1 + i % 3)
                                   for i in range(n)],
            "driver_details": {"driver_name": driver, "vehicle_type": "car",
                               "vehicle_capacity": capacity,
                               "maximum_distance": max_distance}}
    body.update(extra)
    return body


def _mx(n, seed, **extra):
    m = _matrix(n, seed=seed)
    rng = np.random.default_rng(seed)
    body = {"matrix": m.tolist(),
            "demands": rng.integers(1, 4, n).astype(float).tolist(),
            "capacity": 6.0, "max_distance": 150.0}
    body.update(extra)
    return body


_DIAG = _matrix(5, seed=8)
_DIAG[np.diag_indices(6)] = 3.0

DISPATCH_BODIES = {
    "matrix_6": _mx(6, 4),
    "matrix_12_windows": _mx(12, 5, time_windows=[
        [0, None] if i % 3 else [10 * i, 10 * i + 40] for i in range(12)]),
    "matrix_integer_ties": {"matrix": np.round(_matrix(9, seed=6) / 10)
                            .tolist(), "demands": [1] * 9, "capacity": 4,
                            "max_distance": 20},
    "matrix_nonzero_diagonal": {"matrix": _DIAG.tolist(),
                                "demands": [1, 2, 9, 1, 2], "capacity": 5,
                                "max_distance": 120},
    "matrix_defaults": {"matrix": [[0, 1, 2], [1, 0, 3], [2, 3, 0]],
                        "demands": [None, 2]},
    "geo_3": _geo(3),
    "geo_10_capacity": _geo(10, capacity=4),
    "geo_20_windows": _geo(20, start=1, capacity=8, time_windows=[
        [0, None] if i % 4 else [0, 600 + 60 * i] for i in range(20)]),
    "geo_8_short_budget": _geo(8, start=5, max_distance=15_000),
    "geo_4_late_window": _geo(4, time_windows=[[0, None]] * 3 + [[0, 1.0]]),
    "geo_motorcycle": dict(_geo(5, start=9), driver_details={
        "driver_name": "m", "vehicle_type": "motorcycle",
        "vehicle_capacity": 3, "maximum_distance": 40_000}),
}

INVALID_BODIES = {
    "nan_capacity": {"matrix": [[0, 1], [1, 0]], "demands": [1],
                     "capacity": float("nan")},
    "one_row": {"matrix": [[0]], "demands": []},
    "ragged": {"matrix": [[0, 1], [1]], "demands": [1]},
    "not_numeric": {"matrix": [[0, "a"], [1, 0]], "demands": [1]},
    "demands_length": {"matrix": [[0, 1], [1, 0]], "demands": [1, 2]},
    "demand_text": {"matrix": [[0, 1], [1, 0]], "demands": ["x"]},
    "too_many_stops": {"matrix": np.zeros((34, 34)).tolist(),
                       "demands": [1] * 33},
    "windows_length": _geo(4, time_windows=[[0, None]] * 3),
    "window_shape": _mx(2, 1, time_windows=[[0], [0, 5]]),
    "window_text": _mx(2, 1, time_windows=[[0, "late"], [0, 5]]),
    "window_inf": _mx(2, 1, time_windows=[[0, float("inf")], [0, 5]]),
    "complete_not_id": {"complete": 7},
    "complete_missing": {"complete": "missing"},
    "seed_not_int": dict(_geo(2), sim_seed="7"),
    "geo_no_destinations": {"source_point": {"lat": 14.5, "lon": 121.0}},
    "geo_bad_point": dict(_geo(2), destination_points=[{"lat": "x"}]),
    "geo_too_many": _geo(33),
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(DISPATCH_BODIES))
def test_dispatch_answers_match(clients, name):
    jr, tr = _both(clients, "post", "/api/dispatch",
                   json=DISPATCH_BODIES[name])
    assert tr.status_code == 200, tr.get_data()
    out, want = tr.get_json(), jr.get_json()
    if name.startswith("matrix"):
        assert out == want
    else:
        _same(out, want, want["cost"])
    assert out["epoch"] == 0
    assert out["mode"] == ("matrix" if name.startswith("matrix")
                           else "geographic")


def test_geographic_window_spills(clients):
    _, tr = _both(clients, "post", "/api/dispatch",
                  json=DISPATCH_BODIES["geo_4_late_window"])
    plan = tr.get_json()["plan"]
    assert plan["spill_lane"] == [3] and plan["penalty"] > 0
    assert sorted(plan["optimized_order"]) == [0, 1, 2]


def test_matrix_plan_is_the_solvers(clients):
    body = DISPATCH_BODIES["matrix_nonzero_diagonal"]
    _, tr = _both(clients, "post", "/api/dispatch", json=body)
    assert tr.get_json()["plan"] == jvrp.solve_host_dispatch(
        _DIAG, np.asarray(body["demands"], np.float32), 5.0, 120.0)


@pytest.mark.parametrize("name", sorted(INVALID_BODIES))
def test_invalid_dispatch_bodies_match(clients, name):
    jr, tr = _both(clients, "post", "/api/dispatch",
                   json=INVALID_BODIES[name])
    assert tr.status_code in (400, 404)
    assert tr.get_json() == jr.get_json()


def test_malformed_json_matches(clients):
    jr, tr = _both(clients, "post", "/api/dispatch", data=b"{not json",
                   content_type="application/json")
    assert tr.status_code == 400 and tr.get_json() == jr.get_json()


def _wait_armed(apps):
    """Both reopt threads have made their first (arming) tick."""
    t0 = time.monotonic()
    while any(a.dispatch.reopt.snapshot()["last_epoch"] is None
              for a in apps):
        assert time.monotonic() - t0 < 30, "reopt loop never ticked"
        time.sleep(0.05)


def _masked_state(client):
    out = client.get("/api/dispatch").get_json()
    for d in out["registry"]["dispatches"]:
        d.pop("created_unix")
    return out


def test_confirm_complete_and_state_match(apps, clients):
    _wait_armed(apps)
    body = _geo(6, start=3, capacity=4, confirm=True, sim_seed=11)
    jr, tr = _both(clients, "post", "/api/dispatch", json=body)
    _same(tr.get_json(), jr.get_json(), jr.get_json()["cost"])
    out = tr.get_json()
    did = out["dispatch_id"]
    assert out["channel"] == "dina"
    rec = apps[1].dispatch.registry.get(did)
    assert rec.sim_seed == 11 and rec.source == "dispatch"
    assert rec.driver_details["speed_mps"] == \
        apps[0].dispatch.registry.get(did).driver_details["speed_mps"]
    anon = _both(clients, "post", "/api/dispatch",
                 json=_mx(4, 2, confirm=True))[1].get_json()
    assert anon["channel"] == anon["dispatch_id"]
    _same(_masked_state(clients[1]), _masked_state(clients[0]),
          out["cost"])
    snap = _masked_state(clients[1])
    assert snap["enabled"] and snap["registry"]["active"] >= 2
    assert {"reopt", "batcher", "registry", "epoch"} <= set(snap)
    for done in (did, anon["dispatch_id"]):
        jr, tr = _both(clients, "post", "/api/dispatch",
                       json={"complete": done})
        assert tr.status_code == 200
        assert tr.get_json() == jr.get_json() == {
            "status": "completed", "dispatch_id": done}
    jr, tr = _both(clients, "post", "/api/dispatch", json={"complete": did})
    assert tr.status_code == 404 and tr.get_json() == jr.get_json()
    _same(_masked_state(clients[1]), _masked_state(clients[0]), out["cost"])


def _confirm_body(dests, driver="marco", coords=None, **extra):
    if coords is None:
        coords = [[SEED[0][2], SEED[0][1]]] \
            + [[d["lon"], d["lat"]] for d in dests if "lon" in d] \
            + [[SEED[0][2], SEED[0][1]]]
    body = {"route_details": {
        "geometry": {"coordinates": coords},
        "properties": {"summary": {"duration": 900, "distance": 8000,
                                   "trips": 1},
                       "destinations": dests}},
        "driver_details": {"driver_name": driver,
                           "vehicle_type": "motorcycle",
                           "vehicle_capacity": 10,
                           "maximum_distance": 50_000}}
    body.update(extra)
    return body


CONFIRM_BODIES = {
    "latlon_seeded": _confirm_body([_pt(i) for i in (1, 2, 3)],
                                   sim_seed=7),
    "latlon_unseeded": _confirm_body([_pt(i) for i in (4, 5)],
                                     driver="unseeded"),
    "no_latlon": _confirm_body([{"label": "x"}], driver="nolat",
                               coords=[[121.0, 14.6], [121.1, 14.7]]),
    "empty_destinations": _confirm_body([], driver="empty",
                                        coords=[[121.0, 14.6]]),
    "infinite_capacity": dict(_confirm_body([_pt(6)], driver="inf"),
                              driver_details={
                                  "driver_name": "inf",
                                  "vehicle_type": "car",
                                  "vehicle_capacity": "Infinity"}),
    "bad_payload": _confirm_body([dict(_pt(7), payload="heavy")],
                                 driver="bad"),
}


@pytest.mark.parametrize("name", sorted(CONFIRM_BODIES))
def test_confirm_route_registration_matches(apps, clients, name):
    jr, tr = _both(clients, "post", "/api/confirm_route",
                   json=CONFIRM_BODIES[name])
    assert tr.status_code == 200
    assert tr.get_json() == jr.get_json()
    out = tr.get_json()
    assert out["status"] == "route simulation initialized."
    if name.startswith("latlon"):
        recs = [a.dispatch.registry.get(out["dispatch_id"]) for a in apps]
        assert recs[1].source == "confirm_route"
        assert recs[1].plan["trips"] == \
            [list(range(len(recs[1].demands)))]
        assert abs(recs[1].baseline_cost - recs[0].baseline_cost) <= \
            1e-6 * recs[0].baseline_cost
        assert recs[1].sim_seed == recs[0].sim_seed
    else:
        assert "dispatch_id" not in out


def test_concurrent_matrix_requests_merge_and_match(services):
    """16 concurrent matrix-mode requests through one app: every plan is
    the JAX package's solve of its body, and the batcher counts them."""
    _, tapp = _apps(services)
    bodies = [_mx(3 + i % 9, 40 + i) for i in range(16)]
    out = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def worker(i):
        barrier.wait()
        out[i] = Client(tapp).post("/api/dispatch", json=bodies[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tapp.dispatch.reopt.stop()
    for r, body in zip(out, bodies):
        assert r.status_code == 200
        assert r.get_json()["plan"] == jvrp.solve_host_dispatch(
            np.asarray(body["matrix"], np.float32),
            np.asarray(body["demands"], np.float32), 6.0, 150.0)
    st = Client(tapp).get("/api/dispatch").get_json()["batcher"]
    assert st["requests"] == st["rows"] == 16
    assert st["dispatches"] + st["merged_requests"] >= 16


def test_dispatch_disabled_matches(services):
    env = {"RTPU_DISPATCH": "0"}
    japp, tapp = _apps(services, JConfig(dispatch=jload_dispatch(env)),
                       Config(serve=ServeConfig(device="cpu"),
                              dispatch=load_dispatch_config(env)))
    assert japp.dispatch is None and tapp.dispatch is None
    clients = (Client(japp), Client(tapp))
    jr, tr = _both(clients, "post", "/api/dispatch",
                   json=DISPATCH_BODIES["matrix_6"])
    assert tr.status_code == 503 and tr.get_json() == jr.get_json()
    jr, tr = _both(clients, "get", "/api/dispatch")
    assert tr.get_json() == jr.get_json() == {"enabled": False}
    jr, tr = _both(clients, "post", "/api/confirm_route",
                   json=CONFIRM_BODIES["latlon_seeded"])
    assert tr.get_json() == jr.get_json() == {
        "status": "route simulation initialized."}


def test_dispatch_on_a_missing_card_raises(services, monkeypatch):
    """An app whose serving device is the card, where there is none:
    dispatch raises (a 500) instead of solving on the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    _, tapp = _apps(services, tconfig=Config())
    tapp.dispatch.reopt.stop()
    client = Client(tapp)
    for body in (DISPATCH_BODIES["matrix_6"], DISPATCH_BODIES["geo_3"]):
        r = client.post("/api/dispatch", json=body)
        assert r.status_code == 500
        assert "CUDA is not available" in r.get_json()["error"]


# ---------------------------------------------------------------------------
# pages and ops routes
# ---------------------------------------------------------------------------

PAGES = ("/", "/ui", "/health", "/lib/classify.js",
         "/lib/dashboard_logic.js", "/up")


@pytest.mark.parametrize("path", PAGES)
def test_pages_are_the_same_bytes(clients, path):
    jr, tr = _both(clients, "get", path)
    assert tr.status_code == 200
    assert tr.get_data() == jr.get_data()
    assert tr.headers["Content-Type"] == jr.headers["Content-Type"]


@pytest.mark.parametrize("path", ("/lib/missing.js", "/lib/classify",
                                  "/lib/..%2Fdashboard.html"))
def test_unknown_lib_is_404(clients, path):
    jr, tr = _both(clients, "get", path)
    assert tr.status_code == 404 and tr.get_json() == jr.get_json()


def test_up_answers_ok(clients):
    _, tr = _both(clients, "get", "/up")
    assert tr.get_data() == b"OK"


def _keys(d):
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return type(d).__name__ if d is not None else None


def test_version_keys_match(services, clients, monkeypatch):
    monkeypatch.setenv("RTPU_VERSION", "v-test")
    jr, tr = _both(clients, "get", "/api/version")
    jv, tv = jr.get_json(), tr.get_json()
    assert tv["version_label"] == jv["version_label"] == "v-test"
    assert set(tv["model"]) == set(jv["model"])
    for key in ("available", "fingerprint", "path", "quantiles"):
        assert tv["model"][key] == jv["model"][key], key
    # The generation is a process-wide serial: each package's counts the
    # services that package built earlier in this process (other test
    # files included), so each app must report its own live one.
    for svc, v in zip(services, (jv, tv)):
        assert v["model"]["generation"] == svc.generation >= 0
    jb, tb = jv["build"], tv["build"]
    assert set(jb) - {"jax"} == set(tb) - {"torch"} == {"version",
                                                        "git_sha"}
    assert tb["git_sha"] == jb["git_sha"]
    import torch

    assert tb["torch"] == torch.__version__


REQUESTS = (("get", "/api/ping"), ("get", "/up"), ("get", "/"),
            ("get", "/lib/classify.js"), ("get", "/lib/nope.js"),
            ("post", "/api/dispatch"), ("get", "/api/dispatch"),
            ("get", "/api/locations"), ("get", "/no/such/route"))


def test_metrics_structure_and_routes_match(services):
    japp, tapp = _apps(services)
    clients = (Client(japp), Client(tapp))
    try:
        for method, path in REQUESTS:
            kw = {"json": DISPATCH_BODIES["matrix_6"]} \
                if method == "post" else {}
            _both(clients, method, path, **kw)
        jr, tr = _both(clients, "get", "/api/metrics")
        jm, tm = jr.get_json(), tr.get_json()
        assert set(tm) == set(jm) == {"http", "batcher", "registry"}
        assert set(tm["http"]) == set(jm["http"])
        assert _keys(tm["http"]["routes"]) == _keys(jm["http"]["routes"])
        assert sorted(tm["http"]["routes"]) == sorted(jm["http"]["routes"])
        for route, s in tm["http"]["routes"].items():
            assert s["count"] == jm["http"]["routes"][route]["count"], route
            assert s["errors"] == 0
        assert set(tm["batcher"]) == set(jm["batcher"])
        fams = {"rtpu_dispatch_requests_total", "rtpu_build_info",
                "rtpu_dispatch_batch_dispatches_total",
                "rtpu_process_start_time_seconds"}
        assert fams <= set(tm["registry"]) and fams <= set(jm["registry"])
        jr, tr = _both(clients, "get", "/api/metrics?format=prometheus")
        assert tr.headers["Content-Type"] == jr.headers["Content-Type"]
        jt, tt = jr.get_data(as_text=True), tr.get_data(as_text=True)

        def families(text):
            return (sorted(set(re.findall(r"^# TYPE (routest_\w+)", text,
                                          re.M))),
                    sorted(set(re.findall(r'^routest_http_route_count'
                                          r'\{route="([^"]+)"\}', text,
                                          re.M))))

        assert families(tt) == families(jt)
        assert "routest_http_route_count" in families(tt)[0]
        assert re.search(r'^rtpu_build_info\{version="[^"]+",torch="',
                         tt, re.M)
    finally:
        for app in (japp, tapp):
            app.dispatch.reopt.stop()
