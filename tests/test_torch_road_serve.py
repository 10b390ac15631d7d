"""Street-network routing as a whole: the port's app (``serve/app.py``
with ``road_graph: true``, the port on the CPU) against the JAX app on
the same request bodies, both serving the default deployment (the
generated 2048-node Metro Manila graph, ``road_gnn.msgpack`` and
``route_transformer.msgpack``).

Status codes, keys, orders, trips, alternatives' orders, geometry (the
polylines' node coordinates), ``distance`` fields, matrix distances,
``leg_cost_model`` and error strings are equal. Durations (and the
matrix's ``durations_s``) are held to the f32 class plus the 0.1
rounding step: the GNN's ``index_add_`` and the transformer's einsums
sum in another order than XLA. ETA fields are held to the bf16 class as
in ``tests/test_torch_optimize_serve.py``; ``engine`` and
``request_id`` differ by construction."""

import datetime as dt
import types

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.data.locations import SEED_LOCATIONS as SEED
from routest_tpu.optimize import engine as jeng
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve import app as japp_mod
from routest_tpu.serve import ml_service as jml
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.optimize import engine as teng
from routest_tpu_torch.serve import app as tapp_mod
from routest_tpu_torch.serve import ml_service as tml
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8, 64)
F32 = (1e-4, 0.1 + 1e-9)
BF16 = (2e-2, 0.5)
PICKUP = "2026-10-14T08:30:00"


class _PinnedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 14, 8, 45, 0)


@pytest.fixture
def pinned_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=_PinnedClock,
                                  timedelta=dt.timedelta,
                                  timezone=dt.timezone)
    for module in (japp_mod, jml, jeng, tapp_mod, tml, teng):
        monkeypatch.setattr(module, "dt", clock)


@pytest.fixture(scope="module")
def clients():
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    return (Client(jax_create_app(JConfig(), eta_service=jsvc)),
            Client(create_app(Config(serve=ServeConfig(device="cpu")),
                              eta_service=tsvc)))


def _close(got, want, tol, what):
    assert abs(got - want) <= tol[1] + tol[0] * abs(want), (what, got, want)


def _same(got, want, path=""):
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif key == "engine" and str(want).startswith("backend:"):
        assert (want, got) == ("backend:jax-tpu", "backend:torch-cpu"), path
    elif key in ("request_id", "created_at"):
        assert isinstance(got, str) and got, path
    elif key.startswith("eta_minutes_ml") and want is not None:
        _close(got, want, BF16, path)
    elif key == "eta_completion_time_ml" and want is not None:
        slack = 1.0 + 60.0 * (BF16[1] + BF16[0] * 120.0)
        delta = (dt.datetime.fromisoformat(got)
                 - dt.datetime.fromisoformat(want)).total_seconds()
        assert abs(delta) <= slack, (path, got, want)
    elif want is not None and (key == "duration" or "durations_s[" in path):
        _close(got, want, F32, path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _pt(i, payload=1):
    name, lat, lon = SEED[i]
    return {"lat": lat, "lon": lon, "payload": payload, "name": name}


def _req(n_dests=3, start=1, **extra):
    driver = {"driver_name": "Kai", "vehicle_type": "car",
              "vehicle_capacity": 9999, "maximum_distance": 150_000.0,
              "driver_age": 37}
    driver.update(extra.pop("driver", {}))
    body = {"source_point": {"lat": SEED[0][1], "lon": SEED[0][2]},
            "destination_points": [_pt(1 + (start + 3 * j) % 20)
                                   for j in range(n_dests)],
            "driver_details": driver, "road_graph": True,
            "pickup_time": PICKUP,
            "meta": {"origin_id": "o-1", "destination_ids": [
                f"d-{i}" for i in range(n_dests)]}}
    body.update(extra)
    return body


ML = {"use_ml_eta": True, "context": {"weather": "Stormy", "traffic": "Jam"}}

ROUTE_BODIES = {
    "stops1": _req(1),
    "stops1_evening": _req(1, start=7, pickup_time="2026-10-14T18:10:00"),
    "stops3": _req(3, start=2),
    "stops10": _req(10),
    "stops10_late": _req(10, start=11),
    "stops10_refine": _req(10, start=4, refine=True,
                           driver={"vehicle_capacity": 4}),
    "stops10_topk5": _req(10, start=5, top_k=5),
    "stops4_topk5": _req(4, start=9, top_k=5),
    "stops10_ml": _req(10, start=6, **ML),
    "stops3_ml": _req(3, start=8, **ML),
    "stops6_truck": _req(6, start=3, driver={"vehicle_type": "truck"}),
    "stops5_bike_maxd": _req(5, start=12, driver={
        "vehicle_type": "bike", "maximum_distance": 20_000.0}),
    "no_pickup_time": {k: v for k, v in _req(3, start=13).items()
                       if k != "pickup_time"},
    # errors: validation still runs before the road flag
    "p2p_capacity": _req(1, driver={"vehicle_capacity": 0}),
    "p2p_range": _req(1, driver={"maximum_distance": 10.0}),
    "unroutable": _req(3, driver={"vehicle_capacity": 0}),
    "nan_capacity": _req(3, driver={"vehicle_capacity": float("nan")}),
    "bad_coordinates": _req(2, destination_points=[{"lat": "x",
                                                    "lon": 121.0}]),
    "top_k_text": _req(3, top_k="many"),
    "no_destinations": _req(0),
}


@pytest.mark.parametrize("path", ["/api/optimize_route", "/api/request_route"])
@pytest.mark.parametrize("name", sorted(ROUTE_BODIES))
def test_road_routes_match(clients, pinned_clock, path, name):
    jclient, tclient = clients
    body = ROUTE_BODIES[name]
    jr, tr = jclient.post(path, json=body), tclient.post(path, json=body)
    assert tr.status_code == jr.status_code, (tr.get_json(), jr.get_json())
    got, want = tr.get_json(), jr.get_json()
    _same(got, want)
    if tr.status_code == 200 and len(body["destination_points"]) > 1:
        assert got["properties"]["leg_cost_model"] == "transformer"
        assert got["properties"]["road_graph"] is True


def test_top_k_alternatives_are_directed(clients):
    """Road tours are directed: alternatives may include the reversal of
    the shipped order, and at 10 stops they fill the request."""
    _, tclient = clients
    out = tclient.post("/api/optimize_route",
                       json=ROUTE_BODIES["stops10_topk5"]).get_json()
    alts = out["properties"]["alternatives"]
    assert len(alts) == 5
    main = out["properties"]["optimized_order"]
    assert all(a["optimized_order"] != main for a in alts)


def _matrix(n, seed, **extra):
    rng = np.random.default_rng(seed)
    body = {"points": [{"lat": 14.40 + 0.26 * float(a),
                        "lon": 120.96 + 0.14 * float(b)}
                       for a, b in rng.random((n, 2))],
            "road_graph": True, "pickup_time": PICKUP}
    body.update(extra)
    return body


MATRIX_BODIES = {
    "64_points": _matrix(64, 0),
    "truck_17": _matrix(17, 1, vehicle_type="truck",
                        pickup_time="2026-10-14T23:00:00"),
    "subsets": _matrix(12, 2, sources=[3, 0], destinations=[11, 3, 3, 7]),
    "pair": {"points": [_pt(1), _pt(2)], "road_graph": True,
             "pickup_time": PICKUP},
    "too_many": _matrix(65, 3),
    "bad_index": _matrix(4, 4, destinations=[9]),
}


@pytest.mark.parametrize("name", sorted(MATRIX_BODIES))
def test_road_matrix_matches(clients, name):
    jclient, tclient = clients
    body = MATRIX_BODIES[name]
    jr = jclient.post("/api/matrix", json=body)
    tr = tclient.post("/api/matrix", json=body)
    assert tr.status_code == jr.status_code
    _same(tr.get_json(), jr.get_json())
    if tr.status_code == 200:
        assert tr.get_json()["leg_cost_model"] == "gnn"


BATCH_BODIES = {
    "road_mixed": {"items": [_req(3), _req(1, start=4), _req(10, start=2),
                             _req(5, start=6, refine=True,
                                  driver={"vehicle_capacity": 2}),
                             _req(4, start=1, road_graph=False),
                             _req(3, top_k=3), {"bogus": True},
                             _req(2, driver={"vehicle_capacity": 0}),
                             _req(3)]},
    "road_ml": {"items": [_req(10, start=s) for s in range(6)]
                + [_req(1, start=9)], **ML},
}


@pytest.mark.parametrize("name", sorted(BATCH_BODIES))
def test_road_batch_matches(clients, pinned_clock, name):
    jclient, tclient = clients
    body = BATCH_BODIES[name]
    path = "/api/optimize_route_batch"
    jr, tr = jclient.post(path, json=body), tclient.post(path, json=body)
    assert tr.status_code == jr.status_code == 200
    _same(tr.get_json(), jr.get_json())


def test_batch_road_items_equal_single_requests(clients):
    """Road items batch through shared solves; each equals the single
    endpoint's answer on the same body."""
    _, tclient = clients
    items = BATCH_BODIES["road_ml"]["items"]
    out = tclient.post("/api/optimize_route_batch",
                       json={"items": items}).get_json()
    for item, feature in zip(items, out["items"]):
        single = tclient.post("/api/request_route", json=item).get_json()
        assert feature == single


def test_router_failure_errors_only_road_items(monkeypatch):
    def broken(device=None):
        raise RuntimeError("no graph")

    monkeypatch.setattr(teng, "default_router", broken)
    monkeypatch.setattr(jrr, "default_router", broken)
    items = [_req(3), _req(3, road_graph=False), _req(1)]
    got = teng.optimize_route_batch(items, device="cpu")
    want = jeng.optimize_route_batch(items)
    assert got[0] == got[2] == want[0] == {
        "error": "road graph unavailable: RuntimeError: no graph"}
    assert got[1]["properties"]["optimized_order"] == \
        want[1]["properties"]["optimized_order"]


def test_health_road_router_block(clients):
    """Shown once a router is built, with the JAX block's keys and the
    same graph, pricers and solver."""
    jclient, tclient = clients
    for client in clients:
        assert client.post("/api/optimize_route",
                           json=_req(3)).status_code == 200
    want = jclient.get("/api/health").get_json()["checks"]["engine"]
    got = tclient.get("/api/health").get_json()["checks"]["engine"]
    jblock, tblock = want["road_router"], got["road_router"]
    assert set(tblock) == set(jblock)
    for key in ("nodes", "edges", "leg_cost_model", "transformer", "solver",
                "max_iters_bound"):
        assert tblock[key] == jblock[key], key
    assert tblock["leg_cost_model"] == "gnn" and tblock["transformer"]
    for key in ("batch", "route_cache"):
        assert set(tblock[key]) == set(jblock[key]), key
    assert tblock["route_cache"]["entries"] >= 1
