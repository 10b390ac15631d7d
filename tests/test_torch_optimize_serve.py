"""The optimize slice as a whole: the port's app (``serve/app.py``, the
port on the CPU) against the JAX app on the same request bodies.

Status codes, keys and error strings are equal. Features are compared as
in ``tests/test_torch_engine.py`` (distances/durations within rtol 1e-6
or 0.1, the ``engine`` tag), plus ``request_id`` (a fresh uuid on each
side). With ``use_ml_eta`` the clock is pinned in both app and service
modules, and the ETA fields are held to the bf16 class (rtol 2e-2 /
atol 0.5), completion times within one second plus that class. The
history routes read back what was saved, on both sides; health, the
store factory, the ``ROUTEST_AUTH=require`` boot and the query-string
parser are checked on the port alone."""

import datetime as dt
import types

import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.data.locations import SEED_LOCATIONS as SEED
from routest_tpu.serve import app as japp_mod
from routest_tpu.serve import ml_service as jml
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig, load_config
from routest_tpu_torch.serve import app as tapp_mod
from routest_tpu_torch.serve import ml_service as tml
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.store import InMemoryStore, make_store
from routest_tpu_torch.serve.wsgi import Request

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8, 64)
BF16 = (2e-2, 0.5)


class _PinnedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 14, 8, 45, 0)


@pytest.fixture
def pinned_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=_PinnedClock,
                                  timedelta=dt.timedelta,
                                  timezone=dt.timezone)
    for module in (japp_mod, jml, tapp_mod, tml):
        monkeypatch.setattr(module, "dt", clock)


@pytest.fixture(scope="module")
def clients():
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    tconfig = Config(serve=ServeConfig(device="cpu"))
    return (Client(jax_create_app(JConfig(), eta_service=jsvc)),
            Client(create_app(tconfig, eta_service=tsvc)))


def _close(got, want, tol, what):
    assert abs(got - want) <= tol[1] + tol[0] * abs(want), (what, got, want)


def _same(got, want, path=""):
    """Equal JSON trees, except rounded distances/durations, the engine
    tag, fresh request ids, and ETA fields (bf16 class)."""
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
    elif isinstance(want, float) and (key in ("distance", "duration",
                                              "total_distance",
                                              "total_duration")
                                      or "_m[" in path or "_s[" in path):
        assert abs(got - want) <= max(0.1 + 1e-9, 1e-6 * abs(want)), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def _pt(i, payload=1):
    name, lat, lon = SEED[i]
    return {"lat": lat, "lon": lon, "payload": payload, "name": name}


def _req(n_dests=3, start=1, **extra):
    driver = {"driver_name": "Kai", "vehicle_type": "car",
              "vehicle_capacity": 9999, "maximum_distance": 100_000.0,
              "driver_age": 37}
    driver.update(extra.pop("driver", {}))
    body = {"source_point": {"lat": SEED[0][1], "lon": SEED[0][2]},
            "destination_points": [_pt(i + start) for i in range(n_dests)],
            "driver_details": driver,
            "meta": {"origin_id": "o-1", "destination_ids": [
                f"d-{i}" for i in range(n_dests)]}}
    body.update(extra)
    return body


ML = {"use_ml_eta": True, "context": {"weather": "Stormy",
                                      "traffic": "High"}}

ROUTE_BODIES = {
    "stops1": _req(1),
    "stops3": _req(3),
    "stops10": _req(10),
    "stops10_refine": _req(10, refine=True),
    "stops10_topk5": _req(10, top_k=5),
    "capacity_splits": _req(6, driver={"vehicle_capacity": 2}),
    "ml_stops1": _req(1, **ML),
    "ml_stops3": _req(3, **ML),
    "ml_stops10": _req(10, **ML),
    "ml_stops10_topk5_refine": _req(10, top_k=5, refine=True, **ML),
    "ml_no_context": _req(4, use_ml_eta=True),
    "ml_bad_context": _req(4, use_ml_eta=True, context="x",
                           driver={"driver_age": "old"}),
    "empty": {},
    "no_source": {"destination_points": [{"lat": 14.5, "lon": 121.0}]},
    "unroutable": _req(3, driver={"vehicle_capacity": 0}),
    "p2p_range": _req(1, driver={"maximum_distance": 1.0}),
    "bad_payload": _req(2, destination_points=[{"lat": 1, "lon": 1,
                                                "payload": "x"}]),
    "top_k_text": _req(3, top_k="many"),
}


@pytest.mark.parametrize("path", ["/api/optimize_route", "/api/request_route"])
@pytest.mark.parametrize("name", sorted(ROUTE_BODIES))
def test_route_endpoints_match(clients, pinned_clock, path, name):
    jclient, tclient = clients
    body = ROUTE_BODIES[name]
    jr, tr = jclient.post(path, json=body), tclient.post(path, json=body)
    assert tr.status_code == jr.status_code, (tr.get_json(), jr.get_json())
    got, want = tr.get_json(), jr.get_json()
    _same(got, want)
    if path == "/api/optimize_route" and tr.status_code == 200:
        props = got["properties"]
        assert props["saved"] is True and props["request_id"]
        if body.get("use_ml_eta"):
            assert (props["eta_minutes_ml_p10"] <= props["eta_minutes_ml"]
                    <= props["eta_minutes_ml_p90"])


@pytest.mark.parametrize("raw", [b"{not json", b"[1, 2]", b""])
@pytest.mark.parametrize("path", ["/api/optimize_route",
                                  "/api/optimize_route_batch", "/api/matrix"])
def test_malformed_bodies_match(clients, path, raw):
    jclient, tclient = clients
    kw = dict(data=raw, content_type="application/json")
    jr, tr = jclient.post(path, **kw), tclient.post(path, **kw)
    assert (tr.status_code, tr.get_json()) == (jr.status_code, jr.get_json())


BATCH_BODIES = {
    "mixed": {"items": [_req(3), _req(1), _req(7),
                        _req(5, driver={"vehicle_capacity": 2}),
                        _req(3, top_k=3), {"bogus": True},
                        _req(3, road_graph=True, top_k=2)]},
    "mixed_ml": {"items": [_req(3), _req(1), _req(7),
                           _req(2, driver={"driver_age": 61}),
                           {"bogus": True}], **ML},
    "ml_default_context": {"items": [_req(4), _req(6)],
                           "use_ml_eta": True},
    "empty_items": {"items": []},
    "items_not_list": {"items": "x"},
    "no_items": {"use_ml_eta": True},
    "item_not_object": {"items": [_req(2), 3]},
    "too_large": {"items": [{}] * 257},
}


@pytest.mark.parametrize("name", sorted(BATCH_BODIES))
def test_batch_endpoint_matches(clients, pinned_clock, name):
    """Batches of at most 8 points, where the JAX batch's matrices agree
    with its single path (see tests/test_torch_engine.py)."""
    jclient, tclient = clients
    body = BATCH_BODIES[name]
    path = "/api/optimize_route_batch"
    jr, tr = jclient.post(path, json=body), tclient.post(path, json=body)
    assert tr.status_code == jr.status_code, (tr.get_json(), jr.get_json())
    _same(tr.get_json(), jr.get_json())


def test_batch_endpoint_10_stops_with_ml_eta(clients, pinned_clock):
    """Ten-stop items (the JAX batch's matrices are off by up to ~1 m
    there, so only the port's own invariants and the ETA of each route
    against the single endpoint's scoring are checked)."""
    _, tclient = clients
    items = [_req(10, start=1 + (i % 11)) for i in range(16)]
    out = tclient.post("/api/optimize_route_batch",
                       json={"items": items, **ML}).get_json()
    assert out["count"] == 16
    for item, feature in zip(items, out["items"]):
        single = tclient.post("/api/request_route", json=item).get_json()
        props = feature["properties"]
        assert props["optimized_order"] == \
            single["properties"]["optimized_order"]
        assert props["summary"] == single["properties"]["summary"]
        eta = tclient.post("/api/predict_eta", json={
            "summary": props["summary"], "driver_age": 37,
            **ML["context"]}).get_json()
        _close(props["eta_minutes_ml"], eta["eta_minutes_ml"], (1e-4, 1e-3),
               "eta")


MATRIX_BODIES = {
    "pair": {"points": [_pt(1), _pt(2)]},
    "subsets": {"points": [_pt(i) for i in range(9)], "sources": [1],
                "destinations": [0, 8]},
    "foot": {"points": [_pt(i) for i in range(4)], "vehicle_type": "foot"},
    "one_point": {"points": [_pt(1)]},
    "too_many": {"points": [_pt(1)] * 65},
    "bad_index": {"points": [_pt(1), _pt(2)], "sources": [5]},
}


@pytest.mark.parametrize("name", sorted(MATRIX_BODIES))
def test_matrix_endpoint_matches(clients, name):
    jclient, tclient = clients
    body = MATRIX_BODIES[name]
    jr = jclient.post("/api/matrix", json=body)
    tr = tclient.post("/api/matrix", json=body)
    assert tr.status_code == jr.status_code
    _same(tr.get_json(), jr.get_json())


def test_road_graph_endpoints_answer_400(clients):
    """``road_graph: true`` on both endpoints answers what the JAX app
    answers (street-network legs)."""
    jclient, tclient = clients
    for path, body in (("/api/optimize_route",
                        _req(3, road_graph=True,
                             pickup_time="2026-10-14T08:30:00")),
                       ("/api/matrix", {"points": [_pt(1), _pt(2)],
                                        "road_graph": True,
                                        "pickup_time": "2026-10-14T08:30:00"})):
        jr, tr = jclient.post(path, json=body), tclient.post(path, json=body)
        assert tr.status_code == jr.status_code == 200
        _same(tr.get_json(), jr.get_json())


def test_locations_match(clients):
    jclient, tclient = clients
    jr, tr = jclient.get("/api/locations"), tclient.get("/api/locations")
    assert (tr.status_code, tr.get_json()) == (jr.status_code, jr.get_json())


def _history_pair(jclient, tclient, query):
    jr = jclient.get(f"/api/history{query}")
    tr = tclient.get(f"/api/history{query}")
    assert tr.status_code == jr.status_code, query
    return tr.get_json(), jr.get_json()


def test_history_reads_back_what_was_saved(pinned_clock):
    """Fresh apps (own stores): save routes through both, then list,
    filter, read one, delete it."""
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    jclient = Client(jax_create_app(JConfig(), eta_service=jsvc))
    tclient = Client(create_app(Config(serve=ServeConfig(device="cpu")),
                                eta_service=tsvc))
    bodies = [_req(3), _req(10, **ML), _req(1), _req(5, **ML)]
    ids = {"j": [], "t": []}
    for body in bodies:
        for side, client in (("j", jclient), ("t", tclient)):
            out = client.post("/api/optimize_route", json=body).get_json()
            ids[side].append(out["properties"]["request_id"])
    for query in ("", "?limit=2", "?limit=abc", "?limit=0", "?limit=1000",
                  "?engine=ml", "?engine=default&limit=1", "?engine=x"):
        got, want = _history_pair(jclient, tclient, query)
        _same(got, want)
    got, _ = _history_pair(jclient, tclient, "?engine=ml")
    assert [it["request_id"] for it in got["items"]] == ids["t"][3:0:-2]
    assert got["items"][0]["eta_minutes_ml"] is not None

    for k in (1, 2):
        jr = jclient.get(f"/api/history/{ids['j'][k]}")
        tr = tclient.get(f"/api/history/{ids['t'][k]}")
        assert tr.status_code == jr.status_code == 200
        detail = tr.get_json()
        _same(_strip_ids(detail), _strip_ids(jr.get_json()))
        assert detail["request"]["id"] == ids["t"][k]
        assert detail["result"]["request_id"] == ids["t"][k]
        assert detail["request"]["stops"]["destination_points"] == \
            bodies[k]["destination_points"]

    for side, client in (("j", jclient), ("t", tclient)):
        assert client.delete(f"/api/history/{ids[side][0]}").status_code == 204
        r = client.get(f"/api/history/{ids[side][0]}")
        assert (r.status_code, r.get_json()) == (404, {"error": "not found"})
        r = client.delete(f"/api/history/{ids[side][0]}")
        assert (r.status_code, r.get_json()) == (404, {"error": "not found"})
    got, want = _history_pair(jclient, tclient, "")
    assert len(got["items"]) == len(want["items"]) == 3


def _strip_ids(detail):
    detail = {**detail, "request": dict(detail["request"]),
              "result": dict(detail["result"])}
    for part in ("request", "result"):
        for key in ("id", "request_id", "request_time", "created_at"):
            detail[part].pop(key, None)
    return detail


def test_health_reports_the_store(clients):
    _, tclient = clients
    body = tclient.get("/api/health").get_json()
    store = body["checks"]["store"]
    assert store["status"] == "ok" and store["backend"] == "memory"
    assert isinstance(store["latency_ms"], int)
    assert body["status"] == "ok"


def test_auth_required_refuses_to_boot(monkeypatch, clients):
    """Since auth is ported, ``ROUTEST_AUTH=require`` no longer refuses
    to boot: the app serves, and it gates the one destructive route."""
    monkeypatch.setenv("ROUTEST_AUTH", "require")
    tsvc = clients[1].application.eta
    app = create_app(Config(serve=ServeConfig(device="cpu")),
                     eta_service=tsvc, store=InMemoryStore())
    try:
        c = Client(app)
        assert app.auth.required
        assert c.delete("/api/history/x").status_code == 401
        token = c.post("/api/auth/register", json={
            "name": "A", "email": "a@example.com",
            "password": "s3cretpass"}).get_json()["token"]
        r = c.delete("/api/history/x",
                     headers={"Authorization": f"Bearer {token}"})
        assert r.status_code == 404
    finally:
        app.dispatch.reopt.stop()


def test_configured_supabase_is_refused(monkeypatch, clients):
    """Since the PostgREST store is ported, a configured Supabase
    backend is served (behind the resilience and timing wrappers), no
    longer refused; a URL without a key still means memory."""
    for url, key in ((None, None), ("https://x.supabase.co", None)):
        assert make_store(url, key).kind == "memory"
    store = make_store("https://x.supabase.co", "key")
    assert store.kind == "postgrest"
    assert type(store).__name__ == "TracedStore"
    assert type(store._inner).__name__ == "ResilientStore"
    monkeypatch.setenv("SUPABASE_URL", "https://x.supabase.co")
    monkeypatch.setenv("SUPABASE_SERVICE_ROLE_KEY", "key")
    monkeypatch.setenv("ROUTEST_DEVICE", "cpu")
    app = create_app(load_config(), eta_service=clients[1].application.eta)
    try:
        assert app.store.kind == "postgrest"
    finally:
        app.dispatch.reopt.stop()


@pytest.mark.parametrize("query,want", [
    ("", {}), ("limit=5", {"limit": "5"}),
    ("limit=5&limit=7&engine=ml", {"limit": "5", "engine": "ml"}),
    ("a=&b=x%20y", {"a": "", "b": "x y"})])
def test_request_args(query, want):
    assert Request({"QUERY_STRING": query}).args == want


def test_inmemory_store_matches_the_jax_store():
    from routest_tpu.serve.store import InMemoryStore as JStore

    rows = [{"origin_id": "o", "engine": e, "stops": {}} for e in
            ("ml", "default", "ml")]
    for store in (JStore(), InMemoryStore()):
        ids = [store.insert_request(dict(r)) for r in rows]
        store.insert_result({"request_id": ids[0], "total_distance": 1.0})
        with pytest.raises(KeyError, match="does not exist"):
            store.insert_result({"request_id": "nope"})
        assert [r["id"] for r in store.list_history(5, engine="ml")] == \
            [ids[2], ids[0]]
        assert store.get_request(ids[0])["route_results"][0][
            "total_distance"] == 1.0
        assert store.delete_request(ids[0]) and not store.delete_request(
            ids[0])
        assert store.get_request(ids[0]) is None
        assert store.ping() and store.kind == "memory"
