"""Persistence: the port's ``serve/store.py`` against the JAX package's.

- ``PostgRESTStore``: the same requests (method, URL with its
  ``select``/``order``/``limit``/``eq.`` query, the store's headers, the
  JSON body) reach a recording server from both packages, and both leave
  the same rows in one ``tests/fake_postgrest.py``; a route persisted by
  the port's app reads back through the JAX app's history and the other
  way round;
- ``_is_transient`` on ``urllib``'s errors (the port's backend raises
  them; an ``HTTPError`` is an ``OSError`` whose ``.code`` must win);
- ``ResilientStore`` against the JAX one on one scripted failure
  sequence (backoff 0): the same inner calls, returns, breaker state,
  journal depth, replay count and metric deltas;
- ``make_store``'s wrapping and its ``RTPU_STORE_*`` parsing, malformed
  values included;
- the port's app through a PostgREST outage: optimize keeps answering
  200, history degrades, and after the backend restarts the journal
  replays so every acknowledged write reads back.
"""

import json
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.obs import get_registry as jget_registry
from routest_tpu.serve import store as jstore
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.serve import store as tstore
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService
from tests.fake_postgrest import start_fake_postgrest

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8,)
KEY = "service-role-key"
STORE_ENV = ("RTPU_STORE_RETRIES", "RTPU_STORE_BACKOFF_MS",
             "RTPU_STORE_BREAKER_AFTER", "RTPU_STORE_COOLDOWN_S",
             "RTPU_STORE_JOURNAL")


def _stop(server):
    server.shutdown()
    server.server_close()


# ── PostgRESTStore: the requests themselves ──────────────────────────


class _Recorder(BaseHTTPRequestHandler):
    """Records each request; answers with ``server.reply`` (status,
    JSON-able body or None for an empty body)."""

    def log_message(self, *a):
        pass

    def _handle(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        self.server.seen.append({
            "method": self.command, "path": self.path, "body": body,
            "headers": {k: self.headers.get(k) for k in
                        ("apikey", "Authorization", "Content-Type",
                         "Prefer")}})
        status, payload = self.server.reply
        data = b"" if payload is None else json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    do_GET = do_POST = do_DELETE = _handle


@pytest.fixture()
def recorder():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    srv.daemon_threads = True
    srv.seen = []
    srv.reply = (200, [{"id": "r1"}])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    _stop(srv)
    t.join(5)


_ROW = {"origin_id": "wh-1", "stops": {"destination_ids": ["a", "b"]},
        "status": "completed", "engine": "ml", "vehicle_id": "Ana",
        "driver_age": 41, "eta_minutes_ml": None}

CALLS = [
    ("insert_request", (_ROW,), (201, [{"id": "r1"}])),
    ("insert_result", ({"request_id": "r1", "total_distance": 1.5,
                        "legs": [], "geometry": None},), (201, [{}])),
    ("list_history", (20,), (200, [])),
    ("list_history", (5, "ml"), (200, [])),
    ("get_request", ("r1",), (200, [{"id": "r1"}])),
    ("get_request", ("nope",), (200, [])),
    ("delete_request", ("r1",), (200, [{"id": "r1"}])),
    ("delete_request", ("r1",), (200, [])),
    ("delete_request", ("r1",), (204, None)),
    ("delete_request", ("r1",), (404, {"message": "x"})),
    ("delete_request", ("r1",), (500, {"message": "x"})),
    ("ping", (), (200, [])),
    ("ping", (), (503, {"message": "x"})),
]


@pytest.mark.parametrize("op,args,reply", CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CALLS)])
def test_postgrest_requests_and_answers_match(recorder, op, args, reply):
    srv, url = recorder
    srv.reply = reply
    got = []
    for mod in (jstore, tstore):
        st = mod.PostgRESTStore(url, KEY)
        got.append(getattr(st, op)(*args))
    assert got[0] == got[1]
    assert len(srv.seen) == 2
    jreq, treq = srv.seen
    assert treq == jreq
    if jreq["body"]:
        assert json.loads(treq["body"]) == args[0]


@pytest.mark.parametrize("op,args", [
    ("insert_request", (_ROW,)), ("list_history", (3,)),
    ("get_request", ("r1",))])
@pytest.mark.parametrize("status", [409, 503])
def test_postgrest_error_answers_raise_with_status(recorder, op, args,
                                                   status):
    srv, url = recorder
    srv.reply = (status, {"message": "x"})
    with pytest.raises(urllib.error.HTTPError) as info:
        getattr(tstore.PostgRESTStore(url, KEY), op)(*args)
    assert info.value.code == status
    assert tstore._is_transient(info.value) is (status >= 500)


def test_postgrest_dead_backend_is_transient_and_ping_counts_it():
    srv, _, url = start_fake_postgrest()
    _stop(srv)
    st = tstore.PostgRESTStore(url, KEY, timeout=2.0)
    with pytest.raises(OSError) as info:
        st.list_history(5)
    assert tstore._is_transient(info.value)
    errors = get_registry().counter(
        "rtpu_store_errors_total", "", ("op",)).labels(op="ping")
    before = errors.value
    assert st.ping() is False
    assert errors.value == before + 1


def test_postgrest_stores_leave_the_same_rows():
    srv, thread, url = start_fake_postgrest()
    try:
        ids = []
        for mod in (jstore, tstore):
            st = mod.PostgRESTStore(url, KEY)
            rid = st.insert_request(dict(_ROW))
            st.insert_result({"request_id": rid, "total_distance": 12.5,
                              "optimized_order": [1, 0]})
            ids.append(rid)
        state = srv.state
        rows = [{k: v for k, v in state.requests[i].items()
                 if k not in ("id", "request_time")} for i in ids]
        assert rows[0] == rows[1] == _ROW
        results = [[{k: v for k, v in r.items()
                     if k not in ("id", "created_at", "request_id")}
                    for r in state.results[i]] for i in ids]
        assert results[0] == results[1]
        # each package reads both rows the same way
        for mod in (jstore, tstore):
            st = mod.PostgRESTStore(url, KEY)
            assert [r["id"] for r in st.list_history(10)] == ids[::-1]
            assert st.get_request(ids[0])["route_results"][0][
                "total_distance"] == 12.5
        assert tstore.PostgRESTStore(url, KEY).delete_request(ids[0])
        assert not jstore.PostgRESTStore(url, KEY).delete_request(ids[0])
        assert ids[0] not in state.requests and ids[0] not in state.results
    finally:
        _stop(srv)
        thread.join(5)


# ── cross-package history through one backend ────────────────────────


def _opt_body(i):
    return {"source_point": {"lat": 14.5836, "lon": 121.0409},
            "destination_points": [
                {"lat": 14.5355 + 0.001 * i, "lon": 121.0621,
                 "payload": 1},
                {"lat": 14.55, "lon": 121.03 + 0.001 * i, "payload": 2}],
            "driver_details": {"driver_name": f"d{i}", "vehicle_type": "car",
                               "vehicle_capacity": 9999,
                               "maximum_distance": 100000,
                               "driver_age": 30 + i},
            "meta": {"origin_id": "wh", "destination_ids": ["m1", "m2"]}}


def test_history_crosses_packages_through_one_postgrest():
    srv, thread, url = start_fake_postgrest()
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    japp = jax_create_app(JConfig(), eta_service=jsvc,
                          store=jstore.make_store(url, KEY))
    tapp = create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=tsvc, store=tstore.make_store(url, KEY))
    try:
        jc, tc = Client(japp), Client(tapp)
        assert tapp.store.kind == "postgrest"
        written = []
        for i, (writer, reader) in enumerate(((tc, jc), (jc, tc))):
            r = writer.post("/api/optimize_route", json=_opt_body(i))
            assert r.status_code == 200
            rid = r.get_json()["properties"]["request_id"]
            written.append(rid)
            detail = [c.get(f"/api/history/{rid}") for c in (reader, writer)]
            assert [d.status_code for d in detail] == [200, 200]
            assert detail[0].get_json() == detail[1].get_json()
            assert detail[0].get_json()["request"]["vehicle_id"] == f"d{i}"
        hist = [c.get("/api/history?limit=10").get_json() for c in (jc, tc)]
        assert hist[0] == hist[1]
        assert [it["request_id"] for it in hist[0]["items"]] == \
            written[::-1]
        assert jc.delete(f"/api/history/{written[0]}").status_code == 204
        assert tc.get(f"/api/history/{written[0]}").status_code == 404
    finally:
        for app in (japp, tapp):
            if app.dispatch.reopt is not None:
                app.dispatch.reopt.stop()
        _stop(srv)
        thread.join(5)


# ── failure classification ────────────────────────────────────────────


@pytest.mark.parametrize("exc,want", [
    (urllib.error.HTTPError("u", 409, "Conflict", {}, None), False),
    (urllib.error.HTTPError("u", 404, "Not Found", {}, None), False),
    (urllib.error.HTTPError("u", 503, "Unavailable", {}, None), True),
    (urllib.error.HTTPError("u", 500, "Error", {}, None), True),
    (urllib.error.URLError(ConnectionRefusedError(111, "refused")), True),
    (TimeoutError("timed out"), True),
    (ConnectionResetError("reset"), True),
    (KeyError("route_requests.x does not exist"), False),
    (ValueError("bad"), False),
], ids=["409", "404", "503", "500", "urlerror", "timeout", "reset",
        "fk", "value"])
def test_is_transient(exc, want):
    assert tstore._is_transient(exc) is want


# ── ResilientStore against the JAX one ───────────────────────────────


class _Scripted:
    """An in-memory backend that raises the next scripted exception on
    each call while the script has one (None = let the call through),
    and logs every call's op."""

    def __init__(self, script):
        self._inner = jstore.InMemoryStore()
        self.script = list(script)
        self.calls = []

    def _go(self, op, *args):
        self.calls.append(op)
        if self.script:
            exc = self.script.pop(0)
            if exc is not None:
                raise exc
        return getattr(self._inner, op)(*args)

    def insert_request(self, row):
        return self._go("insert_request", row)

    def insert_result(self, row):
        return self._go("insert_result", row)

    def list_history(self, limit, engine=None):
        return self._go("list_history", limit, engine)

    def get_request(self, req_id):
        return self._go("get_request", req_id)

    def delete_request(self, req_id):
        return self._go("delete_request", req_id)

    def ping(self):
        return self._go("ping")

    @property
    def kind(self):
        return "scripted"


_METRICS = ("rtpu_store_retries_total", "rtpu_store_journal_replayed_total",
            "rtpu_store_journal_dropped_total",
            "rtpu_store_journal_writes_total",
            "rtpu_store_breaker_opens_total")


def _metric_values(registry):
    return [registry.counter(name).labels().value for name in _METRICS]


def _drive(mod, script, registry):
    """The scripted sequence → a transcript of what the store did."""
    inner = _Scripted(script)
    st = mod.ResilientStore(inner, retries=2, backoff_base_s=0.0,
                            breaker_threshold=3, cooldown_s=0.05,
                            journal_limit=4)
    before = _metric_values(registry)
    out = []

    def step(name, fn):
        try:
            value = fn()
            kind = ("id" if name == "insert_request"
                    else len(value) if name == "list_history" else value)
            out.append((name, "ok", kind))
        except Exception as e:
            out.append((name, type(e).__name__))
        out.append(("state", st.resilience(), st.degraded))

    conn = ConnectionError("refused")
    ids = []
    step("insert_request", lambda: ids.append(
        st.insert_request({"origin_id": "a"})) or "id")
    step("list_history", lambda: st.list_history(10))
    # three failures in a row: the breaker opens mid-write
    inner.script = [conn, conn, conn]
    step("insert_request", lambda: ids.append(
        st.insert_request({"origin_id": "b"})) or "id")
    step("insert_result", lambda: st.insert_result(
        {"request_id": ids[-1], "total_distance": 2.0}))
    step("list_history", lambda: st.list_history(10))
    for i in range(4):  # the journal bound drops the oldest
        step("insert_request", lambda: st.insert_request(
            {"origin_id": f"c{i}"}) and "id")
    step("ping", st.ping)  # cooling down: fails fast
    time.sleep(0.08)
    inner.script = [conn]  # the half-open probe fails: breaker re-opens
    step("ping", st.ping)
    time.sleep(0.08)
    step("ping", st.ping)  # recovers, replays FIFO
    step("list_history", lambda: st.list_history(10))
    inner.script = [KeyError("fk")]  # a permanent error raises, unjournaled
    step("insert_result", lambda: st.insert_result(
        {"request_id": "nope", "total_distance": 1.0}))
    inner.script = [conn, None]  # one retry rides through
    step("get_request", lambda: st.get_request(ids[0]) is not None)
    after = _metric_values(registry)
    return out, inner.calls, [b - a for a, b in zip(before, after)]


@pytest.fixture
def quiet_recorders(monkeypatch):
    """Both packages' flight recorders off: a breaker that opens writes
    a postmortem bundle, and a bundle written inside the 50 ms cooldown
    this test scripts would let the breaker half-open early."""
    from routest_tpu.obs import recorder as jrecorder
    from routest_tpu_torch.obs import recorder as trecorder

    for mod in (jrecorder, trecorder):
        monkeypatch.setattr(mod, "_recorder", mod.FlightRecorder(
            mod.RecorderConfig(enabled=False)))


def test_resilient_store_matches_jax_on_a_scripted_outage(quiet_recorders):
    jout, jcalls, jdelta = _drive(jstore, [], jget_registry())
    tout, tcalls, tdelta = _drive(tstore, [], get_registry())
    assert tcalls == jcalls
    assert tout == jout
    assert tdelta == jdelta
    # the sequence exercised what it claims: retries, one open, a
    # replay of the journal's 4 surviving writes, drops over the bound
    assert tdelta == [3, 4, 2, 6, 1]


# ── make_store ───────────────────────────────────────────────────────


@pytest.mark.parametrize("env", [
    {},
    {"RTPU_STORE_RETRIES": "5", "RTPU_STORE_BACKOFF_MS": "10",
     "RTPU_STORE_BREAKER_AFTER": "7", "RTPU_STORE_COOLDOWN_S": "0.5",
     "RTPU_STORE_JOURNAL": "32"},
    {"RTPU_STORE_RETRIES": "two", "RTPU_STORE_BACKOFF_MS": "5ms",
     "RTPU_STORE_BREAKER_AFTER": "", "RTPU_STORE_COOLDOWN_S": "nan?",
     "RTPU_STORE_JOURNAL": "1e3"},
    {"RTPU_STORE_RETRIES": "-3", "RTPU_STORE_BREAKER_AFTER": "0",
     "RTPU_STORE_JOURNAL": "0"},
], ids=["defaults", "set", "malformed", "clamped"])
@pytest.mark.parametrize("backend", ["memory", "postgrest"])
def test_make_store_wraps_and_parses_like_jax(monkeypatch, env, backend):
    for name in STORE_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    args = (("http://127.0.0.1:9", KEY) if backend == "postgrest"
            else (None, None))
    got = tstore.make_store(*args)
    want = jstore.make_store(*args)
    assert isinstance(got, tstore.TracedStore)
    assert isinstance(got._inner, tstore.ResilientStore)
    inner = got._inner._inner
    assert type(inner).__name__ == type(want._inner._inner).__name__
    assert got.kind == want.kind == backend
    fields = ("_retries", "_backoff_base_s", "_backoff_cap_s",
              "_threshold", "_cooldown_s", "_journal_limit")
    assert [getattr(got._inner, f) for f in fields] == \
        [getattr(want._inner, f) for f in fields]
    assert got.resilience() == want.resilience()


@pytest.mark.parametrize("url,key", [("http://x", None), (None, KEY),
                                     ("", KEY)])
def test_make_store_needs_url_and_key_for_postgrest(url, key):
    assert tstore.make_store(url, key).kind == "memory"


# ── the port's app through an outage ─────────────────────────────────


def test_app_outage_journals_and_replays_every_acknowledged_write(
        monkeypatch):
    monkeypatch.setenv("RTPU_STORE_COOLDOWN_S", "0.2")
    monkeypatch.setenv("RTPU_STORE_BACKOFF_MS", "0")
    srv, thread, url = start_fake_postgrest()
    port = srv.server_address[1]
    monkeypatch.setenv("SUPABASE_URL", url)
    monkeypatch.setenv("SUPABASE_SERVICE_ROLE_KEY", KEY)
    from routest_tpu_torch.core.config import load_config

    cfg = load_config()
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    app = create_app(Config(serve=ServeConfig(
        device="cpu", supabase_url=cfg.serve.supabase_url,
        supabase_service_key=cfg.serve.supabase_service_key)),
        eta_service=tsvc)
    srv2 = None
    try:
        c = Client(app)
        assert app.store.kind == "postgrest"
        acked = []

        def optimize(i):
            body = dict(_opt_body(i), use_ml_eta=True)
            r = c.post("/api/optimize_route", json=body)
            assert r.status_code == 200
            props = r.get_json()["properties"]
            assert props["saved"] is True
            acked.append(props["request_id"])
            return props

        for i in range(3):
            assert "degraded" not in optimize(i)
        state = srv.state
        _stop(srv)
        thread.join(5)
        for i in range(3, 6):  # journaled, acknowledged all the same
            assert optimize(i)["degraded"] is True
        r = c.get("/api/history")
        assert r.status_code == 200
        assert r.get_json() == {"items": [], "degraded": True}
        r = c.get(f"/api/history/{acked[0]}")
        assert r.status_code == 503 and r.get_json()["degraded"] is True
        health = c.get("/api/health").get_json()["checks"]["store"]
        assert health["status"] == "error"
        assert health["resilience"]["breaker"] == "open"
        assert health["resilience"]["journal_depth"] == 6  # 3 × (req, res)
        # the database comes back on the same port with its rows
        srv2, thread2, _ = start_fake_postgrest(port)
        srv2.state = state
        deadline = time.time() + 10
        while time.time() < deadline:
            time.sleep(0.25)
            store = c.get("/api/health").get_json()["checks"]["store"]
            if store["status"] == "ok":
                break
        assert store["resilience"]["journal_depth"] == 0, store
        items = c.get("/api/history?limit=100").get_json()["items"]
        assert sorted(it["request_id"] for it in items) == sorted(acked)
        for rid in acked:
            detail = c.get(f"/api/history/{rid}").get_json()
            assert detail["result"] is not None
            assert np.isfinite(detail["result"]["eta_minutes_ml"])
        hist = get_registry().get("rtpu_store_op_seconds")
        ops = {labels for labels, _ in hist.items()}
        assert ("insert_request", "postgrest") in ops
        assert ("list_history", "postgrest") in ops
    finally:
        if app.dispatch.reopt is not None:
            app.dispatch.reopt.stop()
        if srv2 is not None:
            _stop(srv2)
            thread2.join(5)
