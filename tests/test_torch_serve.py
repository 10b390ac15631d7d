"""The slice as a whole: the port's ``EtaService(device="cpu")`` and app
against the JAX ``EtaService`` and ``create_app`` on the same artifact
and the same request bodies — status codes, keys and error strings
identical, minutes within rtol 1e-4 / atol 1e-3 (both CPU paths compute
in f32), completion timestamps within 1 s — plus the port's batcher,
fast lane, WSGI layer and entry point on their own."""

import datetime as dt
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.serve import ml_service
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.deadline import DeadlineExceeded
from routest_tpu_torch.serve.fastlane import FastLane
from routest_tpu_torch.serve.ml_service import DynamicBatcher, EtaService
from routest_tpu_torch.serve.wsgi import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUANTILE = os.path.join(REPO, "artifacts", "eta_mlp.msgpack")
POINT = os.path.join(REPO, "artifacts", "eta_mlp_point.msgpack")
BUCKETS = (8, 64)


def _services(path):
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS), model_path=path)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS), model_path=path,
                      device="cpu")
    return jsvc, tsvc


@pytest.fixture(scope="module")
def quantile_services():
    return _services(QUANTILE)


@pytest.fixture(scope="module")
def point_services():
    return _services(POINT)


@pytest.fixture(scope="module")
def clients(quantile_services):
    jsvc, tsvc = quantile_services
    japp = jax_create_app(JConfig(), eta_service=jsvc)
    tapp = create_app(Config(), eta_service=tsvc)
    return Client(japp), Client(tapp)


def _close(got, want, what, tol=(1e-4, 1e-3)):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol[0], atol=tol[1], err_msg=what)


def _same_time(got, want, what, slack_s=1.0):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            _same_time(g, w, what, slack_s)
        return
    if want is None:
        assert got is None, what
        return
    delta = dt.datetime.fromisoformat(got) - dt.datetime.fromisoformat(want)
    assert abs(delta.total_seconds()) <= slack_s, (what, got, want)


def _compare_json(got, want, tol=(1e-4, 1e-3), slack_s=1.0):
    """Same keys; minutes within ``tol``; completion times within
    ``slack_s``."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        if key.startswith("eta_completion_time"):
            _same_time(g, w, key, slack_s)
        elif key.startswith("eta_minutes"):
            if isinstance(w, list):
                assert [v is None for v in g] == [v is None for v in w], key
                g = [v for v in g if v is not None]
                w = [v for v in w if v is not None]
            _close(g, w, key, tol)
        else:
            assert g == w, key


def _batch_body(n, seed, with_pickup=True):
    rng = np.random.default_rng(seed)
    body = {"distance_m": rng.uniform(100, 40_000, n).round(1).tolist(),
            "weather": rng.choice(["Sunny", "Cloudy", "Stormy", "Windy",
                                   "Fog"], n).tolist(),
            "traffic": rng.choice(["Low", "Medium", "High", "Jam",
                                   "Gridlock"], n).tolist(),
            "driver_age": rng.integers(18, 70, n).tolist()}
    if with_pickup:
        body["pickup_time"] = [f"2026-10-{10 + i % 9:02d}T{i % 24:02d}:"
                               f"{(7 * i) % 60:02d}:00" for i in range(n)]
    return body


_ONE = {"summary": {"distance": 12_500}, "weather": "Stormy",
        "traffic": "Jam", "pickup_time": "2026-10-16T08:30:00+08:00",
        "driver_age": 41}

BODIES = [
    ("predict_eta", "/api/predict_eta", _ONE),
    ("predict_eta_utc_z", "/api/predict_eta",
     dict(_ONE, pickup_time="2026-10-16T23:59:30+00:00")),
    ("predict_eta_unknown_cats", "/api/predict_eta",
     dict(_ONE, weather="Fog", traffic="Gridlock", driver_age=None)),
    ("predict_eta_no_pickup", "/api/predict_eta",
     {"summary": {"distance": 800}}),
    ("predict_eta_empty", "/api/predict_eta", {}),
    ("predict_eta_bad_distance", "/api/predict_eta",
     {"summary": {"distance": "far"}}),
    ("predict_eta_bad_age", "/api/predict_eta",
     dict(_ONE, driver_age=[1])),
    ("predict_eta_weather_dict", "/api/predict_eta",
     dict(_ONE, weather={"x": 1})),
    ("predict_eta_summary_list", "/api/predict_eta",
     dict(_ONE, summary=[1, 2])),
    ("batch_columnar", "/api/predict_eta_batch", _batch_body(37, 0)),
    ("batch_columnar_scalars", "/api/predict_eta_batch",
     {"distance_m": [1000, 0, None, 52_000], "weather": "Windy",
      "traffic": None, "driver_age": 25,
      "pickup_time": "2026-10-14T06:00:00"}),
    ("batch_items", "/api/predict_eta_batch", {"items": [
        {"summary": {"distance": 3_000}, "weather": "Sunny",
         "pickup_time": "2026-10-16T17:45:00"},
        {"distance_m": 950, "weather": None, "driver_age": 63,
         "pickup_time": "2026-10-17T02:10:00"}]}),
    ("batch_items_empty", "/api/predict_eta_batch", {"items": []}),
    ("batch_items_not_list", "/api/predict_eta_batch", {"items": "x"}),
    ("batch_items_strings", "/api/predict_eta_batch", {"items": ["foo"]}),
    ("batch_no_distance", "/api/predict_eta_batch", {"weather": "Sunny"}),
    ("batch_length_mismatch", "/api/predict_eta_batch",
     {"distance_m": [1, 2, 3], "weather": ["Sunny", "Low"]}),
    ("batch_weather_int", "/api/predict_eta_batch",
     {"distance_m": [1, 2], "weather": [1, "Sunny"]}),
    ("batch_pickup_int", "/api/predict_eta_batch",
     {"distance_m": [1, 2], "pickup_time": [5, None]}),
    ("batch_bad_distance", "/api/predict_eta_batch",
     {"distance_m": ["a", 2]}),
    ("batch_too_large", "/api/predict_eta_batch",
     {"distance_m": [0] * 131_073}),
    ("alias_single", "/api/predict", _ONE),
    ("alias_columnar", "/api/predict", _batch_body(5, 1)),
    ("alias_items", "/api/predict", {"items": [{"distance_m": 10}]}),
]


@pytest.mark.parametrize("name,path,body", BODIES, ids=[b[0] for b in BODIES])
def test_app_json_parity(clients, name, path, body):
    jclient, tclient = clients
    jr = jclient.post(path, json=body)
    tr = tclient.post(path, json=body)
    assert tr.status_code == jr.status_code, (tr.get_json(), jr.get_json())
    _compare_json(tr.get_json(), jr.get_json())


@pytest.mark.parametrize("raw", [b"{not json", b"[1, 2, 3]", b'"str"',
                                 b"42", b""])
@pytest.mark.parametrize("path", ["/api/predict_eta", "/api/predict_eta_batch",
                                  "/api/predict"])
def test_app_malformed_bodies_parity(clients, raw, path):
    jclient, tclient = clients
    kw = dict(data=raw, content_type="application/json")
    jr, tr = jclient.post(path, **kw), tclient.post(path, **kw)
    assert tr.status_code == jr.status_code
    _compare_json(tr.get_json(), jr.get_json())


@pytest.mark.parametrize("method,path", [
    ("GET", "/api/ping"), ("GET", "/api/nowhere"),
    ("GET", "/api/predict_eta"), ("DELETE", "/api/predict_eta_batch")])
def test_app_routing_parity(clients, method, path):
    jclient, tclient = clients
    jr = jclient.open(path, method=method)
    tr = tclient.open(path, method=method)
    assert tr.status_code == jr.status_code
    assert tr.get_json() == jr.get_json()
    assert tr.headers.get("Allow") == jr.headers.get("Allow")
    assert tr.headers.get("X-Request-ID")


def test_app_body_limit_and_deadline_parity(clients, monkeypatch):
    jclient, tclient = clients
    monkeypatch.setenv("RTPU_MAX_BODY_MB", "1")
    big = {"distance_m": [1.5] * 400_000}
    jr = jclient.post("/api/predict_eta_batch", json=big)
    tr = tclient.post("/api/predict_eta_batch", json=big)
    assert (tr.status_code, tr.get_json()) == (jr.status_code, jr.get_json())
    assert tr.status_code == 413
    monkeypatch.delenv("RTPU_MAX_BODY_MB")
    hdr = {"X-Deadline-Ms": "0"}
    jr = jclient.post("/api/predict_eta", json=_ONE, headers=hdr)
    tr = tclient.post("/api/predict_eta", json=_ONE, headers=hdr)
    assert (tr.status_code, tr.get_json()) == (jr.status_code, jr.get_json())
    assert tr.status_code == 504


def test_app_cors_parity(clients):
    jclient, tclient = clients
    for origin in ("http://localhost:3000", "https://x-y.vercel.app",
                   "https://evil.example"):
        jr = jclient.get("/api/ping", headers={"Origin": origin})
        tr = tclient.get("/api/ping", headers={"Origin": origin})
        for h in ("Access-Control-Allow-Origin",
                  "Access-Control-Allow-Credentials",
                  "Access-Control-Allow-Headers"):
            assert tr.headers.get(h) == jr.headers.get(h), (origin, h)


def test_health_reports_scoring_and_device(clients):
    _, tclient = clients
    r = tclient.get("/api/health")
    assert r.status_code == 200
    body = r.get_json()
    assert body["status"] == "ok"
    model = body["checks"]["model"]
    assert model["status"] == "ok" and model["generation"] >= 0
    assert len(model["fingerprint"]) == 16
    assert model["scoring"] == {"family": "eta_mlp", "kernel": "torch_plain",
                                "dtype": "float32", "device": "cpu",
                                "aot": False, "aot_buckets": []}
    assert body["checks"]["engine"]["mesh"]["platform"] == "cpu"
    assert body["checks"]["tpu"]["batcher"]["flushes"] >= 1
    assert body["checks"]["tpu"]["devices"] == ["cpu"]


def test_health_device_memory_gauge_matches_jax_on_the_cpu(clients):
    # JAX's CPU devices report no memory stats: the gauge is {} in both
    # apps on the CPU (on a card the port reads the caching allocator)
    jclient, tclient = clients
    jtpu = jclient.get("/api/health").get_json()["checks"]["tpu"]
    ttpu = tclient.get("/api/health").get_json()["checks"]["tpu"]
    assert jtpu["memory"] == ttpu["memory"] == {}


@pytest.mark.parametrize("which", ["quantile", "point"])
def test_service_batch_parity(which, quantile_services, point_services):
    jsvc, tsvc = quantile_services if which == "quantile" else point_services
    body = _batch_body(300, 5)   # > the 64 bucket: chunked submits
    kw = dict(weather=body["weather"], traffic=body["traffic"],
              distance_m=body["distance_m"], driver_age=body["driver_age"],
              pickup_time=body["pickup_time"], return_quantiles=True)
    jm, jiso, jbands = jsvc.predict_eta_batch(**kw)
    tm, tiso, tbands = tsvc.predict_eta_batch(**kw)
    _close(tm, jm, "minutes")
    assert sorted(tbands) == sorted(jbands) == (
        ["p10", "p90"] if which == "quantile" else [])
    for k in jbands:
        _close(tbands[k], jbands[k], k)
    _same_time(list(map(str, tiso)), list(map(str, jiso)), "iso")
    assert tsvc.quantiles == jsvc.quantiles


@pytest.mark.parametrize("which", ["quantile", "point"])
def test_service_single_row_parity(which, quantile_services, point_services):
    jsvc, tsvc = quantile_services if which == "quantile" else point_services
    kw = dict(weather="Cloudy", traffic="High", distance_m=7_300.0,
              pickup_time="2026-10-15T12:05:00-05:00", driver_age=29.0)
    jeta, jiso, jb = jsvc.predict_eta_quantiles(**kw)
    teta, tiso, tb = tsvc.predict_eta_quantiles(**kw)
    _close(teta, jeta, "eta")
    _same_time(tiso, jiso, "iso")
    assert tiso.endswith("-05:00")
    assert sorted(tb) == sorted(jb)
    jeta2, _ = jsvc.predict_eta_minutes(**kw)
    teta2, _ = tsvc.predict_eta_minutes(**kw)
    _close(teta2, jeta2, "eta minutes")


def test_service_scoring_info_and_dtype(quantile_services):
    jsvc, tsvc = quantile_services
    assert tsvc.kernel == "torch_plain"
    assert tsvc.kernel_dtype == jsvc.kernel_dtype == "float32"
    assert tsvc.available and tsvc.fingerprint == jsvc.fingerprint


def test_service_nan_rows_contained(quantile_services):
    _, tsvc = quantile_services
    rows = ml_service.golden_batch()[:4].copy()
    clean = np.asarray(tsvc.predict_batch(rows), np.float64)
    rows[1, 10] = np.nan
    out = tsvc.predict_batch(rows)
    assert np.isnan(out[1]).all()
    np.testing.assert_allclose(out[[0, 2, 3]], clean[[0, 2, 3]])


@pytest.mark.parametrize("content", [None, b"NOPE1\n{}\n"])
def test_service_load_failure_parity(tmp_path, content):
    path = str(tmp_path / "model.msgpack")
    if content is not None:
        with open(path, "wb") as f:
            f.write(content)
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS), model_path=path)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS), model_path=path,
                      device="cpu")
    assert not tsvc.available and not jsvc.available
    assert tsvc.load_error == jsvc.load_error
    assert tsvc.predict_eta_minutes(weather="Sunny", traffic="Low",
                                    distance_m=1.0, pickup_time=None) == \
        (None, None)
    r = Client(create_app(Config(), eta_service=tsvc)).post(
        "/api/predict_eta", json=_ONE)
    assert (r.status_code, r.get_json()) == (503, {"error": "model unavailable"})
    health = Client(create_app(Config(), eta_service=tsvc)).get(
        "/api/health").get_json()
    assert health["status"] == "degraded"
    assert health["checks"]["model"]["error"] == tsvc.load_error


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EtaService(ServeConfig(batch_buckets=BUCKETS), model_path=QUANTILE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EtaService(ServeConfig(batch_buckets=BUCKETS, device="cuda"),
                   model_path=QUANTILE, device=None)


# The int8 class of tests/test_ops_fused.py: per-column 8-bit weights.
INT8_TOL = (5e-2, 1.5)


@pytest.fixture(scope="module")
def int8_client():
    """The port's app over an int8 ``EtaService(device="cpu")``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTPU_KERNEL_DTYPE", "int8")
        tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                          model_path=QUANTILE, device="cpu")
    return tsvc, Client(create_app(Config(), eta_service=tsvc))


def test_int8_variant_serves_and_names_itself(int8_client):
    tsvc, tclient = int8_client
    assert tsvc.available and tsvc.load_error is None
    assert tsvc.kernel_dtype == "int8"
    assert tsvc._packed["w"][0].dtype == torch.int8
    body = tclient.get("/api/health").get_json()
    assert body["status"] == "ok"
    assert body["checks"]["model"]["scoring"] == {
        "family": "eta_mlp", "kernel": "torch_plain", "dtype": "int8",
        "device": "cpu", "aot": False, "aot_buckets": []}


INT8_BODIES = [b for b in BODIES if b[0] in (
    "predict_eta", "predict_eta_unknown_cats", "batch_columnar",
    "batch_columnar_scalars", "batch_items", "batch_length_mismatch",
    "alias_columnar")]


@pytest.mark.parametrize("name,path,body", INT8_BODIES,
                         ids=[b[0] for b in INT8_BODIES])
def test_int8_app_json_parity(clients, int8_client, name, path, body):
    """The int8 port against the JAX app (which serves f32 on the CPU):
    same statuses and keys, minutes within the int8 class, p10 ≤ eta ≤
    p90 wherever a band is served."""
    jclient, _ = clients
    _, tclient = int8_client
    jr = jclient.post(path, json=body)
    tr = tclient.post(path, json=body)
    assert tr.status_code == jr.status_code, (tr.get_json(), jr.get_json())
    got, want = tr.get_json(), jr.get_json()
    # a completion time moves with its minutes: 1 s plus what the int8
    # class allows the largest of them
    minutes = [v for v in np.atleast_1d(want.get("eta_minutes_ml", []))
               if v is not None]
    slack_s = 1.0 + 60.0 * (INT8_TOL[1] + INT8_TOL[0] * max(
        map(abs, minutes), default=0.0))
    _compare_json(got, want, INT8_TOL, slack_s)
    if tr.status_code == 200 and "eta_minutes_ml_p10" in got:
        eta, p10, p90 = (np.atleast_1d(np.asarray(got[k], np.float64))
                         for k in ("eta_minutes_ml", "eta_minutes_ml_p10",
                                   "eta_minutes_ml_p90"))
        assert (p10 <= eta).all() and (eta <= p90).all()


def test_int8_service_batch_matches_jax_within_int8_class(
        quantile_services, int8_client):
    jsvc, _ = quantile_services
    tsvc, _ = int8_client
    body = _batch_body(300, 11)
    kw = dict(weather=body["weather"], traffic=body["traffic"],
              distance_m=body["distance_m"], driver_age=body["driver_age"],
              pickup_time=body["pickup_time"], return_quantiles=True)
    jm, _, jbands = jsvc.predict_eta_batch(**kw)
    tm, _, tbands = tsvc.predict_eta_batch(**kw)
    _close(tm, jm, "minutes", INT8_TOL)
    for k in jbands:
        _close(tbands[k], jbands[k], k, INT8_TOL)


def test_real_socket_server_round_trip(quantile_services):
    _, tsvc = quantile_services
    server = make_server(create_app(Config(), eta_service=tsvc),
                         "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=60)
        conn.request("POST", "/api/predict_eta_batch",
                     body=json.dumps(_batch_body(9, 2)),
                     headers={"Content-Type": "application/json",
                              "X-Request-ID": "req-123"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["count"] == 9
        assert resp.getheader("X-Request-ID") == "req-123"
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_main_refuses_missing_artifact(monkeypatch, tmp_path):
    """A missing artifact is trained on the serving device before
    serving; with the default device (the card) and no card, the
    bootstrap refuses instead of training on the CPU, and writes
    nothing."""
    from routest_tpu_torch.serve import __main__ as entry

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    missing = tmp_path / "missing.msgpack"
    monkeypatch.setenv("ETA_MODEL_PATH", str(missing))
    monkeypatch.delenv("ROUTEST_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.main()
    assert not missing.exists()


# ── the batcher and fast lane on their own ──────────────────────────────


def _echo_score(calls):
    def score(x):
        calls.append(x.shape)
        return x.sum(axis=1)

    return score


def test_batcher_pads_to_bucket_and_coalesces():
    calls = []
    b = DynamicBatcher(_echo_score(calls), buckets=(4, 32, 256),
                       max_batch=256, max_wait_ms=30.0)
    np.testing.assert_allclose(b.submit(np.ones((3, 12), np.float32)),
                               np.full(3, 12.0))
    assert calls == [(4, 12)]
    n_threads = 16
    results = [None] * n_threads
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        results[i] = b.submit(np.full((2, 12), float(i), np.float32))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(n_threads):
        np.testing.assert_allclose(results[i], np.full(2, i * 12.0))
    assert b.stats["flushes"] - 1 < n_threads
    assert all(shape[0] in (4, 32, 256) for shape in calls)


def test_batcher_failure_reaches_every_waiter():
    def bad_score(x):
        raise RuntimeError("device fell over")

    b = DynamicBatcher(bad_score, buckets=(64,), max_batch=64,
                       max_wait_ms=50.0)
    n = 4
    outcomes = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        try:
            b.submit(np.ones((2, 12), np.float32))
            outcomes[i] = "ok"
        except RuntimeError:
            outcomes[i] = "raised"

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert outcomes == ["raised"] * n


def test_batcher_slab_fuzz_no_row_crosstalk():
    rng = np.random.default_rng(7)
    b = DynamicBatcher(lambda x: x.sum(axis=1), buckets=(4, 16, 64),
                       max_batch=64, max_wait_ms=5.0)
    payloads = [[rng.uniform(-50, 50, (int(rng.integers(1, 9)), 12))
                 .astype(np.float32) for _ in range(20)] for _ in range(8)]
    failures = []
    barrier = threading.Barrier(8)

    def worker(t):
        barrier.wait()
        for rows in payloads[t]:
            if not np.allclose(b.submit(rows), rows.sum(axis=1)):
                failures.append(t)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not failures
    assert b.stats["rows"] == sum(len(r) for p in payloads for r in p)
    big = np.arange(70 * 12, dtype=np.float32).reshape(70, 12)
    np.testing.assert_allclose(b.submit(big), big.sum(axis=1))


def test_batcher_waiter_gives_up_at_its_deadline():
    """A waiter queued behind a wedged flush raises DeadlineExceeded at
    its own deadline instead of waiting the flush out."""
    from routest_tpu_torch.serve.deadline import bind_deadline, reset_deadline

    entered, gate = threading.Event(), threading.Event()

    def slow(x):
        entered.set()
        gate.wait(10)
        return x.sum(axis=1)

    b = DynamicBatcher(slow, buckets=(8,), max_batch=1, max_wait_ms=1.0)
    first = threading.Thread(
        target=b.submit, args=(np.ones((1, 12), np.float32),), daemon=True)
    first.start()
    assert entered.wait(10)
    token = bind_deadline(50.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            b.submit(np.ones((1, 12), np.float32))
        assert time.monotonic() - t0 < 5.0
    finally:
        reset_deadline(token)
        gate.set()
    first.join(timeout=10)
    assert not first.is_alive()


def test_fastlane_cache_and_generation():
    calls = []

    def double(rows):
        calls.append(len(rows))
        return rows[:, 0] * 2.0

    fl = FastLane(capacity=16, ttl_s=60.0)
    rows = np.zeros((3, 4), np.float32)
    rows[:, 0] = (1, 2, 1)
    np.testing.assert_allclose(fl.predict(rows, (0, 0), double), [2, 4, 2])
    np.testing.assert_allclose(fl.predict(rows[::-1], (0, 0), double),
                               [2, 4, 2])
    assert calls == [2]          # duplicates and repeats never recompute
    fl.predict(rows, (1, 0), double)
    assert calls == [2, 2]       # a new generation misses


def test_service_cache_serves_repeats_without_device_calls(quantile_services):
    _, tsvc = quantile_services
    kw = dict(weather="Windy", traffic="Medium", distance_m=4_321.0,
              pickup_time="2026-10-11T09:09:00", driver_age=33.0)
    first = tsvc.predict_eta_minutes(**kw)
    flushes = tsvc.stats["flushes"]
    assert tsvc.predict_eta_minutes(**kw) == first
    assert tsvc.stats["flushes"] == flushes
