"""The port's open-loop load generator (``routest_tpu_torch/loadgen/``)
against the JAX package's (``routest_tpu/loadgen/``).

- Every case of ``tests/test_loadgen.py`` runs once per package with the
  same expectations (one parametrised test; stub HTTP servers).
- Bitwise equality across the packages, no tolerance: arrival offsets of
  every ``RateCurve`` kind and of ``with_burst``; ``ZipfODWorkload``
  pair ids and sequences; ``MixedWorkload.sequence`` for each of its
  seven kinds, the default mix and with regions, RTW1 batch frames
  compared as bytes; ``summarize``, ``timeline``, ``registry_totals``
  and ``cache_delta`` on the same records.
- The counterparts of ``tests/test_region.py``'s region-affinity case,
  ``tests/test_dispatch.py``'s dispatch component (served 200 by the
  port's CPU app) and ``tests/test_wire_serving.py``'s wire format (on
  the port's app, wire bodies answer bitwise as their JSON twins).
- A 2 s open-loop run of the default mix plus tracker ticks against a
  real ``python -m routest_tpu_torch.serve`` on the CPU, with two SSE
  subscribers: no error, records in schedule order, events delivered.
- The three port scripts: ``--help``; without a card and without
  ``--cpu`` each exits 2 naming the missing device; neither they nor
  ``routest_tpu_torch.loadgen`` import JAX or the JAX package.
- Their harness's pace (``scripts/cuda_harness.py``): against a stub
  replica, a generator made to lag (one sender behind a slow replica)
  is reported ``generator_lagged`` and never passes, one that keeps up
  is not; ``paced`` restores the interpreter's settings; the generator
  in a process of its own returns every record and stops on request.

Every server binds a free port; every thread a test starts is joined.
"""

import dataclasses
import datetime as dt
import http.server
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib
from collections import Counter

import numpy as np
import pytest
from werkzeug.test import Client

import routest_tpu.loadgen as jlg
import routest_tpu.loadgen.report as jreport
import routest_tpu_torch.loadgen as tlg
import routest_tpu_torch.loadgen.report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "eta_mlp.msgpack")
WIRE_CT = "application/x-rtpu-wire"
SCRIPTS = ("load_test_cuda.py", "bench_autoscale_cuda.py",
           "bench_dispatch_cuda.py")

PKGS = {"jax": types.SimpleNamespace(lg=jlg, report=jreport),
        "torch": types.SimpleNamespace(lg=tlg, report=treport)}


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


# ── the cases of tests/test_loadgen.py, once per package ─────────────


class _Stub(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, code):
        body = b'{"ok": true}'
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._send(200)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        if self.server.delay_s:
            time.sleep(self.server.delay_s)
        self._send(self.server.status)


class _StubServer:
    """A threading stub on a free port; ``close`` joins its thread."""

    def __init__(self, delay_s=0.0, status=200):
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        self.srv.daemon_threads = True
        self.srv.delay_s = delay_s
        self.srv.status = status
        self.base = f"http://127.0.0.1:{self.srv.server_port}"
        self._thread = threading.Thread(target=self.srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self._thread.join(timeout=5)


def _poisson_deterministic(p):
    lg = p.lg
    curve = lg.RateCurve.constant(50.0)
    a = lg.poisson_schedule(curve, 10.0, seed=7)
    b = lg.poisson_schedule(curve, 10.0, seed=7)
    c = lg.poisson_schedule(curve, 10.0, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not (len(a) == len(c) and (a == c).all())
    assert (np.diff(a) >= 0).all()
    assert a[0] >= 0 and a[-1] < 10.0
    assert 0.8 * 500 <= len(a) <= 1.2 * 500


def _paced_exact(p):
    sched = p.lg.paced_schedule(p.lg.RateCurve.constant(10.0), 5.0)
    assert len(sched) == 50
    np.testing.assert_allclose(np.diff(sched), 0.1, rtol=1e-9)


def _flash_crowd_steps(p):
    curve = p.lg.RateCurve.flash_crowd(5.0, 10.0, at_s=10.0, duration_s=5.0)
    assert curve.rate(9.99) == 5.0
    assert curve.rate(10.0) == 50.0
    assert curve.rate(14.99) == 50.0
    assert curve.rate(15.0) == 5.0
    assert curve.peak == 50.0
    sched = p.lg.poisson_schedule(curve, 20.0, seed=3)
    in_spike = ((sched >= 10.0) & (sched < 15.0)).sum()
    assert in_spike > 2 * (len(sched) - in_spike)


def _diurnal_trough_crest(p):
    curve = p.lg.RateCurve.diurnal(base=2.0, peak=20.0, period_s=60.0)
    assert curve.rate(0.0) == pytest.approx(2.0)
    assert curve.rate(30.0) == pytest.approx(20.0)
    assert curve.rate(60.0) == pytest.approx(2.0)
    assert 2.0 <= curve.mean_rate(60.0) <= 20.0


def _steps_and_burst(p):
    curve = p.lg.RateCurve.steps([(0, 4.0), (5, 8.0)])
    assert curve.rate(4.9) == 4.0 and curve.rate(5.0) == 8.0
    sched = p.lg.with_burst(p.lg.paced_schedule(curve, 10.0), at_s=3.1,
                            n=100)
    assert (sched == 3.1).sum() == 100
    assert (np.diff(sched) >= 0).all()


def _rate_curve_validation(p):
    with pytest.raises(ValueError):
        p.lg.RateCurve.constant(0.0)
    with pytest.raises(ValueError):
        p.lg.RateCurve.flash_crowd(5.0, 0.5, 1.0, 1.0)
    with pytest.raises(ValueError):
        p.lg.RateCurve.steps([(1.0, 5.0)])


def _zipf_same_seed(p):
    a = p.lg.ZipfODWorkload(s=1.1, seed=11).sequence(200)
    assert a == p.lg.ZipfODWorkload(s=1.1, seed=11).sequence(200)
    assert a != p.lg.ZipfODWorkload(s=1.1, seed=12).sequence(200)


def _zipf_skew(p):
    w = p.lg.ZipfODWorkload(s=1.1, seed=0)
    counts = np.bincount(w.pair_indices(4000), minlength=len(w.pairs))
    uniform_share = 4000 / len(w.pairs)
    assert np.sort(counts)[::-1][0] > 10 * uniform_share
    flat = np.bincount(p.lg.ZipfODWorkload(s=0.0, seed=0).pair_indices(4000),
                       minlength=len(w.pairs))
    assert np.sort(flat)[::-1][0] < 5 * uniform_share


def _zipf_bodies_byte_stable(p):
    w = p.lg.ZipfODWorkload(seed=5)
    body1 = w.body_for_pair(17)
    assert json.dumps(body1) == json.dumps(w.body_for_pair(17))
    assert body1["summary"]["distance"] > 0
    assert json.dumps(w.body_for_pair(18)) != json.dumps(body1)


def _mixed_ratios(p):
    mix = {"predict_eta": 0.7, "history": 0.2, "request_route": 0.1}
    seq = p.lg.MixedWorkload(mix=mix, seed=9).sequence(1000)
    assert seq == p.lg.MixedWorkload(mix=mix, seed=9).sequence(1000)
    counts = Counter(r.route for r in seq)
    assert 600 <= counts["/api/predict_eta"] <= 800
    assert 120 <= counts["/api/history"] <= 280
    assert 40 <= counts["/api/request_route"] <= 160
    for r in seq:
        if r.route == "/api/history":
            assert r.method == "GET" and r.body is None
        else:
            assert r.method == "POST" and r.body


def _mixed_rejects_unknown(p):
    with pytest.raises(ValueError, match="unknown workload kinds"):
        p.lg.MixedWorkload(mix={"nope": 1.0})


def _open_loop_from_intended_send(p):
    stub = _StubServer(delay_s=0.2)
    try:
        offsets = np.asarray([0.0, 0.05, 0.10, 0.15])
        reqs = p.lg.ZipfODWorkload(seed=1).sequence(4)
        records = p.lg.run_open_loop([stub.base], offsets, reqs, workers=1)
        assert len(records) == 4
        last = records[-1]
        assert last.latency_s > 0.45
        assert last.service_s < 0.45
        assert last.send_delay_s > 0.3
        assert last.latency_s == pytest.approx(
            last.send_delay_s + last.service_s, abs=0.05)
    finally:
        stub.close()


def _open_vs_closed_gap(p):
    stub = _StubServer(delay_s=0.15)
    try:
        w = p.lg.ZipfODWorkload(seed=2)
        offsets = p.lg.paced_schedule(p.lg.RateCurve.constant(20.0), 2.0)
        open_rep = p.lg.summarize(
            p.lg.run_open_loop([stub.base], offsets,
                               w.sequence(len(offsets)), workers=2,
                               timeout=10.0),
            2.0, len(offsets))
        closed_rep = p.lg.summarize(
            p.lg.run_closed_loop([stub.base], w.sequence(100), workers=2,
                                 duration_s=2.0),
            2.0, 100, loop="closed")
        assert open_rep["loop"] == "open"
        assert closed_rep["loop"] == "closed"
        assert open_rep["latency"]["p99_ms"] \
            > 2 * closed_rep["latency"]["p99_ms"]
    finally:
        stub.close()


def _sheds_and_errors(p):
    stub = _StubServer(status=429)
    try:
        offsets = p.lg.paced_schedule(p.lg.RateCurve.constant(40.0), 0.5)
        reqs = p.lg.ZipfODWorkload(seed=3).sequence(len(offsets))
        rep = p.lg.summarize(
            p.lg.run_open_loop([stub.base], offsets, reqs, workers=4),
            0.5, len(offsets))
        assert rep["shed"] == len(offsets) and rep["errors"] == 0
        assert rep["shed_rate"] == 1.0
        stub.srv.status = 503
        rep = p.lg.summarize(
            p.lg.run_open_loop([stub.base], offsets, reqs, workers=4),
            0.5, len(offsets))
        assert rep["errors"] == len(offsets) and rep["shed"] == 0
    finally:
        stub.close()


def _timeline_buckets(p):
    stub = _StubServer()
    try:
        offsets = p.lg.paced_schedule(p.lg.RateCurve.constant(10.0), 2.0)
        reqs = p.lg.ZipfODWorkload(seed=4).sequence(len(offsets))
        tl = p.lg.timeline(
            p.lg.run_open_loop([stub.base], offsets, reqs, workers=4),
            bucket_s=1.0)
        assert [b["t"] for b in tl] == [0.0, 1.0]
        assert sum(b["ok"] for b in tl) == 20
        assert all(9 <= b["ok"] <= 11 for b in tl)
    finally:
        stub.close()


_METRICS = {
    "registry": {"rtpu_cache_hits_total": {
        "type": "counter", "series": [{"labels": {}, "value": 5.0}]}},
    "replica_metrics": {
        "r0": {"registry": {"rtpu_cache_hits_total": {
            "type": "counter", "series": [{"labels": {}, "value": 7.0}]}}},
        "r1": {"error": "unreachable"},
    },
}


def _registry_totals(p):
    got = p.report.registry_totals(_METRICS,
                                   ["rtpu_cache_hits_total", "absent"])
    assert got == {"rtpu_cache_hits_total": 12.0, "absent": 0.0}


LOADGEN_CASES = {
    "poisson_schedule_deterministic_and_seed_sensitive":
        _poisson_deterministic,
    "paced_schedule_is_exact": _paced_exact,
    "flash_crowd_rate_steps": _flash_crowd_steps,
    "diurnal_curve_trough_and_crest": _diurnal_trough_crest,
    "steps_curve_and_burst": _steps_and_burst,
    "rate_curve_validation": _rate_curve_validation,
    "zipf_workload_same_seed_same_sequence": _zipf_same_seed,
    "zipf_skew_concentrates_traffic": _zipf_skew,
    "zipf_bodies_are_byte_stable_per_pair": _zipf_bodies_byte_stable,
    "mixed_workload_ratios_and_determinism": _mixed_ratios,
    "mixed_workload_rejects_unknown_kind": _mixed_rejects_unknown,
    "open_loop_latency_measured_from_intended_send":
        _open_loop_from_intended_send,
    "open_vs_closed_loop_gap_on_same_stalled_server": _open_vs_closed_gap,
    "report_counts_sheds_and_errors_separately": _sheds_and_errors,
    "timeline_buckets_by_scheduled_offset": _timeline_buckets,
    "registry_totals_sums_process_and_replicas": _registry_totals,
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(LOADGEN_CASES))
def test_loadgen_case(case, pkg):
    LOADGEN_CASES[case](PKGS[pkg])


# ── bitwise across the packages ──────────────────────────────────────


CURVES = {
    "constant": lambda lg: lg.RateCurve.constant(37.5),
    "steps": lambda lg: lg.RateCurve.steps([(0, 4.0), (3, 19.0), (7, 6.5)]),
    "diurnal": lambda lg: lg.RateCurve.diurnal(2.0, 40.0, 8.0, phase_s=1.5),
    "flash_crowd": lambda lg: lg.RateCurve.flash_crowd(6.0, 10.0, 3.0, 4.0),
}


@pytest.mark.parametrize("process", ["poisson", "paced", "burst"])
@pytest.mark.parametrize("kind", sorted(CURVES))
def test_schedules_bitwise(kind, process):
    out = []
    for lg in (jlg, tlg):
        curve = CURVES[kind](lg)
        if process == "poisson":
            offsets = lg.poisson_schedule(curve, 10.0, seed=31)
        else:
            offsets = lg.paced_schedule(curve, 10.0)
        if process == "burst":
            offsets = lg.with_burst(offsets, at_s=float(offsets[5]), n=17)
        out.append((curve.peak, curve.spec, curve.mean_rate(10.0),
                    offsets.dtype, offsets.tobytes()))
    assert out[0] == out[1]


def _rows(seq):
    """Requests → comparable tuples; dict bodies as their JSON text."""
    return [(r.method, r.path, r.route, r.content_type,
             r.body if r.body is None or isinstance(r.body, bytes)
             else json.dumps(r.body)) for r in seq]


@pytest.mark.parametrize("s,seed", [(1.1, 0), (0.0, 3), (2.0, 42)])
def test_zipf_workload_bitwise(s, seed):
    j, t = (lg.ZipfODWorkload(s=s, seed=seed) for lg in (jlg, tlg))
    assert j.pairs == t.pairs
    for offset in (1, 3, 7, 1009):
        assert j.pair_indices(500, seed_offset=offset).tobytes() \
            == t.pair_indices(500, seed_offset=offset).tobytes()
    assert _rows(j.sequence(300)) == _rows(t.sequence(300))
    for pair in (0, 17, 419):
        assert json.dumps(j.route_body_for_pair(pair, stops=3,
                                                road_graph=True)) \
            == json.dumps(t.route_body_for_pair(pair, stops=3,
                                                road_graph=True))
        assert json.dumps(j.dispatch_body_for_pair(pair, stops=6)) \
            == json.dumps(t.dispatch_body_for_pair(pair, stops=6))


MIXES = {
    **{k: dict(mix={k: 1.0}) for k in tlg.MixedWorkload.KINDS},
    "predict_eta_batch_binary": dict(mix={"predict_eta_batch": 1.0},
                                     batch_rows=48, wire_format="binary"),
    "default_mix": dict(),
    "all_kinds_with_regions": dict(
        mix={k: 1.0 for k in tlg.MixedWorkload.KINDS}, batch_rows=8,
        wire_format="binary", regions=("east", "west", "south"),
        region_zipf_s=1.3, road_graph=True, route_zipf_s=0.7),
}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_mixed_workload_bitwise(name):
    kw = dict(MIXES[name], seed=23)
    if "probe" in kw.get("mix", {}):
        kw.update(probe_edges=9998, probe_obs=5)
    j, t = (lg.MixedWorkload(**kw) for lg in (jlg, tlg))
    assert list(t.KINDS) == list(j.KINDS)
    assert t.describe() == j.describe()
    a, b = _rows(j.sequence(60)), _rows(t.sequence(60))
    assert a == b
    if kw.get("wire_format") == "binary":
        frames = [row[4] for row in b if isinstance(row[4], bytes)]
        assert frames and all(f[:4] == b"RTW1" for f in frames)


def _records(lg, n=400, seed=5):
    rng = np.random.default_rng(seed)
    statuses = rng.choice([200, 200, 200, 201, 304, 429, 404, 500, 503, -1],
                          size=n)
    routes = rng.choice(["/api/predict_eta", "/api/history",
                         "/api/predict_eta_batch"], size=n)
    offsets = np.sort(rng.uniform(0, 7.3, n))
    service = rng.exponential(0.02, n)
    delay = rng.exponential(0.004, n)
    return [lg.RequestRecord(
        route=str(routes[i]), offset_s=float(offsets[i]),
        status=int(statuses[i]), latency_s=float(service[i] + delay[i]),
        service_s=float(service[i]), send_delay_s=float(delay[i]),
        error=None if statuses[i] >= 0 else "OSError: reset")
        for i in range(n)]


def _snapshot(hits, misses, replica_hits):
    fam = {"rtpu_cache_hits_total": {"type": "counter", "series": [
        {"labels": {}, "value": hits}]},
        "rtpu_cache_misses_total": {"type": "counter", "series": [
            {"labels": {"route": "a"}, "value": misses},
            {"labels": {"route": "b"}, "count": 2.0}]}}
    return {"registry": fam, "replica_metrics": {
        "r0": {"registry": {"rtpu_cache_hits_total": {
            "series": [{"value": replica_hits}]}}},
        "r1": "unreachable"}}


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_reports_bitwise(loop):
    got = []
    for lg, report in ((jlg, jreport), (tlg, treport)):
        recs = _records(lg)
        before, after = _snapshot(3.0, 4.0, 1.0), _snapshot(40.0, 9.0, 7.5)
        got.append(json.dumps({
            "summary": lg.summarize(recs, 7.3, 450, loop=loop),
            "empty": lg.summarize([], 0.0, 0, loop=loop),
            "timeline": [lg.timeline(recs, bucket_s=b)
                         for b in (0.5, 1.0, 2.0)],
            "totals": lg.registry_totals(after, list(
                report.CACHE_FAMILIES) + ["absent"]),
            "cache": lg.cache_delta(before, after),
            "no_lookups": lg.cache_delta(before, before),
        }))
    assert got[0] == got[1]


# ── counterparts of the JAX package's serving cases ──────────────────


def test_loadgen_region_affinity_skewed_and_deterministic():
    wl = tlg.MixedWorkload(seed=3, regions=("east", "west", "south"))
    seq = wl.sequence(400)
    assert all("region=" in r.path for r in seq)
    counts = Counter(r.path.rsplit("region=", 1)[1] for r in seq)
    assert counts["east"] > counts["west"] > 0
    assert counts["east"] > counts["south"] > 0
    assert all("region=" not in r.route for r in seq)
    again = tlg.MixedWorkload(seed=3, regions=("east", "west", "south"))
    assert [r.path for r in again.sequence(400)] == [r.path for r in seq]
    history = [r for r in seq if r.route == "/api/history"]
    assert all("?limit=10&region=" in r.path for r in history)
    assert wl.describe()["regions"] == ["east", "west", "south"]
    assert all("region=" not in r.path
               for r in tlg.MixedWorkload(seed=3).sequence(50))


@pytest.fixture(scope="module")
def port_app():
    """The port's app on the CPU with the wire path on."""
    from routest_tpu_torch.core.config import Config, ServeConfig
    from routest_tpu_torch.serve.app import create_app
    from routest_tpu_torch.serve.bus import InMemoryBus
    from routest_tpu_torch.serve.ml_service import EtaService

    old = os.environ.get("RTPU_WIRE")
    os.environ["RTPU_WIRE"] = "1"
    try:
        svc = EtaService(ServeConfig(batch_buckets=(8, 64)),
                         model_path=ARTIFACT, device="cpu")
        app = create_app(Config(serve=ServeConfig(device="cpu")),
                         eta_service=svc, bus=InMemoryBus(),
                         sim_tick_range=(0.001, 0.002))
    finally:
        if old is None:
            os.environ.pop("RTPU_WIRE")
        else:
            os.environ["RTPU_WIRE"] = old
    yield app
    app.close()


def test_loadgen_dispatch_component_deterministic(port_app):
    a = tlg.MixedWorkload(mix={"dispatch": 1.0}, seed=17)
    b = tlg.MixedWorkload(mix={"dispatch": 1.0}, seed=17)
    sa, sb = a.sequence(12), b.sequence(12)
    assert [json.dumps(r.body, sort_keys=True) for r in sa] \
        == [json.dumps(r.body, sort_keys=True) for r in sb]
    assert all(r.method == "POST" and r.path == "/api/dispatch"
               for r in sa)
    client = Client(port_app)
    for req in sa[:3]:
        r = client.post("/api/dispatch", json=req.body)
        assert r.status_code == 200, r.get_data()
        plan = r.get_json()["plan"]
        assert plan["optimized_order"] or plan["spill_lane"]
    assert "dispatch" in tlg.MixedWorkload.KINDS
    assert a.describe()["dispatch_stops"] == 4


def test_loadgen_wire_bodies_answer_bitwise_as_json(port_app):
    from routest_tpu_torch.data.features import encode_requests
    from routest_tpu_torch.serve import wirecodec as wc

    def mk(**kw):
        return tlg.MixedWorkload(mix={"predict_eta_batch": 1.0}, seed=5,
                                 batch_rows=16, **kw).sequence(3)

    wire, json_ = mk(wire_format="binary"), mk()
    assert all(x.body == y.body for x, y in zip(wire, mk(
        wire_format="binary")))
    assert all(x.content_type == WIRE_CT for x in wire)
    with pytest.raises(ValueError, match="wire_format"):
        tlg.MixedWorkload(wire_format="msgpack")
    client = Client(port_app)
    for w, j in zip(wire, json_):
        items = j.body["items"]
        frame = wc.decode_eta_request(w.body, max_bytes=1 << 20,
                                      max_rows=1024)
        pickups = [dt.datetime.fromisoformat(it["pickup_time"])
                   for it in items]
        expected = encode_requests(
            weather=[it["weather"] for it in items],
            traffic=[it["traffic"] for it in items],
            weekday=[p.weekday() for p in pickups],
            hour=[p.hour for p in pickups],
            distance_km=[it["summary"]["distance"] / 1000.0
                         for it in items],
            driver_age=[it["driver_age"] for it in items])
        assert frame.columns["features"].tobytes() == \
            np.asarray(expected, np.float32).tobytes()
        rw = client.post("/api/predict_eta_batch", data=w.body,
                         content_type=WIRE_CT)
        rj = client.post("/api/predict_eta_batch", json=j.body)
        assert rw.status_code == rj.status_code == 200
        got = wc.decode_eta_response(rw.get_data())
        want = rj.get_json()
        assert np.round(got["minutes"], 4).tobytes() == np.asarray(
            want["eta_minutes_ml"], np.float64).tobytes()
        for lvl, vals in got["bands"].items():
            assert np.round(vals, 4).tobytes() == np.asarray(
                want[f"eta_minutes_ml_{lvl}"], np.float64).tobytes()
        stamps = np.datetime_as_string(np.asarray(
            got["completion_ms"], np.int64).astype("datetime64[ms]"),
            unit="s")
        assert [str(s) for s in stamps] == want["eta_completion_time_ml"]


# ── against a real server of the port on the CPU ─────────────────────


def _port_server_env(port):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RTPU_", "ROUTEST_", "REDIS_URL"))}
    env.update({"ROUTEST_DEVICE": "cpu", "PORT": str(port),
                "ETA_MODEL_PATH": ARTIFACT, "RTPU_BATCH_BUCKETS": "8,64",
                "ROUTEST_WARM_BUCKETS": "0", "OMP_NUM_THREADS": "1"})
    return env


def test_open_loop_against_a_port_server_on_the_cpu():
    from routest_tpu_torch.serve.fleet.supervisor import free_port

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "routest_tpu_torch.serve"], cwd=REPO,
        env=_port_server_env(port), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, "the server exited"
            try:
                with urllib.request.urlopen(f"{base}/api/ping",
                                            timeout=2) as r:
                    if json.loads(r.read()).get("ok"):
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "no ping"
            time.sleep(0.2)
        wl = tlg.MixedWorkload(mix={**tlg.DEFAULT_MIX,
                                    "update_tracker": 0.1}, seed=42)
        offsets = tlg.paced_schedule(tlg.RateCurve.constant(25.0), 2.0)
        requests = wl.sequence(len(offsets))
        assert len(offsets) == 50
        before = tlg.fetch_metrics(base)
        with tlg.SseClients(base, n=2, channel=wl.sse_channel,
                            header_timeout=20.0) as sse:
            # the first tracker tick flushes the streams' headers
            tick = next(r for r in requests
                        if r.route == "/api/update_tracker")
            client = tlg.KeepAliveClient(base)
            t0 = time.monotonic()
            try:
                while sse.snapshot()["connected"] < 2:
                    assert client.send(tick)[0] == 200
                    assert time.monotonic() - t0 < 20, sse.snapshot()
                    time.sleep(0.1)
            finally:
                client.close()
            records = tlg.run_open_loop([base], offsets, requests,
                                        workers=8, timeout=30.0)
            time.sleep(0.3)
            snap = sse.snapshot()
        after = tlg.fetch_metrics(base)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    rep = tlg.summarize(records, 2.0, len(offsets))
    assert rep["errors"] == 0 and rep["shed"] == 0 and rep["other_4xx"] == 0
    assert rep["ok"] == len(offsets) == len(records)
    assert [r.offset_s for r in records] == [float(o) for o in offsets]
    assert [r.route for r in records] == [r.route for r in requests]
    assert set(rep["routes"]) >= {"/api/predict_eta", "/api/update_tracker"}
    assert rep["send_delay"]["p50_ms"] < 100.0
    assert snap["connected"] == 2 and snap["errors"] == 0
    assert snap["events"] > 0
    delta = tlg.cache_delta({"registry": before["registry"]},
                            {"registry": after["registry"]})
    assert delta["hits"] + delta["misses"] > 0


# ── the scripts ──────────────────────────────────────────────────────


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_help(script):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--cpu" in out.stdout and "--out" in out.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_a_card(script, tmp_path):
    out_path = tmp_path / "record.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script),
         "--out", str(out_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr and "--cpu" in out.stderr
    assert not out_path.exists()


def _cuda_harness():
    """The harness as the scripts import it (by name, from ``scripts/``:
    a spawned generator process imports it the same way)."""
    import importlib

    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.append(scripts)
    return importlib.import_module("cuda_harness")


@pytest.mark.parametrize("lag", [True, False])
def test_harness_reports_a_lagging_generator_and_never_passes_it(lag):
    import gc

    h = _cuda_harness()
    # lagging: 40 arrivals in 0.2 s behind one sender and a 50 ms
    # replica; keeping up: 10 arrivals in 1 s over eight senders
    rate, span, workers = (200.0, 0.2, 1) if lag else (10.0, 1.0, 8)
    offsets = tlg.paced_schedule(tlg.RateCurve.constant(rate), span)
    requests = tlg.ZipfODWorkload(seed=3).sequence(len(offsets))
    switch = sys.getswitchinterval()
    stub = _StubServer(delay_s=0.05)
    try:
        with h.paced():
            assert sys.getswitchinterval() == pytest.approx(
                h.LOADGEN_SWITCH_S)
            assert not gc.isenabled()
            records = tlg.run_open_loop([stub.base], offsets, requests,
                                        workers=workers, timeout=10.0)
    finally:
        stub.close()
    assert sys.getswitchinterval() == switch and gc.isenabled()
    rep = tlg.summarize(records, span, len(offsets))
    assert rep["ok"] == len(offsets)
    pace = h.pace_check(rep)
    assert pace["send_delay_p99_ms"] == rep["send_delay"]["p99_ms"]
    assert pace["pace_limit_ms"] == rep["latency"]["p50_ms"]
    assert pace["generator_lagged"] is lag
    assert h.passed(True, pace) is (not lag)
    assert h.passed(False, pace) is False
    # a run with nothing to read cannot show its pace
    assert h.pace_check({})["generator_lagged"] is True


def test_harness_runs_the_generator_in_a_process_of_its_own():
    h = _cuda_harness()
    offsets = tlg.paced_schedule(tlg.RateCurve.constant(50.0), 0.4)
    requests = tlg.ZipfODWorkload(seed=4).sequence(len(offsets))
    stub = _StubServer(delay_s=0.01)
    try:
        t0 = time.time()
        records, started = h.run_open_loop_process(
            [stub.base], offsets, requests, workers=4, timeout=10.0)
        assert t0 <= started <= time.time()
        rep = tlg.summarize(records, 0.4, len(offsets))
        assert rep["ok"] == len(offsets) == len(records)
        assert [r.offset_s for r in records] == [float(o) for o in offsets]
        # a stop set before the run ends it with nothing sent
        stop = threading.Event()
        stop.set()
        records, _ = h.run_open_loop_process(
            [stub.base], tlg.paced_schedule(tlg.RateCurve.constant(50.0),
                                            30.0),
            requests * 40, workers=4, stop=stop)
        assert len(records) < len(offsets)
    finally:
        stub.close()


class _DigestStub(_Stub):
    """Answers each POST by its body (429 for a quarter of the bodies):
    an arrival's status names the request, whichever sender sent it."""

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        self._send(429 if zlib.crc32(body) % 4 == 0 else 200)


def _digest_status(req):
    if req.method != "POST":
        return 200
    return 429 if zlib.crc32(json.dumps(req.body).encode()) % 4 == 0 \
        else 200


@pytest.mark.parametrize("processes", [1, 3, 4])
def test_sender_processes_give_one_senders_records_and_report(processes):
    h = _cuda_harness()
    offsets = tlg.paced_schedule(tlg.RateCurve.constant(80.0), 1.0)
    requests = tlg.MixedWorkload(mix={"predict_eta": 0.7, "history": 0.3},
                                 seed=5).sequence(len(offsets))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _DigestStub)
    srv.daemon_threads = True
    srv.delay_s, srv.status = 0.0, 200
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        one = tlg.run_open_loop([base], offsets, requests, workers=8,
                                timeout=10.0)
        many, _ = h.run_open_loop_process([base], offsets, requests,
                                          workers=8, timeout=10.0,
                                          processes=processes)
        # a stop part-way keeps an arrival-ordered subset (the timer
        # counts the senders' spawn too)
        longer = tlg.paced_schedule(tlg.RateCurve.constant(80.0), 5.0)
        stop = threading.Event()
        timer = threading.Timer(3.0, stop.set)
        timer.start()
        cut, _ = h.run_open_loop_process(
            [base], longer, requests * 5, workers=8, timeout=10.0,
            processes=processes, stop=stop)
        timer.join()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)

    def key(r):
        return (r.route, r.offset_s, r.status, r.error)

    want = [(q.route, float(o), _digest_status(q), None)
            for q, o in zip(requests, offsets)]
    assert [key(r) for r in many] == [key(r) for r in one] == want
    rep1 = tlg.summarize(one, 1.0, len(offsets))
    repn = tlg.summarize(many, 1.0, len(offsets))
    for k in ("offered", "sent", "ok", "shed", "errors", "other_4xx"):
        assert repn[k] == rep1[k], k
    assert {r: (v["sent"], v["ok"]) for r, v in repn["routes"].items()} \
        == {r: (v["sent"], v["ok"]) for r, v in rep1["routes"].items()}
    assert repn["shed"] > 0 and repn["ok"] > 0
    assert 0 < len(cut) < len(longer)
    assert [r.offset_s for r in cut] == sorted(r.offset_s for r in cut)
    assert set(key(r) for r in cut) <= {
        (q.route, float(o), _digest_status(q), None)
        for q, o in zip(requests * 5, longer)}


@pytest.mark.parametrize("delay,p50,lagged", [
    (1.2, 1.5, False), (1.5, 1.5, False), (1.51, 1.5, True),
    (7.34, 5.18, True), (None, 1.0, True), (0.5, None, True)])
def test_pace_check_marks_a_generator_past_the_latency_p50(delay, p50,
                                                          lagged):
    h = _cuda_harness()
    rep = {"send_delay": {} if delay is None else {"p99_ms": delay},
           "latency": {} if p50 is None else {"p50_ms": p50}}
    pace = h.pace_check(rep)
    assert pace["generator_lagged"] is lagged
    assert (pace["send_delay_p99_ms"], pace["pace_limit_ms"]) == (delay, p50)
    assert h.passed(True, pace) is (not lagged)


def test_loadgen_and_scripts_import_no_jax():
    code = (
        "import importlib.util, os, sys\n"
        "import routest_tpu_torch.loadgen\n"
        f"repo = {REPO!r}\n"
        "sys.path.insert(0, os.path.join(repo, 'scripts'))\n"
        f"for name in {SCRIPTS!r} + ('cuda_harness.py',):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name[:-3], os.path.join(repo, 'scripts', name))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import cuda_harness\n"
        "cuda_harness.card_identity('cpu')\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'routest_tpu.')) or m == 'routest_tpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_public_names_match():
    assert tlg.__all__ == jlg.__all__
    for name in jlg.__all__:
        assert hasattr(tlg, name)
    assert dataclasses.fields(tlg.RequestRecord) \
        and [f.name for f in dataclasses.fields(tlg.RequestRecord)] \
        == [f.name for f in dataclasses.fields(jlg.RequestRecord)]
    assert tlg.DEFAULT_MIX == jlg.DEFAULT_MIX
    assert tlg.MixedWorkload.KINDS == jlg.MixedWorkload.KINDS
    assert treport.CACHE_FAMILIES == jreport.CACHE_FAMILIES
