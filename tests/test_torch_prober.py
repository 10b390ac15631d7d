"""Blackbox prober: the port's ``obs/prober.py`` against the JAX
package's, case for case.

The hermetic cases of ``tests/test_prober.py`` — verdict sequences,
pinned and re-pinned bands, oracle re-derivation across metric-epoch
flips, fan-out skew needing ``epoch_gap`` and ``skew_after``, the
correctness-page bundle naming the replica, backoff, retry-once, probe
traffic excluded from the user families, the ``skew`` chaos kind and
the gateway arming the prober from the environment — and the dispatch
kind of ``tests/test_dispatch.py`` run once per package with one set of
expectations, over the same stub replicas (or, for the dispatch kind,
each package's own app). The probe bodies and the golden wire frame
are byte-identical to the JAX package's, the golden rows are the port's
``golden_batch()``, and ``eta_divergence`` and the scipy oracle give the
same numbers on the same inputs. Every stub, app thread and prober loop
a test starts is stopped."""

import dataclasses
import http.server
import json
import os
import threading
import time
import types

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu import chaos as jchaos
from routest_tpu.core import config as jconfig
from routest_tpu.obs import prober as jprober
from routest_tpu.obs import recorder as jrecorder
from routest_tpu.obs import registry as jregistry
from routest_tpu.obs import slo as jslo
from routest_tpu.obs.export import TailSampler as JTailSampler
from routest_tpu.serve import ml_service as jml
from routest_tpu.serve import wsgi as jwsgi
from routest_tpu.serve.fleet import gateway as jgw
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.core import config as tconfig
from routest_tpu_torch.obs import prober as tprober
from routest_tpu_torch.obs import recorder as trecorder
from routest_tpu_torch.obs import registry as tregistry
from routest_tpu_torch.obs import slo as tslo
from routest_tpu_torch.obs.export import TailSampler as TTailSampler
from routest_tpu_torch.serve import ml_service as tml
from routest_tpu_torch.serve import wsgi as twsgi
from routest_tpu_torch.serve.fleet import gateway as tgw
from tests import jax_probe_counts

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", prober=jprober, config=jconfig, chaos=jchaos,
        recorder=jrecorder, registry=jregistry.get_registry, slo=jslo,
        wsgi=jwsgi, gw=jgw, ml=jml, TailSampler=JTailSampler),
    "port": types.SimpleNamespace(
        name="port", prober=tprober, config=tconfig, chaos=tchaos,
        recorder=trecorder, registry=tregistry.get_registry, slo=tslo,
        wsgi=twsgi, gw=tgw, ml=tml, TailSampler=TTailSampler),
}
PASS, DIVERGENT, SKEW, UNREACHABLE = ("pass", "divergent", "skew",
                                      "unreachable")
ARTIFACT = "artifacts/eta_mlp.msgpack"


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


# What the JAX probe verdict family held when this module started: the
# module hands it back so (tests/test_prober.py reads it absolutely).
_JAX_CHECKS_AT_START = {}


@pytest.fixture(scope="module", autouse=True)
def _jax_checks_at_start():
    _JAX_CHECKS_AT_START.update(jax_probe_counts.snapshot())
    yield


@pytest.fixture(autouse=True)
def _jax_probe_counts_as_found():
    """Each test leaves the JAX ``rtpu_probe_checks_total`` as it found
    it (its ``jax`` cases count route verdicts, divergent ones too)."""
    with jax_probe_counts.restored():
        yield


# ── stub replica: a controllable, correct-by-construction server ─────
# Chain graph 0↔1↔2, edge metric scales with the stub's epoch; route
# and matrix answers come from the stub's own metric, so the oracle
# agrees unless a bias/skew knob says otherwise.

_SENDERS = [0, 1, 1, 2]
_RECEIVERS = [1, 2, 0, 1]


def _metric(epoch):
    return [10.0 * epoch, 20.0 * epoch, 10.0 * epoch, 20.0 * epoch]


def _route_s(srv):
    return 30.0 * srv.epoch + srv.route_bias


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
        srv = self.server
        if srv.dead:
            return self._send(500, {"error": "injected"})
        path = self.path
        if path.startswith("/api/version"):
            return self._send(200, {"model": {
                "fingerprint": srv.fingerprint,
                "generation": srv.generation}})
        if path.startswith("/api/live"):
            payload = {"enabled": srv.live_enabled, "epoch": srv.epoch}
            if "metric=1" in path and srv.live_enabled:
                payload["edge_time_s"] = srv.metric_fn(srv.epoch)
            return self._send(200, payload)
        if path.startswith("/api/debug/probe_subgraph"):
            return self._send(200, srv.subgraph)
        return self._send(200, {"ok": True})

    def do_POST(self):
        srv = self.server
        n = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(n) or b"{}")
        if srv.dead:
            return self._send(500, {"error": "injected"})
        path = self.path
        if path.startswith("/api/predict_eta_batch"):
            dist = body.get("distance_m") or []
            eta = [d / 1000.0 + srv.skew for d in dist]
            return self._send(200, {
                "count": len(dist),
                "eta_minutes_ml": [round(v, 4) for v in eta],
                "eta_minutes_ml_p10": [round(v - 1.0, 4) for v in eta],
                "eta_minutes_ml_p90": [round(v + 1.0, 4) for v in eta]})
        if path.startswith("/api/request_route"):
            return self._send(200, {"properties": {"summary": {
                "duration": _route_s(srv), "distance": 900.0}}})
        if path.startswith("/api/matrix"):
            d = _route_s(srv)
            return self._send(200, {"durations_s": [[0.0, d], [d, 0.0]]})
        if path.startswith("/api/dispatch"):
            srv.dispatch_calls += 1
            # Solved by the port's host oracle (dispatch_skew perturbs
            # the costs the solve sees — the wrong-plan fault).
            from routest_tpu_torch.dispatch import plan_cost
            from routest_tpu_torch.optimize.vrp import solve_host_dispatch
            m = np.asarray(body["matrix"], np.float32)
            solved = m
            if srv.dispatch_skew:
                rng = np.random.default_rng(0)
                solved = m * (1.0 + srv.dispatch_skew
                              * rng.random(m.shape).astype(np.float32))
            plan = solve_host_dispatch(
                solved, np.asarray(body["demands"], np.float32),
                body["capacity"], body["max_distance"], device="cpu")
            return self._send(200, {
                "mode": "matrix", "plan": plan,
                "cost": round(float(plan_cost(m, plan)), 3)})
        return self._send(200, {"ok": True})


_CHAIN = {"nodes": 3, "edges": 4, "senders": _SENDERS,
          "receivers": _RECEIVERS, "snapped": [0, 2], "snap_m": [0.0, 0.0]}


class _Stubs:
    """Stub replicas started by one test, all stopped at its end."""

    def __init__(self):
        self.servers = []

    def start(self, subgraph=None, metric_fn=_metric):
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                              _StubHandler)
        srv.daemon_threads = True
        srv.dead = False
        srv.skew = 0.0
        srv.route_bias = 0.0
        srv.fingerprint = "fp-a"
        srv.generation = 1
        srv.dispatch_skew = 0.0
        srv.dispatch_calls = 0
        srv.epoch = 1
        srv.live_enabled = True
        srv.subgraph = subgraph or _CHAIN
        srv.metric_fn = metric_fn
        srv.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        srv.thread.start()
        self.servers.append(srv)
        return srv

    def stop(self):
        for srv in self.servers:
            srv.shutdown()
            srv.server_close()
            srv.thread.join(timeout=10)


@pytest.fixture()
def stubs():
    s = _Stubs()
    yield s
    s.stop()


def _base(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _mk_prober(pkg, tmp_path, stubs, gateway=None, **cfg_kw):
    cfg_kw.setdefault("enabled", True)
    cfg_kw.setdefault("eta_tolerance", 5.0)
    cfg_kw.setdefault("timeout_s", 5.0)
    cfg = pkg.config.ProberConfig(**cfg_kw)
    recorder = pkg.recorder.FlightRecorder(pkg.config.RecorderConfig(
        dir=str(tmp_path / "pm"), min_interval_s=0.0))
    targets = [(f"r{i}", _base(s)) for i, s in enumerate(stubs)]
    return pkg.prober.BlackboxProber(
        cfg, gateway_base=_base(gateway or stubs[0]),
        targets_fn=lambda: targets, recorder=recorder), recorder


def _counter(pkg, probe, verdict):
    m = pkg.registry().get("rtpu_probe_checks_total")
    if m is None:
        return 0.0
    for key, child in m.items():
        if key == (probe, verdict):
            return child.value
    return 0.0


# ── byte-identical probes, equal numbers ─────────────────────────────


def test_probe_bodies_and_wire_frame_are_byte_identical():
    assert tprober.golden_probe_body() == jprober.golden_probe_body()
    assert json.dumps(tprober.golden_probe_body()) == \
        json.dumps(jprober.golden_probe_body())
    assert tprober.golden_wire_frame() == jprober.golden_wire_frame()
    dummy = types.SimpleNamespace()
    assert tprober.BlackboxProber.dispatch_probe_body(dummy) == \
        jprober.BlackboxProber.dispatch_probe_body(dummy)
    spec = "14.5,121.0|bad|14.6,121.1;14.7,121.2|,|"
    assert tprober.parse_probe_routes(spec) == \
        jprober.parse_probe_routes(spec) == \
        [(14.5, 121.0), (14.6, 121.1), (14.7, 121.2)]


def test_golden_rows_are_the_ports_golden_batch():
    """The wire probe's rows decode to the port's ``golden_batch()``
    bit for bit: the golden probes and the verified-swap gate score the
    same model inputs."""
    from routest_tpu_torch.serve.wirecodec import decode_eta_request

    req = decode_eta_request(tprober.golden_wire_frame())
    features = np.asarray(req.columns["features"])
    assert features.dtype == np.float32
    assert features.tobytes() == np.asarray(
        tml.golden_batch(), np.float32).tobytes()


def test_eta_columns_and_divergence_equal_jax():
    rng = np.random.default_rng(11)
    n = 32
    payload = {"eta_minutes_ml": rng.random(n).tolist(),
               "eta_minutes_ml_p10": rng.random(n).tolist(),
               "eta_minutes_ml_p90": [None] + rng.random(n - 1).tolist(),
               "eta_completion_time_ml": ["x"] * n, "count": n}
    jcols, tcols = jprober.eta_columns(payload), tprober.eta_columns(payload)
    assert sorted(jcols) == sorted(tcols)
    for k in jcols:
        np.testing.assert_array_equal(tcols[k], jcols[k])
    other = {k: v + rng.normal(0, 3, n) for k, v in jcols.items()}
    finite = {k: v for k, v in other.items() if not k.endswith("p90")}
    for a, b in ((jcols, other), (finite, jcols), (jcols, {}),
                 ({"eta_minutes_ml": jcols["eta_minutes_ml"]},
                  {"eta_minutes_ml_p10": jcols["eta_minutes_ml_p10"]})):
        assert tprober.eta_divergence(a, b) == jprober.eta_divergence(a, b)
    assert tprober.eta_divergence(jcols, other) == float("inf")
    assert tprober.eta_divergence(finite, finite) == 0.0


def _random_subgraph(seed=5, nodes=60, edges=240):
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, nodes, edges).tolist()
    receivers = rng.integers(0, nodes, edges).tolist()
    ring = list(range(nodes))
    senders += ring
    receivers += ring[1:] + ring[:1]
    sub = {"nodes": nodes, "edges": len(senders), "senders": senders,
           "receivers": receivers,
           "snapped": [int(x) for x in rng.choice(nodes, 4, replace=False)],
           "snap_m": np.round(rng.random(4) * 80.0, 3).tolist()}
    metric = np.round(5.0 + rng.random(len(senders)) * 60.0, 4)
    return sub, lambda epoch: (metric * epoch).tolist()


def test_oracle_on_one_exported_subgraph_equals_jax(stubs):
    sub, metric_fn = _random_subgraph()
    stub = stubs.start(subgraph=sub, metric_fn=metric_fn)
    wps = [(14.5, 121.0), (14.6, 121.1), (14.55, 121.05), (14.52, 121.2)]
    oracles = {}
    for name, pkg in PKGS.items():
        oracle = pkg.prober.SubgraphOracle(wps, timeout_s=5.0)
        assert oracle.arm(_base(stub)) is True
        assert oracle.refresh(_base(stub)) == 1
        stub.epoch = 2
        assert oracle.refresh(_base(stub)) == 2
        stub.epoch = 1
        oracles[name] = oracle
    jc, tc = oracles["jax"].candidates(), oracles["port"].candidates()
    assert [e for e, _ in tc] == [e for e, _ in jc] == [2, 1]
    for (_, want), (_, got) in zip(jc, tc):
        assert got.shape == (4, 4)
        assert got.tobytes() == want.tobytes()
    assert np.isfinite(tc[0][1]).all()


# ── verdict state machine ────────────────────────────────────────────


def test_golden_and_fanout_pass_and_repin(pkg, tmp_path, stubs):
    ss = [stubs.start(), stubs.start()]
    prober, _rec = _mk_prober(pkg, tmp_path, ss)
    assert prober.probe_round() == {"golden": PASS, "fanout": PASS,
                                    "dispatch": PASS}
    for s in ss:
        s.skew = 2.0
        s.fingerprint = "fp-b"
    assert prober.probe_round()["golden"] == PASS
    assert np.isclose(prober._pins["golden"]["eta_minutes_ml"][0],
                      0.5 + 2.0)


def test_fanout_divergence_names_the_faulty_replica(pkg, tmp_path, stubs):
    good, bad = stubs.start(), stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [good, bad], gateway=good)
    assert prober.probe_round()["fanout"] == PASS
    bad.skew = 50.0
    verdicts = prober.probe_round()
    assert verdicts["golden"] == PASS
    assert verdicts["fanout"] == DIVERGENT
    ev = prober._state["fanout"]
    assert ev["replicas"] == ["r1"]
    assert ev["divergence"] > 5.0
    assert ev["served"]["r1"] is not None
    assert "expected" in ev


def test_unreachable_verdict_and_500_is_unreachable(pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [stub])
    assert prober.probe_round()["golden"] == PASS
    stub.dead = True
    verdicts = prober.probe_round()
    assert verdicts["golden"] == UNREACHABLE
    assert verdicts["fanout"] == UNREACHABLE


def test_verdict_sequences_equal_jax(tmp_path, stubs):
    """One scripted fault sequence through both packages' probers
    gives the same verdicts round for round."""
    script = [{}, {"skew": 2.0}, {"skew": 40.0}, {"skew": 0.0},
              {"fingerprint": "fp-x"}, {}, {}, {"dead": True},
              {"dead": False}, {"epoch": 4}, {}, {}]
    seqs = {}
    for name, pkg in PKGS.items():
        a, b = stubs.start(), stubs.start()
        prober, _rec = _mk_prober(pkg, tmp_path / name, [a, b],
                                  gateway=a, skew_after=2,
                                  routes="14.5,121.0|14.6,121.1")
        seq = []
        for step in script:
            for k, v in step.items():
                setattr(b, k, v)
            seq.append(prober.probe_round())
        seqs[name] = seq
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"][2]["fanout"] == DIVERGENT
    assert seqs["port"][7]["fanout"] == PASS     # reach is off here
    assert seqs["port"][5]["fanout"] == SKEW     # model, 2 rounds


# ── oracle re-derivation across metric-epoch flips ───────────────────


def _route_prober(pkg, tmp_path, stubs, **kw):
    return _mk_prober(pkg, tmp_path, stubs,
                      routes="14.5,121.0|14.6,121.1", **kw)


def test_route_oracle_rederives_on_epoch_flip_no_false_verdict(
        pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _route_prober(pkg, tmp_path, [stub])
    before = _counter(pkg, "route", PASS)
    div0 = _counter(pkg, "route", DIVERGENT)
    v = prober.probe_round()
    assert v["route"] == PASS and v["matrix"] == PASS
    assert prober.oracle.armed
    assert list(prober.oracle._by_epoch) == [1]
    stub.epoch = 2
    v = prober.probe_round()
    assert v["route"] == PASS and v["matrix"] == PASS
    assert 2 in prober.oracle._by_epoch
    assert _counter(pkg, "route", PASS) == before + 2
    assert _counter(pkg, "route", DIVERGENT) == div0


def test_route_divergence_detected_within_epoch(pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _route_prober(pkg, tmp_path, [stub])
    assert prober.probe_round()["route"] == PASS
    stub.route_bias = 10.0
    v = prober.probe_round()
    assert v["route"] == DIVERGENT
    ev = prober._state["route"]
    assert ev["divergence"] > prober.config.route_tolerance_rel
    assert ev["oracle_epoch"] == 1
    assert ev["served"] == pytest.approx(40.0)
    assert ev["oracle"] == pytest.approx(30.0)


def test_oracle_candidates_cover_previous_epoch(pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _route_prober(pkg, tmp_path, [stub])
    assert prober.probe_round()["route"] == PASS
    stub.epoch = 2
    assert prober.probe_round()["route"] == PASS
    stub.route_bias = 30.0 * 1 - 30.0 * 2
    assert prober.probe_round()["route"] == PASS


def test_pinned_mode_without_road_graph(pkg, tmp_path, stubs):
    stub = stubs.start()
    stub.live_enabled = False
    prober, _rec = _route_prober(pkg, tmp_path, [stub])
    prober.oracle = None
    assert prober.probe_round()["route"] == PASS
    assert prober.probe_round()["route"] == PASS
    stub.route_bias = 10.0
    assert prober.probe_round()["route"] == DIVERGENT


# ── fan-out skew detection ───────────────────────────────────────────


def test_epoch_skew_needs_gap_and_persistence(pkg, tmp_path, stubs):
    lag, fresh = stubs.start(), stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [lag, fresh], skew_after=3)
    lag.epoch, fresh.epoch = 3, 4
    for _ in range(4):
        assert prober.probe_round()["fanout"] == PASS
    fresh.epoch = 6
    assert prober.probe_round()["fanout"] == PASS
    assert prober.probe_round()["fanout"] == PASS
    v = prober.probe_round()
    assert v["fanout"] == SKEW
    ev = prober._state["fanout"]
    assert ev["dimensions"]["epoch"]["replicas"] == ["r0"]
    assert ev["replicas"] == ["r0"]
    m = pkg.registry().get("rtpu_probe_replica_skew")
    values = {key: child.value for key, child in m.items()}
    assert values[("r0", "epoch")] == 1.0
    assert values[("r1", "epoch")] == 0.0


def test_model_skew_minority_fingerprint_named(pkg, tmp_path, stubs):
    a, b, c = stubs.start(), stubs.start(), stubs.start()
    c.fingerprint = "fp-ROGUE"
    prober, _rec = _mk_prober(pkg, tmp_path, [a, b, c], skew_after=2)
    assert prober.probe_round()["fanout"] == PASS
    v = prober.probe_round()
    assert v["fanout"] == SKEW
    assert prober._state["fanout"]["dimensions"]["model"]["replicas"] \
        == ["r2"]


def test_transient_mismatch_never_skews(pkg, tmp_path, stubs):
    a, b = stubs.start(), stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [a, b], skew_after=3)
    b.fingerprint = "fp-new"
    assert prober.probe_round()["fanout"] == PASS
    a.fingerprint = "fp-new"
    for _ in range(4):
        assert prober.probe_round()["fanout"] == PASS
    assert prober._skew_rounds["model"] == 0


# ── correctness page → evidence bundle ───────────────────────────────


def test_correctness_page_writes_bundle_naming_replica(pkg, tmp_path,
                                                       stubs):
    good, bad = stubs.start(), stubs.start()
    prober, recorder = _mk_prober(
        pkg, tmp_path, [good, bad], gateway=good,
        fast_window_s=2.0, slow_window_s=4.0)
    assert prober.probe_round()["fanout"] == PASS
    bad.skew = 60.0
    for _ in range(4):
        prober.probe_round()
        time.sleep(0.05)
    root = str(tmp_path / "pm")
    bundles = sorted(d for d in os.listdir(root)
                     if "correctness-page" in d or "correctness_page" in d)
    assert bundles, os.listdir(root)
    bundle = os.path.join(root, bundles[-1])
    with open(os.path.join(bundle, "probe_evidence.json")) as f:
        evidence = json.load(f)
    assert "r1" in evidence["replicas"]
    failures = evidence["failures"]
    assert failures and failures[-1]["verdict"] == DIVERGENT
    assert failures[-1]["divergence"] > 5.0
    assert failures[-1]["expected"]
    assert failures[-1]["served"]["r1"]
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == "correctness_page"
    assert manifest["detail"]["replicas"] == ["r1"]
    comps = [s.get("component") for s in manifest["slo"]]
    assert "prober" in comps


# ── bounded probe rate / backoff under a down fleet ──────────────────


def test_backoff_doubles_to_cap_and_resets(pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [stub], interval_s=1.0,
                              backoff_cap_s=4.0)
    stub.dead = True
    prober.probe_round()
    assert prober._interval == 2.0
    prober.probe_round()
    assert prober._interval == 4.0
    prober.probe_round()
    assert prober._interval == 4.0
    stub.dead = False
    prober.probe_round()
    assert prober._interval == 1.0


def test_failed_probe_is_retried_once_before_recording(pkg, tmp_path,
                                                       stubs):
    stub = stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [stub])
    assert prober.probe_round()["golden"] == PASS
    calls = {"n": 0}
    real = prober._probe_golden

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            return UNREACHABLE, {"error": "blip"}
        return real()

    prober._probe_golden = flaky
    assert prober._checked("golden", prober._probe_golden) == PASS
    assert calls["n"] == 2


# ── tag-and-exclude: probe traffic never burns user budget ───────────


def test_probe_error_storm_leaves_replica_user_slo_ok(pkg):
    app = pkg.wsgi.App()

    @app.route("/api/predict_eta", methods=("POST",))
    def boom(request):
        return {"error": "injected"}, 500

    client = Client(app)
    for _ in range(25):
        r = client.post("/api/predict_eta", json={},
                        headers={"X-RTPU-Probe": "golden"})
        assert r.status_code == 500
    snap = app.request_stats.snapshot()["routes"]
    assert snap.get("POST /api/predict_eta", {"count": 0})["count"] == 0
    engine = pkg.slo.build_replica_engine(app.request_stats.registry)
    engine.tick()
    time.sleep(0.02)
    engine.tick()
    assert engine.worst_state() == "ok"
    m = pkg.registry().get("rtpu_probe_replica_requests_total")
    total = sum(c.value for k, c in m.items()
                if k == ("POST /api/predict_eta",))
    assert total >= 25
    client.post("/api/predict_eta", json={})
    snap = app.request_stats.snapshot()["routes"]
    assert snap["POST /api/predict_eta"]["count"] == 1


def test_probe_traffic_excluded_from_gateway_families(pkg, stubs):
    stub = stubs.start()
    stub.dead = True
    gw = pkg.gw.Gateway([("127.0.0.1", stub.server_address[1])],
                        pkg.config.FleetConfig(hedge=False))
    reg = pkg.registry()

    def fam_count(name, route):
        m = reg.get(name)
        total = 0.0
        for key, child in (m.items() if m is not None else ()):
            if key and key[0] == route:
                total += getattr(child, "count", None) or child.value
        return total

    route = "/api/predict_eta"
    before_user = fam_count("rtpu_gateway_request_seconds", route)
    before_err = fam_count("rtpu_gateway_request_errors_total", route)
    before_probe = fam_count("rtpu_probe_gateway_requests_total", route)
    try:
        for _ in range(10):
            status, _rh, _data = gw.handle(
                "POST", route, b"{}",
                {"X-RTPU-Probe": "golden",
                 "Content-Type": "application/json"}, None)
            assert status >= 500
        assert fam_count("rtpu_gateway_request_seconds",
                         route) == before_user
        assert fam_count("rtpu_gateway_request_errors_total",
                         route) == before_err
        assert fam_count("rtpu_probe_gateway_requests_total",
                         route) == before_probe + 10
        gw.handle("POST", route, b"{}", {}, None)
        assert fam_count("rtpu_gateway_request_seconds",
                         route) == before_user + 1
    finally:
        for r in gw.replicas:
            drop = getattr(r, "drop_conns", None)
            if drop is not None:
                drop()


def test_tail_sampler_retains_probe_traces(pkg):
    sampler = pkg.TailSampler(default_slow_ms=10_000.0, reservoir=0.0)
    kept = sampler.offer({"trace_id": "t1", "parent_id": None,
                          "duration_ms": 1.0, "name": "replica.request",
                          "attrs": {"probe": "golden"}})
    assert kept is not None and kept[0] == "probe"
    dropped = sampler.offer({"trace_id": "t2", "parent_id": None,
                             "duration_ms": 1.0,
                             "name": "replica.request", "attrs": {}})
    assert dropped is None


# ── chaos `skew` kind: the silently-wrong device ─────────────────────


def test_chaos_skew_perturbs_batcher_outputs_deterministically(pkg):
    engine = pkg.chaos.ChaosEngine("device.compute:skew=1.0/7.5", seed=3)
    pkg.chaos.configure(engine)
    try:
        b = pkg.ml.DynamicBatcher(lambda x: np.asarray(x)[:, 0] * 0.0,
                                  buckets=(8,), max_batch=8,
                                  max_wait_ms=1.0)
        out = b.submit(np.ones((3, 12), np.float32))
        assert np.allclose(out, 7.5)
        snap = engine.snapshot()["device.compute"]
        assert snap["rules"][0]["fired"] >= 1
    finally:
        pkg.chaos.configure(None)


def test_chaos_skew_inert_without_spec(pkg):
    engine = pkg.chaos.ChaosEngine("", seed=0)
    assert engine.inject("device.compute") == 0.0


# ── the gateway arms the prober from the environment ─────────────────


def test_gateway_serve_arms_prober_from_env(pkg, monkeypatch, stubs):
    import urllib.request

    stub = stubs.start()
    monkeypatch.setenv("RTPU_PROBER", "1")
    monkeypatch.setenv("RTPU_PROBER_INTERVAL_S", "0.3")
    monkeypatch.setenv("RTPU_PROBER_ETA_TOL_MIN", "5")
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    monkeypatch.setenv("RTPU_SLO", "0")
    gw = pkg.gw.Gateway([("127.0.0.1", stub.server_address[1])],
                        pkg.config.FleetConfig(hedge=False))
    httpd = gw.serve("127.0.0.1", 0)
    try:
        assert gw.prober is not None
        assert gw.prober.gateway_base == \
            f"http://127.0.0.1:{httpd.server_address[1]}"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and gw.prober._rounds == 0:
            time.sleep(0.1)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}"
                "/api/probes", timeout=5) as r:
            snap = json.loads(r.read())
        assert snap["rounds"] >= 1
        assert snap["probes"]["golden"]["verdict"] == PASS
    finally:
        gw.drain(timeout=5)
        for r in gw.replicas:
            drop = getattr(r, "drop_conns", None)
            if drop is not None:
                drop()
    assert gw.prober._stop is None


def test_dispatch_retry_lands_on_the_healthy_replica_at_rest(
        pkg, tmp_path, stubs, monkeypatch):
    """ROADMAP Queue C 16, decided as the reference has it: the prober
    re-probes a non-pass verdict once, through the gateway, whose
    round-robin tie-break sends the retry to the other replica. Two
    stub replicas, one answering the dispatch probe with a wrong plan:
    at rest every round records a pass in both packages, though the
    wrong replica answered dispatch probes and a bare probe of it is
    divergent."""
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    monkeypatch.setenv("RTPU_SLO", "0")
    good, bad = stubs.start(), stubs.start()
    bad.dispatch_skew = 1.0
    bare, _rec = _mk_prober(pkg, tmp_path / "bare", [bad],
                            route_tolerance_rel=1e-3)
    assert bare._probe_dispatch()[0] == DIVERGENT
    bad.dispatch_calls = 0
    gw = pkg.gw.Gateway([("127.0.0.1", s.server_address[1])
                         for s in (good, bad)],
                        pkg.config.FleetConfig(hedge=False))
    httpd = gw.serve("127.0.0.1", 0)
    try:
        cfg = pkg.config.ProberConfig(enabled=True, eta_tolerance=5.0,
                                      timeout_s=5.0,
                                      route_tolerance_rel=1e-3)
        recorder = pkg.recorder.FlightRecorder(pkg.config.RecorderConfig(
            dir=str(tmp_path / "pm"), min_interval_s=0.0))
        targets = [("r0", _base(good)), ("r1", _base(bad))]
        prober = pkg.prober.BlackboxProber(
            cfg, gateway_base=f"http://127.0.0.1:{httpd.server_address[1]}",
            targets_fn=lambda: targets, recorder=recorder)
        verdicts = [prober.probe_round()["dispatch"] for _ in range(6)]
    finally:
        gw.drain(timeout=5)
        for r in gw.replicas:
            drop = getattr(r, "drop_conns", None)
            if drop is not None:
                drop()
    assert verdicts == [PASS] * 6
    assert bad.dispatch_calls >= 3 and good.dispatch_calls >= 3
    assert not [f for f in prober._failures if f["probe"] == "dispatch"]


# ── snapshot surface ─────────────────────────────────────────────────


def test_snapshot_shape(pkg, tmp_path, stubs):
    stub = stubs.start()
    prober, _rec = _mk_prober(pkg, tmp_path, [stub])
    prober.probe_round()
    snap = prober.snapshot()
    assert snap["kinds"] == ["golden", "fanout", "dispatch"]
    assert snap["rounds"] == 1
    assert snap["probes"]["golden"]["verdict"] == PASS
    assert "served" not in snap["probes"]["golden"]
    assert snap["slo"]["component"] == "prober"
    assert "correctness:golden" in snap["slo"]["objectives"]


def test_wire_kind_armed_by_rtpu_wire(pkg, tmp_path, stubs, monkeypatch):
    monkeypatch.setenv("RTPU_WIRE", "1")
    prober, _rec = _mk_prober(pkg, tmp_path, [stubs.start()])
    assert prober.kinds == ["golden", "fanout", "dispatch", "wire"]


# ── the dispatch kind against each package's own app ─────────────────


def _dispatch_app(pkg, enabled=True):
    from routest_tpu.serve.app import create_app as jcreate
    from routest_tpu.serve.bus import InMemoryBus as JBus
    from routest_tpu_torch.serve.app import create_app as tcreate
    from routest_tpu_torch.serve.bus import InMemoryBus as TBus

    c = pkg.config
    cfg = c.Config(serve=c.ServeConfig(batch_buckets=(8,)),
                   dispatch=c.DispatchConfig(enabled=enabled,
                                             reopt_poll_s=0.0))
    if pkg.name == "jax":
        eta = jml.EtaService(cfg.serve, model_path=ARTIFACT)
        return jcreate(cfg, eta_service=eta, bus=JBus(),
                       sim_tick_range=(0.001, 0.002))
    cfg = dataclasses.replace(cfg, serve=c.ServeConfig(
        batch_buckets=(8,), device="cpu"))
    eta = tml.EtaService(cfg.serve, model_path=ARTIFACT, device="cpu")
    return tcreate(cfg, eta_service=eta, bus=TBus(),
                   sim_tick_range=(0.001, 0.002))


def _close_app(app):
    """Stop an app's background threads (the JAX app has no close())."""
    close = getattr(app, "close", None)
    if close is not None:
        return close()
    for part in ("slo", "timeline", "efficiency", "change_ledger"):
        obj = getattr(app, part, None)
        if obj is not None:
            obj.stop()
    dispatch = getattr(app, "dispatch", None)
    if dispatch is not None and getattr(dispatch, "reopt", None):
        dispatch.reopt.stop()


@pytest.fixture()
def quiet_apps(monkeypatch):
    """Apps without tickers: no SLO or timeline threads to stop."""
    monkeypatch.setenv("RTPU_SLO_TICK_S", "0")
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    apps = []
    yield apps
    for app in apps:
        _close_app(app)


def _through(client):
    def fake_http(method, url, body, timeout, probe=None):
        path = url.split("http://gw", 1)[1]
        r = client.post(path, json=body) if method == "POST" \
            else client.get(path)
        return r.get_json(), {}
    return fake_http


def test_prober_dispatch_kind_pass_and_divergent(pkg, tmp_path,
                                                 monkeypatch, quiet_apps):
    app = _dispatch_app(pkg)
    quiet_apps.append(app)
    client = Client(app)
    monkeypatch.setattr(pkg.prober, "_http_json", _through(client))
    prober = pkg.prober.BlackboxProber(
        pkg.config.ProberConfig(enabled=True, timeout_s=5.0),
        gateway_base="http://gw", targets_fn=lambda: [],
        recorder=pkg.recorder.FlightRecorder(pkg.config.RecorderConfig(
            dir=str(tmp_path / "rec"), min_interval_s=0.0)))
    assert prober._dispatch_armed() is True
    verdict, ev = prober._probe_dispatch()
    assert verdict == PASS, ev
    assert ev["divergence"] <= ev["tolerance"]
    pkg.chaos.configure(pkg.chaos.ChaosEngine(
        "dispatch.solve:skew=1.0/80", seed=5))
    try:
        verdict, ev = prober._probe_dispatch()
    finally:
        pkg.chaos.configure(None)
    assert verdict == DIVERGENT, ev
    assert ev["served_plan"] is not None
    assert ev["expected_plan"] is not None


def test_prober_dispatch_kind_stands_down_when_disabled(
        pkg, tmp_path, monkeypatch, quiet_apps):
    app = _dispatch_app(pkg, enabled=False)
    quiet_apps.append(app)
    client = Client(app)
    assert client.get("/api/dispatch").get_json() == {"enabled": False}
    assert client.post("/api/dispatch", json={}).status_code == 503
    monkeypatch.setattr(pkg.prober, "_http_json", _through(client))
    prober = pkg.prober.BlackboxProber(
        pkg.config.ProberConfig(enabled=True, timeout_s=5.0),
        gateway_base="http://gw", targets_fn=lambda: [],
        recorder=pkg.recorder.FlightRecorder(pkg.config.RecorderConfig(
            dir=str(tmp_path / "rec"), min_interval_s=0.0)))
    assert prober._dispatch_armed() is False
    assert "dispatch" not in prober.probe_round()


def test_jax_probe_checks_left_as_found(tmp_path, stubs):
    """Runs last: every earlier case of this module (the ``jax``
    divergent-route one among them) left the JAX verdict family as the
    module found it, and a divergent JAX round inside ``restored()``
    counts while it runs and is gone after."""
    assert jax_probe_counts.snapshot() == _JAX_CHECKS_AT_START
    pkg = PKGS["jax"]
    before = _counter(pkg, "route", DIVERGENT)
    with jax_probe_counts.restored():
        stub = stubs.start()
        prober, _rec = _route_prober(pkg, tmp_path, [stub])
        assert prober.probe_round()["route"] == PASS
        stub.route_bias = 10.0
        assert prober.probe_round()["route"] == DIVERGENT
        assert _counter(pkg, "route", DIVERGENT) == before + 1
    assert _counter(pkg, "route", DIVERGENT) == before
    assert jax_probe_counts.snapshot() == _JAX_CHECKS_AT_START
