"""Geo-front: the port's ``serve/fleet/geofront.py`` against the JAX
package's, case for case, and two real port apps as regions.

The geo-front cases of ``tests/test_region.py`` — routing by query and
header, failover and the 503 when nothing is healthy, the write journal
replayed into a rejoined region, its bound and counted drops, probe
posts kept out of it, region-labelled rollups, ``/up`` and
``/api/regions``, ``kill_region``'s chaos record and health flip, the
cross-region prober's ``reach`` dimension, the region label on a
gateway's snapshot, the ``RTPU_REGION*`` loader and the refusal of
fewer than two distinct regions — run once per package over the same
stub regions, with one set of expectations. Then two port apps on the
CPU, served in-process, act as regions behind the port's front with a
port bridge between their buses: a write taken while one region is
down is read back from it after the replay. Every front, stub, app
thread and bridge a test starts is stopped."""

import http.server
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from routest_tpu import chaos as jchaos
from routest_tpu.core import config as jconfig
from routest_tpu.obs import prober as jprober
from routest_tpu.serve.fleet import gateway as jgw
from routest_tpu.serve.fleet import geofront as jgeo
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.core import config as tconfig
from routest_tpu_torch.obs import prober as tprober
from routest_tpu_torch.serve.fleet import gateway as tgw
from routest_tpu_torch.serve.fleet import geofront as tgeo
from tests import jax_probe_counts

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

PKGS = {
    "jax": types.SimpleNamespace(geo=jgeo, config=jconfig, chaos=jchaos,
                                 prober=jprober, gw=jgw),
    "port": types.SimpleNamespace(geo=tgeo, config=tconfig, chaos=tchaos,
                                  prober=tprober, gw=tgw),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _jax_probe_counts_as_found():
    """Each test leaves the JAX ``rtpu_probe_checks_total`` as it found
    it (tests/test_prober.py reads it absolutely)."""
    with jax_probe_counts.restored():
        yield


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


def _get(url, timeout=5.0, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), dict(r.headers.items())


def _post(url, body, timeout=5.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), dict(r.headers.items())


def _wait(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


# ── geo-front over stub regions ──────────────────────────────────────


class _StubRegion:
    """A minimal 'fleet gateway': /up, rollup surfaces, mutation
    capture, and the prober's fan-out endpoints."""

    def __init__(self, name: str, port: int = 0):
        self.name = name
        self.posts = []
        self.slo_state = "ok"
        stub = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, payload, status=200):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                bare = self.path.split("?", 1)[0]
                if bare == "/up":
                    return self._json({"status": "ok"})
                if bare == "/api/ping":
                    return self._json({"pong": True, "who": stub.name})
                if bare == "/api/live":
                    return self._json({"enabled": False})
                if bare == "/api/version":
                    return self._json(
                        {"model": {"fingerprint": "fp0", "generation": 1}})
                if bare == "/api/efficiency":
                    return self._json({
                        "region": stub.name,
                        "fleet": {"programs": {
                            "eta": {"rows": 10, "padded_rows": 12}}},
                        "replicas": {}})
                if bare == "/api/slo":
                    return self._json({"objectives": {
                        "availability": {"state": stub.slo_state}}})
                if bare == "/api/timeline":
                    return self._json({"scope": "fleet",
                                       "region": stub.name,
                                       "frames": [{"t": 1.0, "v": 1}]})
                self._json({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                bare = self.path.split("?", 1)[0]
                stub.posts.append((bare, body))
                if bare == "/api/predict_eta_batch":
                    n = len(body.get("weather") or [])
                    return self._json({"eta_minutes_ml": [10.0] * n})
                self._json({"status": "ok", "who": stub.name})

        self.httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), H)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.base = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
            self._thread.join(timeout=10)


def _region_config(pkg, **over):
    kw = dict(enabled=True, regions=("east", "west"), default="east",
              health_s=0.05, unhealthy_after=2, failover=True,
              journal_limit=8, replay_s=0.05)
    kw.update(over)
    return pkg.config.RegionConfig(**kw)


@pytest.fixture()
def geo(pkg):
    east, west = _StubRegion("east"), _StubRegion("west")
    stubs = [east, west]
    front = pkg.geo.GeoFront(
        [pkg.geo.RegionHandle("east", east.base),
         pkg.geo.RegionHandle("west", west.base)],
        _region_config(pkg))
    front.serve("127.0.0.1", 0)
    assert _wait(lambda: front.healthy("east") and front.healthy("west"))
    yield front, east, west, stubs
    front.drain(timeout=2.0)
    for stub in stubs:
        stub.stop()


def test_front_routes_by_query_and_header(geo):
    front, east, west, _ = geo
    payload, headers = _get(f"{front.base}/api/ping?region=west")
    assert payload["who"] == "west"
    assert headers["X-RTPU-Served-Region"] == "west"
    payload, _ = _get(f"{front.base}/api/ping",
                      headers={"X-RTPU-Region": "west"})
    assert payload["who"] == "west"
    payload, headers = _get(f"{front.base}/api/ping")
    assert headers["X-RTPU-Served-Region"] == "east"
    assert front.route("nowhere")[0].name == "east"


def test_front_fails_over_and_503s_when_nothing_is_healthy(pkg, geo):
    front, east, west, _ = geo
    m = pkg.geo._front_metrics()
    f0 = m["failover"].labels(src="west", dst="east").value
    west.stop()
    assert _wait(lambda: not front.healthy("west"))
    payload, headers = _get(f"{front.base}/api/ping?region=west")
    assert payload["who"] == "east"
    assert headers["X-RTPU-Served-Region"] == "east"
    assert m["failover"].labels(src="west", dst="east").value >= f0 + 1
    east.stop()
    assert _wait(lambda: not front.healthy("east"))
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(f"{front.base}/api/ping")
    assert exc.value.code == 503
    assert json.loads(exc.value.read())["error"] == "no healthy region"


def test_front_journal_replays_into_rejoined_region(geo):
    front, east, west, stubs = geo
    port = west.port
    west.stop()
    assert _wait(lambda: not front.healthy("west"))
    body = {"route_id": "r1", "driver_name": "x"}
    payload, _ = _post(f"{front.base}/api/update_tracker?region=east",
                       body)
    assert payload["who"] == "east"
    assert front.journal_depth("west") == 1
    assert front.journal_depth("east") == 0
    west2 = _StubRegion("west", port=port)
    stubs.append(west2)
    assert _wait(lambda: front.healthy("west"))
    assert _wait(lambda: ("/api/update_tracker", body) in west2.posts)
    assert _wait(lambda: front.journal_depth("west") == 0)


def test_front_journal_bounded_and_drops_counted(pkg, geo):
    front, east, west, _ = geo
    west.stop()
    assert _wait(lambda: not front.healthy("west"))
    m = pkg.geo._front_metrics()
    dropped0 = m["journal_dropped"].labels(region="west").value
    n = front.config.journal_limit + 3
    for i in range(n):
        _post(f"{front.base}/api/confirm_route", {"i": i})
    assert front.journal_depth("west") == front.config.journal_limit
    assert m["journal_dropped"].labels(region="west").value == dropped0 + 3
    assert m["journal_depth"].labels(region="west").value == \
        front.config.journal_limit


def test_front_probe_posts_are_not_journaled(pkg, geo):
    front, east, west, _ = geo
    assert "/api/probe" not in pkg.geo.REPLICATED_POSTS
    assert tgeo.REPLICATED_POSTS == jgeo.REPLICATED_POSTS
    _post(f"{front.base}/api/probe", {"driver": "d", "obs": [[1, 5.0]]})
    assert front.journal_depth("west") == 0


def test_front_merged_rollups_carry_region_labels(geo):
    front, east, west, _ = geo
    eff, _ = _get(f"{front.base}/api/efficiency")
    assert set(eff["regions"]) == {"east", "west"}
    rows = eff["programs"]["eta"]
    assert sorted(r["region"] for r in rows) == ["east", "west"]
    only, _ = _get(f"{front.base}/api/efficiency?region=west")
    assert set(only["regions"]) == {"west"}
    tl, _ = _get(f"{front.base}/api/timeline?scope=region")
    assert {f["region"] for f in tl["frames"]} == {"east", "west"}
    west.slo_state = "page"
    slo, _ = _get(f"{front.base}/api/slo")
    assert slo["worst"] == "page"
    assert slo["worst_region"] == "west"
    changes, _ = _get(f"{front.base}/api/changes")
    assert changes["scope"] == "geo"
    assert sorted(changes["degraded_regions"]) == ["east", "west"]
    incidents, _ = _get(f"{front.base}/api/incidents")
    assert incidents["scope"] == "geo"


def test_front_up_and_regions_snapshot(geo):
    front, east, west, _ = geo
    up, _ = _get(f"{front.base}/up")
    assert sorted(up["healthy_regions"]) == ["east", "west"]
    snap, _ = _get(f"{front.base}/api/regions")
    assert snap == {
        "component": "geofront", "default": "east", "failover": True,
        "regions": {n: {"base": s.base, "up": True, "fails": 0,
                        "staleness_s": 0.0, "journal_depth": 0}
                    for n, s in (("east", east), ("west", west))}}


def test_kill_region_records_chaos_and_flips_health(pkg, geo):
    front, east, west, _ = geo
    killed = []

    def _kill():
        killed.append("west")
        west.stop()

    front.by_name["west"].kill = _kill
    child = pkg.chaos._INJECTIONS.labels(point="region.kill", kind="kill")
    before = child.value
    front.kill_region("west")
    assert killed == ["west"]
    assert child.value == before + 1
    assert not front.healthy("west")
    payload, _ = _get(f"{front.base}/api/ping?region=west")
    assert payload["who"] == "east"


def test_rejoin_region_respawns_and_health_returns(geo):
    front, east, west, stubs = geo
    port = west.port
    front.by_name["west"].kill = west.stop
    front.by_name["west"].rejoin = \
        lambda: stubs.append(_StubRegion("west", port=port))
    front.kill_region("west")
    _post(f"{front.base}/api/confirm_route?region=west", {"k": 1})
    assert front.journal_depth("west") == 1
    front.rejoin_region("west")
    assert _wait(lambda: front.healthy("west"))
    assert _wait(lambda: front.journal_depth("west") == 0)
    assert ("/api/confirm_route", {"k": 1}) in stubs[-1].posts


class _HeldConn:
    """A health poll's connection whose ``/up`` answer (200) waits for
    ``release``: a poll caught in flight."""

    def __init__(self, sent, release):
        self._sent, self._release = sent, release

    def request(self, method, path):
        self._sent.set()

    def getresponse(self):
        assert self._release.wait(10)
        return types.SimpleNamespace(status=200,
                                     read=lambda: b'{"enabled": false}')

    def close(self):
        pass


def _region_kinds(ledger):
    return [e["kind"] for e in ledger.events()
            if e["kind"].startswith("region.")]


def test_poll_in_flight_across_a_kill_is_no_rejoin(monkeypatch):
    """A health poll sent before ``kill_region`` and answered after it
    (the region's server replied on its way down) neither marks the
    region up nor records a ``region.rejoin`` that would outrank the
    kill as an incident's suspect; a poll sent after the kill still
    brings a region that answers back. The JAX front applies such a
    late reply (docs/torch/ROBUSTNESS.md)."""
    from routest_tpu_torch.obs.ledger import (ChangeLedger,
                                              configure_change_ledger)
    from routest_tpu_torch.obs.registry import MetricsRegistry

    ledger = ChangeLedger(config=tconfig.LedgerConfig(
        enabled=True, capacity=64, window_s=900.0, max_suspects=5,
        publish=False, channel="rtpu.changes", incidents_kept=8,
        region=""), registry=MetricsRegistry())
    prev = configure_change_ledger(ledger)
    try:
        sent, release = threading.Event(), threading.Event()
        monkeypatch.setattr(tgeo, "_fresh_conn",
                            lambda *a, **k: _HeldConn(sent, release))
        front = tgeo.GeoFront([
            tgeo.RegionHandle("east", "http://127.0.0.1:1", kill=lambda: 0),
            tgeo.RegionHandle("west", "http://127.0.0.1:2")])
        east = front.by_name["east"]
        poll = threading.Thread(target=front._poll_region, args=(east,))
        poll.start()
        assert sent.wait(10)
        front.kill_region("east")
        release.set()
        poll.join(10)
        assert not front.healthy("east")
        assert _region_kinds(ledger) == ["region.kill"]
        front._poll_region(east)          # the region answers again
        assert front.healthy("east")
        assert _region_kinds(ledger) == ["region.kill", "region.rejoin"]
    finally:
        configure_change_ledger(prev)


# ── cross-region fan-out prober: the reach dimension ─────────────────


def _dead_base():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def test_prober_reach_dimension_names_dead_region(pkg):
    east = _StubRegion("east")
    try:
        targets = [("east", east.base), ("west", _dead_base())]
        cfg = pkg.config.ProberConfig(enabled=True, fanout_reach=True,
                                      skew_after=1, timeout_s=2.0,
                                      interval_s=60.0)
        prober = pkg.prober.BlackboxProber(cfg, gateway_base=east.base,
                                           targets_fn=lambda: targets)
        verdict, evidence = prober._probe_fanout(targets)
        assert verdict == "skew"
        reach = evidence["dimensions"]["reach"]
        assert reach["replicas"] == ["west"]
        assert "west" in reach["errors"]
        legacy = pkg.prober.BlackboxProber(
            pkg.config.ProberConfig(enabled=True, skew_after=1,
                                    timeout_s=2.0, interval_s=60.0),
            gateway_base=east.base, targets_fn=lambda: targets)
        verdict, _ = legacy._probe_fanout(targets)
        assert verdict == "pass"
    finally:
        east.stop()


def test_front_arm_prober_targets_region_gateways(pkg, geo):
    front, east, west, _ = geo
    cfg = pkg.config.ProberConfig(enabled=True, fanout_reach=True,
                                  skew_after=1, timeout_s=2.0,
                                  interval_s=3600.0)
    prober = front.arm_prober(cfg)
    try:
        assert prober.targets_fn() == [("east", east.base),
                                       ("west", west.base)]
        assert prober.gateway_base == front.base
        snap, _ = _get(f"{front.base}/api/probes")
        assert snap["kinds"] == ["golden", "fanout", "dispatch"]
        assert _get(f"{front.base}/api/regions")[0]["prober"] == \
            {"armed": True}
        west.stop()
        assert prober.probe_round()["fanout"] == "skew"
        assert prober._skew_offenders["reach"] == ["west"]
    finally:
        prober.stop()


# ── region labels + config plumbing ──────────────────────────────────


def test_gateway_snapshot_carries_region_label(pkg):
    gw = pkg.gw.Gateway([("127.0.0.1", 9)],
                        pkg.config.FleetConfig(region="east"))
    assert gw.snapshot()["fleet"]["region"] == "east"
    bare = pkg.gw.Gateway([("127.0.0.1", 9)], pkg.config.FleetConfig())
    assert "region" not in bare.snapshot()["fleet"]


@pytest.mark.parametrize("env", [
    {"RTPU_REGIONS": " east, west ,east ", "RTPU_REGION_STALE_BOUND_S": "45"},
    {"RTPU_REGIONS": "solo"},
    {},
    {"RTPU_REGIONS": "a,b,c", "RTPU_REGION_DEFAULT": "c",
     "RTPU_REGION_FRONT_PORT": "18090", "RTPU_REGION_BRIDGE": "0",
     "RTPU_REGION_HEALTH_S": "0.25", "RTPU_REGION_UNHEALTHY_AFTER": "5",
     "RTPU_REGION_FAILOVER": "0", "RTPU_REGION_JOURNAL_LIMIT": "16",
     "RTPU_REGION_REPLAY_S": "0.1", "RTPU_REGION_PROBER": "1",
     "RTPU_REGION_BRIDGE_CHANNEL": "x", "RTPU_REGION_FRONT_HOST": "0.0.0.0"},
    {"RTPU_REGIONS": "a,b", "RTPU_REGION_DEFAULT": "zz",
     "RTPU_REGION_HEALTH_S": "junk"},
])
def test_load_region_config_equals_jax(env):
    want = jconfig.load_region_config(env)
    got = tconfig.load_region_config(env)
    assert got.__dict__ == want.__dict__
    assert tconfig.load_config(env).region == got


def test_load_region_config_parses_and_dedupes(pkg):
    rc = pkg.config.load_region_config(
        {"RTPU_REGIONS": " east, west ,east ",
         "RTPU_REGION_STALE_BOUND_S": "45"})
    assert rc.enabled
    assert rc.regions == ("east", "west")
    assert rc.default == "east"
    assert rc.stale_bound_s == 45.0
    assert not pkg.config.load_region_config({"RTPU_REGIONS": "solo"}).enabled
    assert not pkg.config.load_region_config({}).enabled


def test_geofront_requires_two_distinct_regions(pkg):
    with pytest.raises(ValueError):
        pkg.geo.GeoFront([pkg.geo.RegionHandle("a", "http://127.0.0.1:1")])
    with pytest.raises(ValueError):
        pkg.geo.GeoFront([pkg.geo.RegionHandle("a", "http://127.0.0.1:1"),
                          pkg.geo.RegionHandle("a", "http://127.0.0.1:2")])


def test_geofront_main_refuses_without_regions(pkg, monkeypatch):
    monkeypatch.delenv("RTPU_REGIONS", raising=False)
    with pytest.raises(SystemExit) as exc:
        pkg.geo.main()
    assert exc.value.code == 2


def test_fleet_process_spawns_its_packages_fleet(pkg, monkeypatch):
    seen = {}

    class _Popen:
        def __init__(self, argv, env=None, start_new_session=False):
            seen.update(argv=argv, env=env, session=start_new_session)
            self.pid = 0

        def poll(self):
            return None

    monkeypatch.setattr(pkg.geo.subprocess, "Popen", _Popen)
    fleet = pkg.geo.FleetProcess("east", gateway_port=18101,
                                 base_port=15201, replicas=1,
                                 redis_url="tcp://127.0.0.1:1", env={})
    fleet.start()
    module = pkg.geo.__name__.rsplit(".", 1)[0]
    assert seen["argv"][1:] == ["-m", module]
    assert seen["session"] is True
    assert {k: seen["env"][k] for k in (
        "RTPU_REGION", "RTPU_GATEWAY_PORT", "RTPU_FLEET_BASE_PORT",
        "RTPU_FLEET_REPLICAS", "REDIS_URL")} == {
        "RTPU_REGION": "east", "RTPU_GATEWAY_PORT": "18101",
        "RTPU_FLEET_BASE_PORT": "15201", "RTPU_FLEET_REPLICAS": "1",
        "REDIS_URL": "tcp://127.0.0.1:1"}
    assert fleet.base == "http://127.0.0.1:18101"


# ── two real port apps as regions ────────────────────────────────────


class _AppRegion:
    """A port app (CPU) served in-process; ``stop`` and ``start`` take
    the listener down and bring it back on the same port."""

    def __init__(self, app):
        self.app = app
        self.port = 0
        self.server = None
        self.start()

    def start(self):
        from routest_tpu_torch.serve.wsgi import make_server

        self.server = make_server(self.app, "127.0.0.1", self.port)
        self.port = self.server.server_port
        self.base = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=10)
            self.server = None


def _optimize_body():
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    return {"source_point": {"lat": SEED_LOCATIONS[0][1],
                             "lon": SEED_LOCATIONS[0][2]},
            "destination_points": [
                {"lat": SEED_LOCATIONS[i][1], "lon": SEED_LOCATIONS[i][2],
                 "payload": 1} for i in (3, 7)],
            "driver_details": {"driver_name": "geo", "vehicle_type": "car",
                               "vehicle_capacity": 10,
                               "maximum_distance": 150_000.0}}


def test_real_port_apps_behind_the_front(monkeypatch):
    from routest_tpu_torch.core.config import (Config, DispatchConfig,
                                               ServeConfig)
    from routest_tpu_torch.live.bridge import ProbeBridge
    from routest_tpu_torch.serve.app import create_app
    from routest_tpu_torch.serve.bus import InMemoryBus
    from routest_tpu_torch.serve.ml_service import EtaService

    monkeypatch.setenv("RTPU_SLO_TICK_S", "0")
    monkeypatch.setenv("RTPU_TIMELINE", "0")
    cfg = Config(serve=ServeConfig(device="cpu", batch_buckets=(8,)),
                 dispatch=DispatchConfig(reopt_poll_s=0.0))
    svc = EtaService(cfg.serve, model_path="artifacts/eta_mlp.msgpack",
                     device="cpu")
    buses = {n: InMemoryBus() for n in ("east", "west")}
    regions = {n: _AppRegion(create_app(cfg, eta_service=svc, bus=buses[n],
                                        sim_tick_range=(0.001, 0.002)))
               for n in ("east", "west")}
    front = tgeo.GeoFront(
        [tgeo.RegionHandle(n, r.base, kill=r.stop, rejoin=r.start)
         for n, r in regions.items()],
        tconfig.RegionConfig(enabled=True, regions=("east", "west"),
                             default="east", health_s=0.05,
                             unhealthy_after=2, replay_s=0.05))
    bridge = ProbeBridge("east", "west", buses["east"], buses["west"])
    front.bridges.append(bridge)
    watch = buses["west"].subscribe(bridge.channel)
    front.serve("127.0.0.1", 0)
    bridge.start()
    try:
        assert _wait(lambda: front.healthy("east")
                     and front.healthy("west"))
        # both regions answer the same single row bitwise
        row = {"summary": {"distance": 8000}, "weather": "Sunny",
               "traffic": "Low", "driver_age": 30,
               "pickup_time": "2026-10-12T08:30:00"}
        answers = {n: _post(f"{front.base}/api/predict_eta?region={n}",
                            row) for n in ("east", "west")}
        assert answers["east"][0] == answers["west"][0]
        assert {n: a[1]["X-RTPU-Served-Region"]
                for n, a in answers.items()} == {"east": "east",
                                                 "west": "west"}
        # a probe frame observed in east crosses into west, stamped
        buses["east"].publish(bridge.channel,
                              {"t": time.time(), "obs": [[3, 7.5]]})
        frame = watch.get(timeout=5.0)
        assert frame["origin_region"] == "east"
        assert frame["obs"] == [[3, 7.5]]
        # west goes down; a write taken meanwhile is journaled for it
        front.kill_region("west")
        written, headers = _post(
            f"{front.base}/api/optimize_route?region=west",
            _optimize_body(), timeout=60.0)
        assert headers["X-RTPU-Served-Region"] == "east"
        assert written["properties"]["saved"] is True
        assert front.journal_depth("west") == 1
        west_history = f"{regions['west'].base}/api/history"
        # west rejoins at its address; the replay drains and the write
        # reads back from west's own store
        front.rejoin_region("west")
        assert _wait(lambda: front.healthy("west"), timeout=20.0)
        assert _wait(lambda: front.journal_depth("west") == 0,
                     timeout=30.0)
        items = _get(west_history)[0]["items"]
        east_items = _get(f"{regions['east'].base}/api/history")[0]["items"]
        assert len(items) == len(east_items) == 1
        keys = ("dest_count", "total_distance", "total_duration",
                "optimized", "engine")
        assert {k: items[0][k] for k in keys} == \
            {k: east_items[0][k] for k in keys}
        assert items[0]["total_distance"] > 0
    finally:
        watch.close()
        front.drain(timeout=5.0)
        for r in regions.values():
            r.stop()
            r.app.close()
