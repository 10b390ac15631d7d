"""The SLO engine: the port's ``obs/slo.py`` against the JAX package's
on the same sample sequences.

Scripted ``(total, bad)`` sources ticked at explicit times (no ticker,
no sleeps) give the same burn rates, budgets, alert states, transition
edges and warn/page callbacks; the objective-spec grammar, the
threshold snapping and the rollup sources over request-stats registries
agree; the replica engine built over the same observed requests is the
JAX engine's, objective for objective."""

import threading
import time

import pytest
import torch

from routest_tpu.core.config import SloConfig as JSloConfig
from routest_tpu.core.config import load_slo_config as jload_slo_config
from routest_tpu.obs import slo as jslo
from routest_tpu.utils.profiling import RequestStats as JRequestStats
from routest_tpu_torch.core.config import SloConfig, load_slo_config
from routest_tpu_torch.obs import slo as tslo
from routest_tpu_torch.utils.profiling import RequestStats

PACKAGES = {"jax": (jslo, JSloConfig, JRequestStats),
            "torch": (tslo, SloConfig, RequestStats)}


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (transient threads of other modules' apps end within seconds)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Script:
    """A source replaying a scripted cumulative (total, bad) series."""

    def __init__(self, steps):
        self.steps = steps
        self.i = 0
        self.total = 0.0
        self.bad = 0.0

    def advance(self):
        dt, db = self.steps[self.i]
        self.total += dt
        self.bad += db
        self.i += 1

    def __call__(self):
        return self.total, self.bad


SCENARIOS = {
    "healthy": [(100, 0)] * 30,
    "burst_then_recover": [(100, 0)] * 10 + [(100, 40)] * 8
    + [(100, 0)] * 40,
    "slow_leak_warns": [(100, 0)] * 5 + [(100, 1)] * 60,
    "idle_windows": [(0, 0)] * 10 + [(50, 50)] * 3 + [(0, 0)] * 20,
    "flapping": [(100, 30), (100, 0)] * 25,
}


def _strip(snap):
    for obj in snap["objectives"].values():
        obj.pop("last_transition_unix")
    return snap


def _run(k, steps, target, fast, slow, tick, page, warn):
    mod, cfg_cls, _ = PACKAGES[k]
    eng = mod.SloEngine(config=cfg_cls(tick_s=0.0, fast_window_s=fast,
                                       slow_window_s=slow, page_burn=page,
                                       warn_burn=warn), component="test")
    src = _Script(steps)
    lat = _Script([(t, b // 2) for t, b in steps])
    eng.add_objective(mod.SloObjective("availability:a", "availability",
                                       target, src, {"route": "/a"}))
    eng.add_objective(mod.SloObjective("latency:a", "latency", 0.9, lat,
                                       {"route": "/a", "threshold_ms": 5.0}))
    edges = []
    eng.on_warn.append(lambda name, d: edges.append(("warn", name, d)))
    eng.on_page.append(lambda name, d: edges.append(("page", name, d)))
    history = []
    t = 1000.0
    for _ in steps:
        src.advance()
        lat.advance()
        t += tick
        eng.tick(now=t)
        history.append((eng.worst_state(), _strip(eng.snapshot())))
    return history, edges


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("params", [
    (0.99, 2.0, 20.0, 0.5, 14.4, 6.0),
    (0.999, 5.0, 60.0, 1.0, 14.4, 6.0),
    (0.9, 1.0, 4.0, 0.25, 2.0, 1.0),
])
def test_burn_rates_and_states_match(scenario, params):
    steps = SCENARIOS[scenario]
    assert _run("torch", steps, *params) == _run("jax", steps, *params)


def test_a_burst_pages_once_and_recovers():
    history, edges = _run("torch", SCENARIOS["burst_then_recover"],
                          0.99, 2.0, 20.0, 0.5, 14.4, 6.0)
    states = [s for s, _ in history]
    assert "page" in states and states[-1] == "ok"
    assert [e[0] for e in edges if e[1] == "availability:a"].count(
        "page") == 1


@pytest.mark.parametrize("spec", [
    "",
    "/api/predict_eta",
    "/api/predict_eta:availability=0.99,latency_ms=250",
    "/api/x:latency_ms=40,latency_target=0.9;/api/y:availability=0.95",
    "/api/x:availability=banana;/api/y:latency_ms=-1;bad:=;;",
    "/api/x:availability=1.5,latency_target=0",
])
def test_objective_spec_grammar_matches(spec):
    assert tslo.parse_objective_spec(spec) == jslo.parse_objective_spec(spec)


@pytest.mark.parametrize("ms", [0.1, 1.0, 4.9, 5.0, 250.0, 999.0, 1e6])
def test_threshold_snapping_matches(ms):
    from routest_tpu_torch.obs.registry import DEFAULT_TIME_BUCKETS

    assert tslo.snap_threshold(ms / 1000.0, DEFAULT_TIME_BUCKETS) == \
        jslo.snap_threshold(ms / 1000.0, DEFAULT_TIME_BUCKETS)


@pytest.mark.parametrize("env", [
    {}, {"RTPU_SLO": "0"},
    {"RTPU_SLO_TICK_S": "0", "RTPU_SLO_FAST_S": "2", "RTPU_SLO_SLOW_S": "x",
     "RTPU_SLO_PAGE_BURN": "3", "RTPU_SLO_OBJECTIVES": "/a:latency_ms=5"},
])
def test_config_loader_matches(env):
    assert load_slo_config(env).__dict__ == jload_slo_config(env).__dict__


def _observe(stats, t):
    """The same request outcomes into one RequestStats per package."""
    plan = [("POST /api/predict_eta", 0.002, False)] * 40 \
        + [("POST /api/predict_eta", 1.9, False)] * 6 \
        + [("POST /api/predict_eta", 0.004, True)] * 3 \
        + [("POST /api/optimize_route", 0.3, False)] * 10 \
        + [("POST /api/optimize_route", 0.3, True)] * t \
        + [("GET /api/ping", 0.0001, False)] * 5
    for route, seconds, error in plan:
        stats.add(route, seconds, error)


def test_replica_engine_over_request_stats_matches():
    snaps = {}
    for k, (mod, cfg_cls, stats_cls) in PACKAGES.items():
        stats = stats_cls()
        cfg = cfg_cls(tick_s=0.0, fast_window_s=2.0, slow_window_s=20.0,
                      objectives="/api/predict_eta:availability=0.99,"
                                 "latency_ms=1000,latency_target=0.9;"
                                 "/api/optimize_route:availability=0.9")
        eng = mod.build_replica_engine(stats.registry, cfg)
        hist = []
        for i in range(6):
            _observe(stats, i)
            eng.tick(now=100.0 + i)
            hist.append(_strip(eng.snapshot()))
        snaps[k] = hist
    assert snaps["torch"] == snaps["jax"]
    objectives = snaps["torch"][-1]["objectives"]
    assert set(objectives) == {"availability:/api/predict_eta",
                               "latency:/api/predict_eta",
                               "availability:/api/optimize_route"}


def test_rollups_match():
    out = {}
    for k, (mod, _, stats_cls) in PACKAGES.items():
        stats = stats_cls()
        _observe(stats, 4)
        reg = stats.registry
        out[k] = (
            mod.histogram_family_rollup(reg, "request_duration_seconds",
                                        "predict"),
            mod.route_availability_source(
                reg, "/api/optimize_route", "request_duration_seconds",
                "request_errors_total")(),
            mod.route_latency_source(
                reg, "/api/predict_eta", 1.0,
                "request_duration_seconds")())
    assert out["torch"] == out["jax"]


def test_gateway_engine_builds_its_default_objectives():
    cfg = SloConfig(tick_s=0.0)
    jcfg = JSloConfig(tick_s=0.0)
    t = sorted(tslo.build_gateway_engine(cfg).snapshot()["objectives"])
    j = sorted(jslo.build_gateway_engine(jcfg).snapshot()["objectives"])
    assert t == j and t
