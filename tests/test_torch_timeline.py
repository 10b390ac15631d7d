"""The metric timeline: the port's ``obs/timeline.py`` against the JAX
package's on the same counters.

One scripted stream of counter, gauge and histogram updates goes into a
private registry per package; both stores tick at the same synthetic
wall-clock instants (no ticker thread, no sleeps) and hold the same
rings at every resolution, answer the same queries, and their anomaly
watchers fire the same findings into a stub recorder. The gateway's
fleet scraper (copied whole for the fleet slice) merges the same
replica replies into the same views."""

import threading
import time

import pytest
import torch

from routest_tpu.core.config import TimelineConfig as JTimelineConfig
from routest_tpu.core.config import \
    load_timeline_config as jload_timeline_config
from routest_tpu.obs import registry as jregistry
from routest_tpu.obs import timeline as jtimeline
from routest_tpu_torch.core.config import (TimelineConfig,
                                           load_timeline_config)
from routest_tpu_torch.obs import registry as tregistry
from routest_tpu_torch.obs import timeline as ttimeline

PACKAGES = {"jax": (jtimeline, jregistry, JTimelineConfig,
                    jload_timeline_config),
            "torch": (ttimeline, tregistry, TimelineConfig,
                      load_timeline_config)}

T0 = 1_700_000_000.0


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


class _StubRecorder:
    def __init__(self):
        self.triggers = []

    def trigger(self, reason, detail=None, **_kw):
        d = dict(detail or {})
        d.pop("ts", None)
        self.triggers.append((reason, d))
        return None


def _script(step):
    """What window ``step`` observes: (request count, latency seconds,
    errors, cache hits, cache misses, gauge value)."""
    if step < 6:
        return 40, 0.004, 0, 30, 10, 1.0
    if step < 8:
        return 40, 1.5, 1, 30, 10, 2.0       # latency shift
    if step < 10:
        return 40, 0.004, 12, 30, 10, 3.0    # error-rate step
    if step < 12:
        return 40, 0.004, 0, 5, 35, 4.0      # cache-hit collapse
    return 0, 0.004, 0, 0, 0, 5.0            # throughput collapse


def _run(k, res, steps, tick_offsets=(0.0,)):
    mod, reg_mod, cfg_cls, load_cfg = PACKAGES[k]
    reg = reg_mod.MetricsRegistry()
    hist = reg.histogram("request_duration_seconds", "", ("route",))
    errs = reg.counter("request_errors_total", "", ("route",))
    hits = reg.counter("rtpu_route_cache_hits_total", "")
    miss = reg.counter("rtpu_route_cache_misses_total", "")
    gauge = reg.gauge("queue_depth", "")
    cfg = load_cfg({"RTPU_TIMELINE_RES": res,
                    "RTPU_TIMELINE_WATCH_COOLDOWN_S": "0"})
    store = mod.TimelineStore([reg], cfg, component="test")
    rec = _StubRecorder()
    watcher = mod.AnomalyWatcher(store, cfg, rec).attach()
    store.tick(T0)
    for step in range(steps):
        n, lat, n_err, n_hit, n_miss, g = _script(step)
        for i in range(n):
            hist.labels(route="POST /api/predict_eta").observe(lat)
        if n_err:
            errs.labels(route="POST /api/predict_eta").inc(n_err)
        if n_hit:
            hits.inc(n_hit)
        if n_miss:
            miss.inc(n_miss)
        gauge.set(g)
        for off in tick_offsets:
            store.tick(T0 + step + 1 + off)
    return store, watcher, rec


@pytest.mark.parametrize("res", ["1x4", "1x32", "1x8,4x4", "2x16,6x3"])
@pytest.mark.parametrize("offsets", [(0.0,), (0.25, 0.5, 0.99)])
def test_rings_and_queries_match(res, offsets):
    out = {}
    for k in PACKAGES:
        store, _, _ = _run(k, res, 16, offsets)
        steps = [r["step_s"] for r in store.snapshot()["resolutions"]]
        out[k] = ([store.frames(step) for step in steps],
                  store.query(), store.query(family="cache"),
                  store.query(window_s=3.0, step_s=steps[-1]),
                  store.snapshot())
    assert out["torch"] == out["jax"]


def test_watchers_fire_the_same_findings():
    fired = {}
    for k in PACKAGES:
        _, watcher, rec = _run(k, "1x32", 16)
        fired[k] = (rec.triggers,
                    [{kk: v for kk, v in h.items() if kk != "ts"}
                     for h in watcher.snapshot()["recent"]])
    assert fired["torch"] == fired["jax"]
    kinds = {r for r, _ in fired["torch"][0]}
    assert {"anomaly_latency_shift", "anomaly_error_rate_step",
            "anomaly_cache_hit_collapse",
            "anomaly_throughput_collapse"} <= kinds


@pytest.mark.parametrize("counts", [[1, 2, 3, 4], [0, 0, 5, 0], [], [9]])
@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_bucket_quantile_matches(counts, q):
    le = [0.001, 0.01, 0.1, 1.0][:len(counts)]
    assert ttimeline.bucket_quantile(le, counts, q) == \
        jtimeline.bucket_quantile(le, counts, q)


def _stub_frame(t, count, slow, errors=0.0):
    fams = {"request_duration_seconds": {
        "kind": "histogram", "le": [0.01, 1.0],
        "series": [{"labels": {"route": "x"}, "count": count,
                    "sum": 0.01 * count,
                    "buckets": [count - slow, slow, 0]}]}}
    if errors:
        fams["request_errors_total"] = {
            "kind": "counter",
            "series": [{"labels": {"route": "x"}, "delta": errors,
                        "rate": errors}]}
    return {"t": t, "dur": 1.0, "families": fams}


def test_merge_frames_matches():
    frames = [_stub_frame(T0, 50, 0), _stub_frame(T0, 50, 2, errors=5.0)]
    assert ttimeline.merge_frames(frames) == \
        jtimeline.merge_frames(frames)


def test_fleet_scraper_views_match():
    replies = {
        "r0": {"component": "replica", "step_s": 1.0,
               "frames": [_stub_frame(T0, 50, 0),
                          _stub_frame(T0 + 1, 50, 0)]},
        "r1": {"component": "replica", "step_s": 1.0,
               "frames": [_stub_frame(T0 + 1, 50, 2, errors=5.0)]},
        "r2": {"error": "HTTPException: boom"},
    }
    out = {}
    for k, (mod, _, _, load_cfg) in PACKAGES.items():
        scraper = mod.FleetTimelineScraper(
            lambda _path: replies,
            load_cfg({"RTPU_TIMELINE_RES": "1x8"}),
            versions_fn=lambda: {"r0": "v1", "r1": "v2"})
        scraper.scrape()
        scraper.scrape()
        out[k] = [scraper.query(scope=s) for s in
                  ("fleet", "replicas", "versions")] + [
            scraper.query(scope="fleet", family="request_errors")]
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("env", [
    {}, {"RTPU_TIMELINE_RES": "5x10,1x60"}, {"RTPU_TIMELINE_RES": "bad"},
    {"RTPU_TIMELINE": "0", "RTPU_TIMELINE_WATCH": "0",
     "RTPU_TIMELINE_WATCH_MIN_COUNT": "x"},
])
def test_config_loader_matches(env):
    assert load_timeline_config(env).__dict__ == \
        jload_timeline_config(env).__dict__
