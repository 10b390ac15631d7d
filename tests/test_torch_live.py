"""Live traffic: the port's ``routest_tpu_torch/live`` and the router's
live half against the JAX package, the port on the CPU, on the fixtures
and sizes of ``tests/test_live_traffic.py``.

Bitwise: ``CongestionState`` folds and snapshots, ``ProbeFleet`` steps
from one seed and ``now``, ``corridor_edges``, the ingester on good and
malformed events, ``HierarchicalIndex.customize`` (payload, solves, and
equal to a fresh build on the new metric; within rtol 1e-4 of scipy's
Dijkstra), and, after the same install, live solves (``dist``,
``pred``), ``meters_rows``, leg costs and ``cost_model`` on the flat
300-node router and on the overlay (``ROUTEST_HIER_MIN_NODES=1``). The
customization structure crosses the cache file both ways. A failed
install leaves the previous generation serving, and the route-cache and
ETA fast-lane keys change with the epoch."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import dijkstra

from routest_tpu import live as jlive
from routest_tpu.data.road_graph import generate_road_graph, subdivide_graph
from routest_tpu.live.customize import MetricCustomizer as JCustomizer
from routest_tpu.live.ingest import ProbeIngester as JIngester
from routest_tpu.live.probes import CongestionScenario as JScenario
from routest_tpu.live.probes import ProbeFleet as JFleet
from routest_tpu.live.probes import corridor_edges as jcorridor
from routest_tpu.live.state import CongestionState as JState
from routest_tpu.optimize import hierarchy as jh
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu_torch import live as tlive
from routest_tpu_torch.core.config import ServeConfig
from routest_tpu_torch.live.customize import MetricCustomizer as TCustomizer
from routest_tpu_torch.live.ingest import ProbeIngester as TIngester
from routest_tpu_torch.live.probes import CongestionScenario as TScenario
from routest_tpu_torch.live.probes import ProbeFleet as TFleet
from routest_tpu_torch.live.probes import corridor_edges as tcorridor
from routest_tpu_torch.live.state import CongestionState as TState
from routest_tpu_torch.optimize import hierarchy as th
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.serve.bus import InMemoryBus as TBus
from routest_tpu_torch.serve.ml_service import EtaService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (state, ingester, fleet, scenario, bus, customizer) of each package
JAX = (JState, JIngester, JFleet, JScenario, JBus, JCustomizer)
PORT = (TState, TIngester, TFleet, TScenario, TBus, TCustomizer)


def _same_snapshot(got, want):
    assert got.epoch == want.epoch
    assert got.n_obs_edges == want.n_obs_edges
    assert got.total_obs == want.total_obs
    assert got.taken_unix == want.taken_unix
    for name in ("obs_time_s", "conf"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name


def _raiser(message):
    def fail(*args, **kwargs):
        raise RuntimeError(message)
    return fail


@pytest.fixture(autouse=True)
def _epoch_zero():
    yield
    tlive.set_metric_epoch(0)
    jlive.set_metric_epoch(0)


# ---------------------------------------------------------------------------
# Congestion state
# ---------------------------------------------------------------------------

def _fold_script(state_cls):
    """The folds of ``test_live_traffic.py``'s state tests, plus
    duplicates, bad entries and a late (replayed) batch, on one state."""
    st = state_cls(np.full(10, 100.0, np.float32), half_life_s=10,
                   stale_s=30, conf_obs=3, window=16)
    snaps = []
    st.fold([2, 2, 3], [40.0, 60.0, 80.0], t=1000.0, hour=7)
    snaps.append(st.snapshot(now=1001.0))
    for i in range(20):
        st.fold([0], [50.0], t=1000.0 + i, hour=8)
    for i in range(40):
        st.fold([0, 5, 5, 9], [200.0, 30.0 + i, 31.0, 7.5],
                t=1020.0 + i, hour=9)
    snaps.append(st.snapshot(now=1060.0))
    # bad entries: out of range, non-finite, non-positive
    n = st.fold([1, -1, 10, 4, 6], [80.0, 5.0, 5.0, np.nan, -2.0],
                t=1061.0, hour=25)
    snaps.append(st.snapshot(now=1070.0))
    # a replayed batch with an old stamp must not un-stale an edge
    st.fold([1], [90.0], t=900.0, hour=3)
    snaps.append(st.snapshot(now=1095.0))
    return st, snaps, n


def test_state_folds_and_snapshots_bitwise():
    (js, jsnaps, jn), (ts, tsnaps, tn) = (_fold_script(JState),
                                          _fold_script(TState))
    assert tn == jn == 1
    for got, want in zip(tsnaps, jsnaps):
        _same_snapshot(got, want)
    assert tsnaps[-1].epoch == 4
    jw, tw = js.window(), ts.window()
    for key in jw:
        assert tw[key].dtype == jw[key].dtype
        assert tw[key].tobytes() == jw[key].tobytes(), key
    assert len(tw["edge"]) == 16
    assert ts.fold([], []) == js.fold([], []) == 0


def test_state_stats_match():
    states = [cls(np.full(6, 20.0, np.float32), stale_s=1e9)
              for cls in (JState, TState)]
    for st in states:
        st.fold([0, 1, 1], [10.0, 11.0, 12.0], t=1.0)
    assert states[1].stats() == states[0].stats()


# ---------------------------------------------------------------------------
# Probes, corridors, ingest
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_pair():
    """The JAX and the port router on ``generate_road_graph(300, seed=7)``
    (``test_live_traffic.py``'s ``small_router``)."""
    g = generate_road_graph(n_nodes=300, seed=7)
    return (jrr.RoadRouter(graph=g, use_gnn=False, use_transformer=False),
            trr.RoadRouter(graph=g, use_gnn=False, use_transformer=False,
                           device="cpu"))


@pytest.mark.parametrize("active", [None, False, True])
def test_probe_fleet_steps_bitwise(flat_pair, active):
    jr, tr = flat_pair
    runs = []
    for pkg, router in ((JAX, jr), (PORT, tr)):
        _, _, fleet_cls, scen_cls, _, _ = pkg
        published = []
        scen = None
        if active is not None:
            scen = scen_cls(np.arange(50), speed_factor=0.25,
                            start_unix=1002.0)
            scen.set_active(active if active else None)
        fleet = fleet_cls(router.graph_dict(), n_drivers=25,
                          publish=lambda ch, ev: published.append((ch, ev)),
                          seed=5, scenario=scen, obs_per_tick=4)
        events = []
        for t in range(5):
            events.append(fleet.step(now=1000.0 + t,
                                     hour=None if t == 3 else 8))
        runs.append((events, published, fleet.ticks, fleet.published,
                     fleet._at.tolist()))
    assert runs[1] == runs[0]
    assert runs[1][3] == 125


def test_scenario_multiplier_matches():
    for start, end, forced in ((None, None, None), (10.0, 20.0, None),
                               (10.0, None, None), (None, None, True)):
        js = JScenario(np.asarray([1, 4]), 0.5, start, end)
        ts = TScenario(np.asarray([1, 4]), 0.5, start, end)
        if forced is not None:
            js.set_active(forced)
            ts.set_active(forced)
        for now in (5.0, 15.0, 25.0):
            assert ts.active(now) == js.active(now)
            assert ts.time_multiplier(6, now).tobytes() == \
                js.time_multiplier(6, now).tobytes()
    with pytest.raises(ValueError):
        TScenario(np.arange(3), speed_factor=0.0)


@pytest.mark.parametrize("ends,width", [((10, 200), 800), ((3, 250), 300),
                                        ((77, 77), 500), (None, 100)])
def test_corridor_edges_bitwise(flat_pair, ends, width):
    _, tr = flat_pair
    if ends is None:
        a, b = (0.0, 0.0), (0.1, 0.1)
    else:
        a, b = (tuple(float(v) for v in tr.coords[i]) for i in ends)
    got = tcorridor(tr.coords, tr.senders, tr.receivers, a, b, width_m=width)
    want = jcorridor(tr.coords, tr.senders, tr.receivers, a, b,
                     width_m=width)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (len(got) == 0) == (ends is None)


INGEST_EVENTS = [
    {"nope": 1},
    {"obs": [["x", "y"]]},
    {"obs": [[10_000_000, 5.0]]},
    {"obs": [[0, -3.0]]},
    {"obs": [[0, float("nan")]]},
    {"obs": "not a list"},
    {"obs": [[1]]},
    {"obs": [[0, 5.0]], "t": "late"},
    {"obs": [[0, 5.0]], "hour": "noon"},
    {"t": 1000.0, "hour": 8, "driver": "d0", "obs": [[0, 5.0], [1, 2.5]]},
    {"t": 1001.0, "obs": [[2, 5.0], [2, 4.0], [-1, 3.0], [3, 0.0]]},
    {"t": 1002.0, "hour": 31, "obs": [[4, 9.0]]},
    None,
]


def test_ingester_events_bitwise(flat_pair):
    jr, tr = flat_pair
    applied, snaps = [], []
    for pkg, router in ((JAX, jr), (PORT, tr)):
        state_cls, ing_cls, _, _, bus_cls, _ = pkg
        st = state_cls(router.freeflow_time_s)
        ing = ing_cls(bus_cls(), st, router.length_m)
        applied.append([ing.handle(ev) for ev in INGEST_EVENTS])
        snaps.append((st.snapshot(now=1003.0), st.window(), ing.batches))
    assert applied[1] == applied[0] == [0] * 9 + [2, 2, 1, 0]
    _same_snapshot(snaps[1][0], snaps[0][0])
    for key in snaps[0][1]:
        assert snaps[1][1][key].tobytes() == snaps[0][1][key].tobytes()
    assert snaps[1][2] == snaps[0][2] == 3


def test_ingester_fold_error_drops_the_batch_not_the_stream(flat_pair):
    """The error path of the JAX package's chaos point ``live.ingest``:
    a fold that raises drops that batch, and the next one lands."""
    _, tr = flat_pair
    st = TState(tr.freeflow_time_s)
    ing = TIngester(TBus(), st, tr.length_m)
    real = st.fold
    st.fold = _raiser("boom")
    assert ing.handle({"t": 1.0, "obs": [[0, 5.0]]}) == 0
    st.fold = real
    assert ing.handle({"t": 1.0, "obs": [[2, 5.0]]}) == 1
    snap = st.snapshot(now=2.0)
    assert snap.n_obs_edges == 1 and snap.conf[0] == 0.0
    assert ing.batches == 1


def test_ingester_thread_folds_the_bus(flat_pair):
    _, tr = flat_pair
    bus = TBus()
    st = TState(tr.freeflow_time_s, stale_s=1e9)
    ing = TIngester(bus, st, tr.length_m)
    ing.start()
    try:
        t0 = time.monotonic()
        while not bus._subscribers.get(ing.channel):
            assert time.monotonic() - t0 < 10
            time.sleep(0.01)
        for k in range(5):
            bus.publish(ing.channel, {"t": 10.0 + k, "obs": [[k, 4.0]]})
        bus.publish(ing.channel, {"bad": True})
        while ing.batches < 5:
            assert time.monotonic() - t0 < 10
            time.sleep(0.01)
    finally:
        ing.stop()
    assert st.snapshot(now=20.0).n_obs_edges == 5
    assert not bus._subscribers.get(ing.channel)


# ---------------------------------------------------------------------------
# Overlay customization
# ---------------------------------------------------------------------------

def _npz(index, path):
    index._save(str(path), {"g": 1})
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _strip_timings(d):
    if isinstance(d, dict):
        return {k: _strip_timings(v) for k, v in d.items()
                if not k.endswith("_s")}
    if isinstance(d, list):
        return [_strip_timings(x) for x in d]
    return d


def _payloads_equal(got, want, skip_stats=False):
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "_stats":
            if not skip_stats:
                gs, ws = (json.loads(bytes(x[key]).decode())
                          for x in (got, want))
                assert _strip_timings(gs) == _strip_timings(ws)
            continue
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.fixture(scope="module")
def customized():
    """``test_live_traffic.py``'s customization case: the 400-node graph
    subdivided (3 bends, 25% one-way), ``cell_targets=[48, 192]``, a
    metric of random speeds with 200 jammed edges."""
    base = generate_road_graph(n_nodes=400, seed=5)
    g = subdivide_graph(base, bends_per_edge=3, oneway_frac=0.25, seed=1)
    coords, s, r, w = (g["node_coords"], g["senders"], g["receivers"],
                       g["length_m"])
    rng = np.random.default_rng(0)
    w2 = (w / rng.uniform(3.0, 12.0, len(w))).astype(np.float32)
    w2[rng.integers(0, len(w), 200)] *= 8.0
    j = jh.HierarchicalIndex.build(coords, s, r, w, cell_targets=[48, 192])
    t = th.HierarchicalIndex.build(coords, s, r, w, cell_targets=[48, 192],
                                   device="cpu")
    return (coords, s, r, w, w2), j, t, j.customize(w2), t.customize(w2)


def test_customize_payload_bitwise_jax(customized, tmp_path):
    _, _, _, jc, tc = customized
    assert tc.stats["customized"] is True
    assert tc.stats["partition_s"] == 0.0
    assert tc._structure is not None
    _payloads_equal(_npz(tc, tmp_path / "t.npz"), _npz(jc, tmp_path / "j.npz"))
    assert [lv.tiers for lv in tc.levels] == [lv.tiers for lv in jc.levels]


def test_customize_equals_a_fresh_build_and_the_oracle(customized, tmp_path):
    (coords, s, r, _, w2), _, _, _, tc = customized
    fresh = th.HierarchicalIndex.build(coords, s, r, w2,
                                       cell_targets=[48, 192], device="cpu")
    # same payload (the build's stats carry no "customized" flag)
    _payloads_equal(_npz(tc, tmp_path / "c.npz"),
                    _npz(fresh, tmp_path / "f.npz"), skip_stats=True)
    src = np.random.default_rng(0).integers(0, tc.n_nodes, 6)
    got_d, got_p = tc.full_solve_fn(1)(*tc.prep_sources(src),
                                       torch.from_numpy(src))
    want_d, want_p = fresh.full_solve_fn(1)(*fresh.prep_sources(src),
                                            torch.from_numpy(src))
    assert got_d.numpy().tobytes() == want_d.numpy().tobytes()
    assert (got_p.numpy() == want_p.numpy()).all()
    n = len(coords)
    adj = sp.coo_matrix((w2.astype(np.float64), (s, r)),
                        shape=(n, n)).tocsr()
    want = dijkstra(adj, directed=True, indices=src.astype(np.int64))
    d = got_d.numpy()
    finite = np.isfinite(want)
    assert finite.mean() > 0.5
    np.testing.assert_allclose(d[finite], want[finite], rtol=1e-4)
    assert (d[~finite] > 1e37).all()


def test_customize_solves_bitwise_jax(customized):
    _, _, _, jc, tc = customized
    src = np.random.default_rng(1).integers(0, tc.n_nodes, 9)
    jd, jp = jax.jit(jc.full_solve_fn(1))(*jc.prep_sources(src),
                                          jax.numpy.asarray(
                                              src.astype(np.int32)))
    td, tp = tc.full_solve_fn(1)(*tc.prep_sources(src),
                                 torch.from_numpy(src))
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    assert (tp.numpy() == np.asarray(jp)).all()
    assert tc.query_fn(*tc.prep_sources(src)).numpy().tobytes() == \
        np.asarray(jc.query_fn(*jc.prep_sources(src))).tobytes()


def test_customize_refuses_an_index_without_structure(customized):
    _, _, t, _, _ = customized
    bare = th.HierarchicalIndex(
        t.levels, t._top_s, t._top_r, t._top_w, dict(t.stats),
        expand_idx=t._expand_idx, seed_node=t._seed_node,
        seed_w=t._seed_w, l0=t._l0, fill=t._fill, labels=t._labels)
    with pytest.raises(ValueError, match="customization structure"):
        bare.customize(np.ones(10, np.float32))


def test_cache_carries_the_structure_both_ways(tmp_path):
    """``test_live_traffic.py``'s cache case: each package customizes an
    overlay the other wrote, and the tables equal a direct
    customization."""
    g = generate_road_graph(n_nodes=600, seed=3)
    args = (g["node_coords"], g["senders"], g["receivers"], g["length_m"])
    w2 = (g["length_m"] * 2.0).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j = jh.HierarchicalIndex.build(*args, cell_targets=[64], cache_path=jpath,
                                   fingerprint={"x": 1})
    t = th.HierarchicalIndex.build(*args, cell_targets=[64], cache_path=tpath,
                                   fingerprint={"x": 1}, device="cpu")
    t_from_j = th.HierarchicalIndex.load(jpath, {"x": 1}, device="cpu")
    j_from_t = jh.HierarchicalIndex.load(tpath, {"x": 1})
    assert t_from_j._structure is not None and j_from_t._structure is not None
    want = _npz(t.customize(w2), tmp_path / "direct.npz")
    _payloads_equal(_npz(t_from_j.customize(w2), tmp_path / "tj.npz"), want)
    _payloads_equal(_npz(j_from_t.customize(w2), tmp_path / "jt.npz"), want)
    _payloads_equal(_npz(j.customize(w2), tmp_path / "jj.npz"), want)


# ---------------------------------------------------------------------------
# The router's live half
# ---------------------------------------------------------------------------

def _feed(pkg, router, scenario_edges, n_ticks, now0, seed=3, drivers=60,
          active=True):
    """``test_live_traffic.py``'s ``_feed_probes``: a seeded fleet over
    the router's graph through the bus into a fresh state."""
    state_cls, ing_cls, fleet_cls, scen_cls, bus_cls, _ = pkg
    bus = bus_cls()
    state = state_cls(router.freeflow_time_s, half_life_s=30, stale_s=600)
    ing = ing_cls(bus, state, router.length_m)
    scen = scen_cls(scenario_edges, speed_factor=0.2)
    scen.set_active(active)
    fleet = fleet_cls(router.graph_dict(), drivers, bus.publish, seed=seed,
                      scenario=scen, obs_per_tick=6)
    sub = bus.subscribe(fleet.channel)
    for t in range(n_ticks):
        fleet.step(now=now0 + t, hour=8)
        while True:
            ev = sub.get(timeout=0.01)
            if ev is None:
                break
            ing.handle(ev)
    return state


@pytest.fixture(scope="module")
def overlay_pair():
    """The JAX and the port router on ``test_live_traffic.py``'s overlay
    graph (400 nodes subdivided), routed through the overlay."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROUTEST_HIER_MIN_NODES", "1")
        mp.setenv("ROUTEST_ROUTER_AOT", "off")
        base = generate_road_graph(n_nodes=400, seed=5)
        g = subdivide_graph(base, bends_per_edge=2, oneway_frac=0.1, seed=1)
        pair = (jrr.RoadRouter(graph=g, use_gnn=False, use_transformer=False),
                trr.RoadRouter(graph=g, use_gnn=False, use_transformer=False,
                               device="cpu"))
    assert pair[1]._hier is not None
    return pair


def _install_same(jr, tr, width=800, n_ticks=20, now0=1000.0, route=True,
                  ends=(10, 200)):
    a, b = (tuple(float(v) for v in tr.coords[i]) for i in ends)
    cor = tcorridor(tr.coords, tr.senders, tr.receivers, a, b, width_m=width)
    res = []
    for pkg, router in ((JAX, jr), (PORT, tr)):
        state = _feed(pkg, router, cor, n_ticks, now0)
        cust = pkg[5](router, state, min_obs_edges=10, route_metric=route)
        res.append(cust.run_once(now=now0 + n_ticks))
    assert res[0]["flipped"] and res[1]["flipped"], res
    assert _strip_timings(res[1]) == _strip_timings(res[0])
    return np.asarray([a, b, tuple(float(v) for v in tr.coords[50])],
                      np.float32)


def _legs_equal(jl, tl):
    assert tl.cost_model == jl.cost_model
    assert tl.dist_m.tobytes() == jl.dist_m.tobytes()
    assert tl._pred.tobytes() == jl._pred.tobytes()
    m = len(tl._nodes)
    for i in range(m):
        for j in range(m):
            assert tl.cost(i, j) == jl.cost(i, j)
            assert tl.leg(i, j) == jl.leg(i, j)
    np.testing.assert_allclose(tl.duration_matrix(), jl.duration_matrix(),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["flat", "overlay"])
def test_live_solves_and_legs_bitwise(kind, flat_pair, overlay_pair):
    jr, tr = flat_pair if kind == "flat" else overlay_pair
    pts = _install_same(jr, tr, width=800 if kind == "flat" else 600,
                        ends=(10, 200) if kind == "flat" else (10, 350))
    assert tr.live_epoch == jr.live_epoch >= 1
    assert tlive.metric_epoch() == jlive.metric_epoch() == tr.live_epoch
    assert tr.live_metric_export().tobytes() == \
        jr.live_metric_export().tobytes()
    if kind == "overlay":
        hier = tr._live.hier
        assert hier is not None and hier.stats["customized"]
        # the structure was reused: no partition, the same cells
        assert hier.stats["partition_s"] == 0.0
        assert hier.stats["levels"][0]["n_cells"] == \
            tr._hier.stats["levels"][0]["n_cells"]
        assert set(tr.live_info) >= {"customize_s", "full_build_s"}
        assert tr.solver_info["live"]["epoch"] == tr.live_epoch
    rng = np.random.default_rng(len(kind))
    for n_src in (2, 16, 33):
        src = rng.integers(0, tr.n_nodes, n_src)
        jd, jp = jr.shortest(src, live=jr._live)
        td, tp = tr.shortest(src, live=tr._live)
        assert td.tobytes() == jd.tobytes() and tp.tobytes() == jp.tobytes()
        jm, tm = jr._meters_along(jp, jd), tr._meters_along(tp, td)
        assert tm.dtype == jm.dtype and tm.tobytes() == jm.tobytes()
        # the live solve is in seconds; meters are a different table
        assert not np.array_equal(tm, td)
    jl = jr.route_legs(pts, 1.0, hour=8)
    tl = tr.route_legs(pts, 1.0, hour=8)
    assert tl.cost_model == "live+freeflow"
    assert tl._live_metric
    _legs_equal(jl, tl)
    # RoadLegs' meters rows are the ones recovered along the live trees
    batch = [(pts, 1.0, 8), (pts[::-1].copy(), 1.3, 17)]
    for got, want in zip(tr.route_legs_batch(batch),
                         jr.route_legs_batch(batch)):
        _legs_equal(want, got)
    # served durations follow the scipy oracle on the live metric
    metric = tr.live_metric_export()
    n = tr.n_nodes
    adj = sp.coo_matrix((metric, (tr.senders, tr.receivers)),
                        shape=(n, n)).tocsr()
    src = tr.snap(pts[:2])
    want = dijkstra(adj, directed=True, indices=src.astype(np.int64))
    served = tl.cost(0, 1)[1] - (tl._snap_m[0] + tl._snap_m[1]) / 8.3
    assert abs(served - want[0, src[1]]) / max(want[0, src[1]], 1) < 1e-3


def test_pricing_only_metric_keeps_distance_routes(flat_pair):
    """``route=False``: legs priced live, routes chosen on meters (the
    same trees as no live metric at all)."""
    jr, tr = flat_pair
    pts = _install_same(jr, tr, route=False)
    assert tr._live.route is False
    jl = jr.route_legs(pts, 1.0, hour=8)
    tl = tr.route_legs(pts, 1.0, hour=8)
    _legs_equal(jl, tl)
    assert tl.cost_model == "live+freeflow" and not tl._live_metric
    src = np.asarray([3, 9])
    assert tr.shortest(src, live=tr._live)[0].tobytes() == \
        tr.shortest(src)[0].tobytes()


def test_failed_install_keeps_the_previous_generation(flat_pair, overlay_pair,
                                                      monkeypatch):
    jr, tr = flat_pair
    _install_same(jr, tr)
    epoch, metric = tr.live_epoch, tr.live_metric_export().copy()
    live = tr._live
    with pytest.raises(ValueError):
        tr.install_live_metric(np.ones(3, np.float32), epoch + 1)
    assert tr._live is live and tr.live_epoch == epoch
    # a customizer cycle whose install raises: not flipped, still serving
    st = TState(tr.freeflow_time_s)
    st.fold(np.arange(20), np.full(20, 9.0), t=5.0)
    cust = TCustomizer(tr, st, min_obs_edges=1)
    monkeypatch.setattr(tr, "install_live_metric",
                        _raiser("install failed"))
    res = cust.run_once(now=6.0)
    assert res == {"flipped": False, "reason": "RuntimeError: install failed"}
    assert tr._live is live
    assert tr.live_metric_export().tobytes() == metric.tobytes()
    monkeypatch.undo()
    # evidence below the floor skips rather than flips
    thin = TCustomizer(tr, TState(tr.freeflow_time_s), min_obs_edges=3)
    assert thin.run_once(now=7.0)["flipped"] is False
    assert tr._live is live
    # the overlay's customize itself raising (the error path of the
    # JAX package's chaos point live.customize)
    _, to = overlay_pair
    before = to._live
    st2 = TState(to.freeflow_time_s)
    st2.fold(np.arange(5), np.full(5, 3.0), t=8.0)
    monkeypatch.setattr(to._hier, "customize", _raiser("customize failed"))
    res = TCustomizer(to, st2, min_obs_edges=1).run_once(now=8.0)
    assert res == {"flipped": False,
                   "reason": "RuntimeError: customize failed"}
    assert to._live is before
    assert cust.snapshot()["flips"] == 0


def test_install_degrades_bad_entries_like_jax(flat_pair):
    jr, tr = flat_pair
    n = len(tr.length_m)
    metric = np.full(n, 50.0, np.float32)
    metric[::7] = np.nan
    metric[1::7] = -3.0
    metric[2::7] = np.inf
    metric[3::7] = 1e-3                       # under the physical floor
    ji = jr.install_live_metric(metric, 5)
    ti = tr.install_live_metric(metric, 5)
    assert ti == ji == {"epoch": 5}
    assert tr.live_metric_export().tobytes() == \
        jr.live_metric_export().tobytes()
    assert np.isfinite(tr.live_metric_export()).all()
    assert tr.live_info["epoch"] == 5 and tr.live_info["route_metric"]


def test_route_cache_key_follows_the_epoch(flat_pair, monkeypatch):
    _, tr = flat_pair
    tr._live = None
    pts = np.asarray([tr.coords[4], tr.coords[90]], np.float32)
    first = tr.route_legs(pts, 1.0, hour=9)
    again = tr.route_legs(pts, 1.0, hour=9)
    assert again is first                 # served from the route cache
    tr.install_live_metric(tr.freeflow_time_s * 2, 7)
    live = tr.route_legs(pts, 1.0, hour=9)
    assert live is not first and live.cost_model.startswith("live+")
    assert tr.route_legs(pts, 1.0, hour=9) is live
    # the same epoch number installed again is another generation
    tr.install_live_metric(tr.freeflow_time_s * 3, 7)
    assert tr.route_legs(pts, 1.0, hour=9) is not live
    tr._live = None


def test_batcher_keeps_generations_apart(flat_pair):
    """Concurrent callers under two metric generations never share a
    dispatch: each gets its own metric's rows."""
    _, tr = flat_pair
    tr.install_live_metric(tr.freeflow_time_s * 5, 9)
    live = tr._live
    src = np.asarray([1, 2, 3])
    want_live = tr._solve_rows(src, live)
    want_plain = tr._solve_rows(src)
    batcher = tr._solve_batcher
    gate = threading.Event()
    real = tr._solve_rows
    calls = []

    def slow(rows, lv=None):
        calls.append((len(rows), lv))
        gate.wait(5)
        return real(rows, lv)

    def wait_until(cond):
        t0 = time.monotonic()
        while not cond():
            assert time.monotonic() - t0 < 10, "batcher never queued"
            time.sleep(0.005)

    tr._solve_rows = slow
    out = {}
    requests0 = batcher.stats()["requests"]
    try:
        lead = threading.Thread(target=lambda: out.setdefault(
            "lead", batcher.solve(np.asarray([0]), None)))
        lead.start()
        wait_until(lambda: calls)
        ts = [threading.Thread(target=lambda k=k, lv=lv: out.setdefault(
            k, batcher.solve(src, lv)))
            for k, lv in (("live", live), ("plain", None))]
        for t in ts:
            t.start()
        # both queued behind the leader's dispatch before it drains
        wait_until(lambda: batcher.stats()["requests"] == requests0 + 3)
        gate.set()
        for t in [lead] + ts:
            t.join(10)
    finally:
        del tr._solve_rows
        tr._live = None
    assert out["live"][0].tobytes() == want_live[0].tobytes()
    assert out["plain"][0].tobytes() == want_plain[0].tobytes()
    # three dispatches: the leader's, then one per generation
    assert len(calls) == 3 and calls[0][1] is None
    assert {lv is live for _, lv in calls[1:]} == {True, False}


def test_eta_fastlane_key_follows_the_metric_epoch():
    """``test_live_traffic.py::test_fastlane_key_includes_metric_epoch``
    on the port's ``EtaService``."""
    calls = []

    class SpyLane:
        def accepts(self, n):
            return True

        def predict(self, rows, generation, compute, span=None, blob=None):
            calls.append(generation)
            return compute(rows)

    svc = EtaService(ServeConfig(batch_buckets=(8,)), model_path=os.path.join(
        REPO, "artifacts", "eta_mlp.msgpack"), device="cpu")
    assert svc.available
    svc._fastlane = SpyLane()
    rows = np.zeros((1, svc._model.n_features), np.float32)
    tlive.set_metric_epoch(0)
    svc.predict_batch(rows)
    tlive.set_metric_epoch(41)
    svc.predict_batch(rows)
    assert calls[0] != calls[1]
    assert calls[0][0] == calls[1][0]      # same model generation
    assert calls[1][1] == 41               # epoch in the key


def test_live_loop_runs_without_jax():
    """Fleet → bus → ingester thread → customizer → live route legs, with
    jax and the JAX package unimportable."""
    import subprocess
    import sys

    code = f"""
import sys, time
for m in ("jax", "flax", "msgpack", "werkzeug", "routest_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from routest_tpu_torch.data.road_graph import generate_road_graph
from routest_tpu_torch.live.customize import MetricCustomizer
from routest_tpu_torch.live.ingest import ProbeIngester
from routest_tpu_torch.live.probes import ProbeFleet
from routest_tpu_torch.live.state import CongestionState
from routest_tpu_torch.optimize.road_router import RoadRouter
from routest_tpu_torch.serve.bus import InMemoryBus
r = RoadRouter(graph=generate_road_graph(n_nodes=200, seed=2), use_gnn=False,
               use_transformer=False, device="cpu")
bus = InMemoryBus()
st = CongestionState(r.freeflow_time_s, stale_s=1e9)
ing = ProbeIngester(bus, st, r.length_m)
ing.start()
while not bus._subscribers.get(ing.channel):
    time.sleep(0.01)
fleet = ProbeFleet(r.graph_dict(), 30, bus.publish, seed=1)
for t in range(4):
    fleet.step(now=100.0 + t, hour=8)
while ing.batches < fleet.published:
    time.sleep(0.01)
ing.stop()
res = MetricCustomizer(r, st).run_once(now=110.0)
assert res["flipped"], res
legs = r.route_legs(r.coords[[3, 50, 120]], 1.0, hour=8)
assert legs.cost_model == "live+freeflow"
assert np.isfinite(legs.duration_matrix()).all()
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "msgpack", "werkzeug", "routest_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
