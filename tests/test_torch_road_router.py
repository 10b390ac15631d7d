"""The port's flat road router (``optimize/road_router.py``,
``optimize/hierarchy.py``, ``optimize/route_cache.py``) against the JAX
package's, the port on the CPU.

Distances and predecessor edges are bitwise equal (min and one float32
add are exact); both also agree with a scipy Dijkstra oracle at rtol
1e-4, as ``tests/test_road_router.py`` checks the JAX router. The
pointer-doubling duration table is bitwise equal on the same inputs.
Merged batcher solves are bitwise lone solves; the route cache serves
hits, in-batch aliases and singleflight waiters."""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import dijkstra

from routest_tpu.data.osm import load_osm as jload_osm
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.optimize import hierarchy as jhier
from routest_tpu.optimize import road_router as jrr
from routest_tpu.optimize import route_cache as jrc
from routest_tpu_torch.data.osm import load_osm
from routest_tpu_torch.optimize import hierarchy as thier
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.optimize.route_cache import RouteCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANILA = os.path.join(REPO, "artifacts", "manila_arterials.osm.gz")


def _path_graph(n=64):
    """A chain whose hop diameter (N-1) exceeds the 4√N+8 heuristic."""
    lats = np.linspace(14.40, 14.68, n).astype(np.float32)
    s = np.arange(n - 1, dtype=np.int32)
    return {"node_coords": np.stack([lats, np.full(n, 121.0, np.float32)],
                                    axis=1),
            "senders": np.concatenate([s, s + 1]),
            "receivers": np.concatenate([s + 1, s]),
            "length_m": np.full(2 * (n - 1), 100.0, np.float32),
            "road_class": np.full(2 * (n - 1), 1, np.int32),
            "speed_limit": np.full(2 * (n - 1), 8.3, np.float32)}


GRAPHS = {
    "gen256": lambda: generate_road_graph(n_nodes=256, seed=1),
    "manila": lambda: jload_osm(MANILA),
    "path64": _path_graph,
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def routers(request):
    graph = GRAPHS[request.param]()
    return (jrr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False),
            trr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False,
                           device="cpu"))


def _oracle(router, sources):
    n = router.n_nodes
    adj = sp.coo_matrix((router.length_m, (router.senders, router.receivers)),
                        shape=(n, n)).tocsr()
    return dijkstra(adj, directed=True, indices=sources)


def test_graph_arrays_after_bridging_match(routers):
    jr, tr = routers
    for key, want in jr.graph_dict().items():
        got = tr.graph_dict()[key]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tr.freeflow_time_s.tobytes() == jr.freeflow_time_s.tobytes()
    assert tr._bf_perm.tobytes() == jr._bf_perm.tobytes()
    assert (tr.n_nodes, tr.max_iters) == (jr.n_nodes, jr.max_iters)
    assert tr._fingerprint == jr._fingerprint


@pytest.mark.parametrize("n_src", [1, 3, 16, 33])
def test_shortest_bitwise_and_matches_dijkstra(routers, n_src):
    jr, tr = routers
    sources = np.random.default_rng(n_src).integers(0, jr.n_nodes, n_src)
    jd, jp = jr.shortest(sources)
    td, tp = tr.shortest(sources)
    assert td.dtype == jd.dtype == np.float32
    assert tp.dtype == jp.dtype == np.int32
    assert td.tobytes() == jd.tobytes()
    assert tp.tobytes() == jp.tobytes()
    want = _oracle(tr, sources)
    finite = np.isfinite(want)
    np.testing.assert_allclose(td[finite], want[finite], rtol=1e-4)
    assert (td[~finite] >= 1e37).all()


def test_exhaustion_reruns_with_the_exact_bound():
    graph = _path_graph(64)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, device="cpu")
    assert tr.max_iters < tr.n_nodes - 1
    w = torch.from_numpy(tr.length_m[tr._bf_perm])
    src = torch.zeros(1, dtype=torch.int64)
    _, _, converged = trr._bellman_ford(tr._bf_senders, tr._bf_receivers, w,
                                        src, n_nodes=64,
                                        max_iters=tr.max_iters)
    jw = jnp.asarray(tr.length_m[tr._bf_perm])
    _, _, jconv = jrr._bellman_ford(
        jnp.asarray(tr.senders[tr._bf_perm]),
        jnp.asarray(tr.receivers[tr._bf_perm]), jw,
        jnp.asarray([0], jnp.int32), n_nodes=64, max_iters=tr.max_iters)
    assert converged is False and bool(jconv) is False
    dist, pred = tr.shortest(np.asarray([0]))
    np.testing.assert_allclose(dist[0], np.arange(64) * 100.0, rtol=1e-5)
    assert tr._walk(pred[0], 0, 63) == list(range(64))


def test_relax_counts_sweeps_and_checks():
    tr = trr.RoadRouter(graph=_path_graph(16), use_gnn=False, device="cpu")
    thier.relax_from.sweeps = thier.relax_from.checks = 0
    tr._solve_rows(np.asarray([0, 15]))
    # 15 hops converge in 16 sweeps: 4 rounds, then one round that
    # changes nothing (bound 4·4+8 = 24 not reached)
    assert thier.relax_from.checks == 5
    assert thier.relax_from.sweeps == 4 * thier._K_SWEEPS + 4
    assert thier._K_SWEEPS == jhier._K_SWEEPS


def test_tight_edges_bitwise_on_ties():
    """Zero-length and parallel edges: equal-distance neighbours and
    several tight in-edges per node pick the same edge ids."""
    rng = np.random.default_rng(7)
    n, e = 40, 200
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.choice([0.0, 1.0, 2.5], e).astype(np.float32)
    order = np.argsort(r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    sources = np.asarray([0, 5, 9], np.int32)
    dist0 = np.full((3, n), 3e38, np.float32)
    dist0[np.arange(3), sources] = 0.0
    jd, jc = jhier.relax_from(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                              jnp.asarray(dist0), n_nodes=n, max_iters=n)
    jp = jhier.tight_pred(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), jd,
                          jnp.asarray(sources), n_nodes=n)
    ts, tr_, tw = (torch.from_numpy(s.astype(np.int64)),
                   torch.from_numpy(r.astype(np.int64)), torch.from_numpy(w))
    td, tc = thier.relax_from(ts, tr_, tw, torch.from_numpy(dist0),
                              max_iters=n)
    tp = thier.tight_pred(ts, tr_, tw, td, torch.from_numpy(
        sources.astype(np.int64)))
    assert tc == bool(jc)
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    assert (tp.numpy().astype(np.int32).tobytes()
            == np.asarray(jp).tobytes())


def _time_table_pair(senders, pred, time_e, dist, n_rounds):
    want = np.asarray(jrr._time_table(
        jnp.asarray(senders), jnp.asarray(pred), jnp.asarray(time_e),
        jnp.asarray(dist), n_rounds=n_rounds))
    got = trr._time_table(
        torch.from_numpy(senders.astype(np.int64)),
        torch.from_numpy(pred.astype(np.int64)), torch.from_numpy(time_e),
        torch.from_numpy(dist), n_rounds=n_rounds).numpy()
    return got, want


def test_time_table_bitwise(routers):
    jr, tr = routers
    sources = np.random.default_rng(1).integers(0, jr.n_nodes, 5)
    dist, pred = tr.shortest(sources)
    time_e = (tr.freeflow_time_s * np.random.default_rng(2).uniform(
        0.5, 2.0, len(tr.freeflow_time_s))).astype(np.float32)
    n_rounds = max(1, (tr.n_nodes - 1).bit_length())
    got, want = _time_table_pair(tr.senders, pred, time_e, dist, n_rounds)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_time_table_cycles_and_unreachable_are_inf():
    senders = np.asarray([0, 1, 2], np.int32)
    time_e = np.asarray([5.0, 7.0, 0.0], np.float32)
    for pred, dist in (([[-1, 0, 1, -1]], [[0.0, 5.0, 12.0, 3e38]]),
                       ([[-1, 2, 1, -1]], [[0.0, 5.0, 5.0, 3e38]])):
        got, want = _time_table_pair(senders, np.asarray(pred, np.int32),
                                     time_e, np.asarray(dist, np.float32), 4)
        assert got.tobytes() == want.tobytes()
    assert np.isinf(got[0, 1:]).all() and got[0, 0] == 0.0


def test_route_legs_and_duration_matrix_match(routers):
    jr, tr = routers
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(14.40, 14.68, 7),
                    rng.uniform(120.96, 121.10, 7)], axis=1).astype(
                        np.float32)
    jl = jr.route_legs(pts, 1.3, hour=17)
    tl = tr.route_legs(pts, 1.3, hour=17)
    assert tl.dist_m.tobytes() == jl.dist_m.tobytes()
    assert tl._nodes.tobytes() == jl._nodes.tobytes()
    assert tl._snap_m.tobytes() == jl._snap_m.tobytes()
    assert tl.cost_model == jl.cost_model == "freeflow"
    for i in range(7):
        for j in range(7):
            assert tl.cost(i, j) == jl.cost(i, j)
            assert tl.leg(i, j) == jl.leg(i, j)
    assert tl.duration_matrix().tobytes() == jl.duration_matrix().tobytes()
    assert tl.nbytes() == jl.nbytes()


def test_snap_bitwise(routers):
    jr, tr = routers
    pts = np.random.default_rng(9).uniform(
        [14.3, 120.9], [14.8, 121.2], (50, 2)).astype(np.float32)
    assert tr.snap(pts).tobytes() == jr.snap(pts).tobytes()


def test_batch_groups_match_single(monkeypatch):
    """Row budget below the batch's rows (and below one problem): the
    grouped solves split back bitwise into per-problem solves."""
    graph = generate_road_graph(n_nodes=256, seed=1)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, device="cpu")
    rng = np.random.default_rng(5)
    problems = [(np.stack([rng.uniform(14.40, 14.68, k),
                           rng.uniform(120.96, 121.10, k)],
                          axis=1).astype(np.float32), 1.0, 8)
                for k in (3, 9, 4, 6, 2)]
    monkeypatch.setattr(trr, "_legs_batch_row_budget", lambda n: 8)
    batched = tr.route_legs_batch(problems)
    lone = trr.RoadRouter(graph=graph, use_gnn=False, device="cpu")
    for (pts, ts, hour), legs in zip(problems, batched):
        single = lone.route_legs(pts, ts, hour=hour)
        assert legs.dist_m.tobytes() == single.dist_m.tobytes()
        assert legs._pred.tobytes() == single._pred.tobytes()


def test_merged_batcher_solves_equal_lone_solves(monkeypatch):
    """Threads arriving while a solve runs merge into one dispatch; each
    gets bitwise its lone-solve rows."""
    graph = generate_road_graph(n_nodes=256, seed=1)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, device="cpu")
    lone = {k: tr._solve_rows(np.asarray(src)) for k, src in
            enumerate(([0, 1, 2], [17], [200, 5], [9, 9, 100, 3]))}
    gate = threading.Event()
    real = tr._solve_rows
    calls = []

    def slow_solve(sources, live=None):
        calls.append(len(sources))
        gate.wait(5)
        return real(sources, live)

    monkeypatch.setattr(tr, "_solve_rows", slow_solve)
    out = {}

    def run(k, src):
        out[k] = tr.shortest(np.asarray(src))

    threads = [threading.Thread(target=run, args=(k, src)) for k, src in
               enumerate(([0, 1, 2], [17], [200, 5], [9, 9, 100, 3]))]
    threads[0].start()
    while not calls:
        pass
    for t in threads[1:]:
        t.start()
    while tr._solve_batcher.stats()["requests"] < 4:
        pass
    gate.set()
    for t in threads:
        t.join(10)
    stats = tr._solve_batcher.stats()
    assert calls == [3, 7] and stats["dispatches"] == 2
    assert stats["merged_requests"] == 3 and stats["max_occupancy"] == 7
    for k in lone:
        assert out[k][0].tobytes() == lone[k][0].tobytes()
        assert out[k][1].tobytes() == lone[k][1].tobytes()


def test_route_cache_hit_alias_and_singleflight():
    graph = generate_road_graph(n_nodes=256, seed=1)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, device="cpu")
    a = np.asarray([[14.55, 121.0], [14.60, 121.05]], np.float32)
    b = np.asarray([[14.50, 120.99], [14.62, 121.02], [14.58, 121.04]],
                   np.float32)
    first = tr.route_legs_batch([(a, 1.0, 8), (a, 1.0, 8), (b, 1.0, 8)])
    assert first[0] is first[1]              # alias inside one batch
    stats = tr._route_cache.stats()
    assert (stats["misses"], stats["hits"], stats["entries"]) == (2, 0, 2)
    again = tr.route_legs_batch([(b, 1.0, 8), (a, 1.0, 9)])
    assert again[0] is first[2]              # hit
    assert tr._route_cache.stats()["hits"] == 1
    # singleflight: a waiter parked on a leader's flight gets its legs
    cache = RouteCache()
    state, flight = cache.lookup(("k",))
    assert state == "lead"
    got = {}
    waiter = threading.Thread(target=lambda: got.update(
        v=cache.wait(cache.lookup(("k",))[1])))
    waiter.start()
    while cache.stats()["coalesced"] < 1:
        pass
    cache.commit(("k",), "legs", 10)
    waiter.join(5)
    assert got["v"] == "legs" and cache.lookup(("k",)) == ("hit", "legs")
    # a failed leader reaches its waiters and caches nothing
    state, flight = cache.lookup(("x",))
    _, wait_on = cache.lookup(("x",))
    cache.abort(("x",), RuntimeError("solve failed"))
    with pytest.raises(RuntimeError, match="solve failed"):
        cache.wait(wait_on)
    assert cache.lookup(("x",))[0] == "lead"


def test_cache_and_batcher_knobs(monkeypatch):
    monkeypatch.setenv("ROUTEST_ROUTE_CACHE", "off")
    monkeypatch.setenv("ROUTEST_ROUTER_BATCH", "0")
    tr = trr.RoadRouter(graph=_path_graph(8), use_gnn=False, device="cpu")
    assert tr.solver_info == {"solver": "flat_bf", "max_iters_bound": 19}
    monkeypatch.setenv("ROUTEST_ROUTE_CACHE_MB", "junk")
    monkeypatch.setenv("ROUTEST_ROUTER_BATCH_MAX", "7")
    assert trr.route_cache_config() == jrc.route_cache_config()
    assert trr._batcher_config() == jrr._batcher_config()


def test_router_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trr.RoadRouter(graph=_path_graph(8), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trr.default_router("cuda")


def test_default_router_osm_env_and_fallback(monkeypatch):
    monkeypatch.setattr(trr, "_default_routers", {})
    monkeypatch.setenv("ROAD_GRAPH_OSM", MANILA)
    monkeypatch.setenv("ROAD_GNN_PATH", os.path.join(
        REPO, "artifacts", "road_gnn_manila.msgpack"))
    r = trr.default_router("cpu")
    assert r is trr.default_router("cpu")
    assert r.n_nodes == len(load_osm(MANILA)["node_coords"])
    assert r.leg_cost_model == "gnn" and not r.has_transformer
    monkeypatch.setattr(trr, "_default_routers", {})
    monkeypatch.setenv("ROAD_GRAPH_OSM", "/nonexistent.osm")
    monkeypatch.delenv("ROAD_GNN_PATH")
    assert trr.default_router("cpu").n_nodes == 2048
