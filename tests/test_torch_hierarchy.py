"""The port's partition overlay (``routest_tpu_torch/optimize/
hierarchy.py``) against the JAX package's, the port on the CPU.

Every float operation of the overlay is a min, one float32 add or
subtract, or the one multiply ``T * (1 + slack)`` of ``_prune_cliques``,
so the comparisons here are bitwise: the host helpers' outputs, each
device primitive against its JAX twin, every key, dtype and value of the
v4 cache payload (stats apart from their ``*_s`` timings), and the
query's and the full solve's distances and predecessor edges. The answers
are also held to a scipy Dijkstra oracle (rtol 1e-4, unreachable stays
unreachable), and predecessor walks reconstruct. Cache files written by
either package load in the other. ``ROUTEST_HIER_CACHE=0`` (from
``tests/conftest.py``) holds except inside ``tmp_path`` tests."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import dijkstra

from routest_tpu.data.road_graph import generate_road_graph, subdivide_graph
from routest_tpu.optimize import hierarchy as jh
from routest_tpu.optimize import road_router as jrr
from routest_tpu_torch.optimize import hierarchy as th
from routest_tpu_torch.optimize import road_router as trr


def _same(got, want, what=""):
    """Bitwise equal; integer ids may differ in width (the port indexes
    with int64 where JAX holds int32)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == want.dtype.kind == "i":
        assert (got == want).all(), what
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), what


def _oracle(n, s, r, w, sources):
    """float64 Dijkstra; parallel edges keep their shortest weight."""
    s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
    w = np.asarray(w, np.float64)
    order = np.lexsort((w, r, s))
    s, r, w = s[order], r[order], w[order]
    first = np.ones(len(s), bool)
    first[1:] = (s[1:] != s[:-1]) | (r[1:] != r[:-1])
    adj = sp.csr_matrix((w[first], (s[first], r[first])), shape=(n, n))
    return dijkstra(adj, directed=True, indices=np.asarray(sources, np.int64))


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

def _dense_digraph():
    """160 nodes, every ordered pair an edge: two 80-node cells whose
    6,320 in-cell edges pass the ``e_max >= 64 * c_max`` dense test."""
    rng = np.random.default_rng(3)
    n = 160
    coords = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    s, r = np.nonzero(~np.eye(n, dtype=bool))
    w = rng.uniform(50, 500, len(s)).astype(np.float32)
    return coords, s, r, w


def _stars(b=70):
    """Four stars (a hub, ``b`` leaves) joined leaf to leaf: level-1
    cliques are complete (hub paths imply no edge), so the level-2
    overlay is clique-dense and its ascend folds the ``pt`` table."""
    rng = np.random.default_rng(0)
    centers = [(0.0, 0.0), (0.0, 1.0), (10.0, 0.0), (10.0, 1.0)]
    coords, s, r, w = [], [], [], []

    def edge(a, c, wt):
        s.extend([a, c])
        r.extend([c, a])
        w.extend([wt, wt])

    for ci, (x, y) in enumerate(centers):
        hub = ci * (b + 1)
        coords.append((x, y))
        ang = rng.uniform(0, 2 * np.pi, b)
        for i in range(b):
            coords.append((x + 0.05 * np.cos(ang[i]),
                           y + 0.05 * np.sin(ang[i])))
            edge(hub, hub + 1 + i, rng.uniform(10, 100))
    for i in range(b):
        for a, c in ((0, 1), (2, 3)):
            edge(a * (b + 1) + 1 + i, c * (b + 1) + 1 + i,
                 rng.uniform(5, 50))
        if i % 2 == 0:
            edge(1 + i, 2 * (b + 1) + 1 + i, rng.uniform(5, 50))
    return (np.asarray(coords, np.float32), np.asarray(s), np.asarray(r),
            np.asarray(w, np.float32))


def _gen(n, seed, sub=None):
    g = generate_road_graph(n_nodes=n, seed=seed)
    if sub is not None:
        g = subdivide_graph(g, **sub)
    return g["node_coords"], g["senders"], g["receivers"], g["length_m"]


# name → (graph, env knobs, build kwargs)
GRAPHS = {
    "sym1500": (lambda: _gen(1500, 2), {}, {}),
    "sub600": (lambda: _gen(600, 11, dict(bends_per_edge=2, oneway_frac=0.2,
                                          seed=2)),
               {"ROUTEST_HIER_RATIO": "4", "ROUTEST_HIER_CELL_TARGET": "24"},
               {}),
    "deep410": (lambda: _gen(410, 13, dict(bends_per_edge=2,
                                           oneway_frac=0.1, seed=0)),
                {"ROUTEST_HIER_CONTRACT": "0"},
                {"cell_targets": [24, 96, 384]}),
    "dense160": (_dense_digraph, {}, {"cell_target": 80}),
    "stars284": (_stars, {"ROUTEST_HIER_CONTRACT": "0"},
                 {"cell_targets": [71, 142]}),
}
_BUILT = {}


def _build_pair(name):
    """(graph arrays, JAX index, port index), built once per module."""
    if name not in _BUILT:
        make, env, kw = GRAPHS[name]
        g = make()
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            j = jh.HierarchicalIndex.build(*g, **kw)
            t = th.HierarchicalIndex.build(*g, device="cpu", **kw)
        _BUILT[name] = (g, j, t)
    return _BUILT[name]


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    return (request.param,) + _build_pair(request.param)


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def test_partition_cells_bounded_and_total():
    coords = np.random.default_rng(0).uniform(0, 1, (777, 2)).astype(
        np.float32)
    cell, n_cells = th.partition_cells(coords, 50)
    assert cell.shape == (777,) and n_cells >= 777 // 50
    sizes = np.bincount(cell, minlength=n_cells)
    assert sizes.max() <= 50 and sizes.sum() == 777
    jcell, jn = jh.partition_cells(coords, 50)
    assert jn == n_cells and cell.tobytes() == jcell.tobytes()


@pytest.mark.parametrize("targets", [[24], [24, 96], [40, 160, 640]])
def test_partition_nested_matches(targets):
    coords = np.random.default_rng(len(targets)).uniform(
        0, 1, (1300, 2)).astype(np.float32)
    got = th.partition_cells_nested(coords, targets)
    want = jh.partition_cells_nested(coords, targets)
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (w, _) in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # nesting: every fine cell lies inside one coarse cell
    for (fine, _), (coarse, _) in zip(got[:-1], got[1:]):
        pairs = np.unique(np.stack([fine, coarse], 1), axis=0)
        assert len(np.unique(pairs[:, 0])) == len(pairs)


@pytest.mark.parametrize("env", [
    {}, {"ROUTEST_HIER_LABELS": "0"}, {"ROUTEST_HIER_RATIO": "3"},
    {"ROUTEST_HIER_MAX_LEVELS": "2", "ROUTEST_HIER_CELL_TARGET": "50"},
    {"ROUTEST_HIER_RATIO": "junk", "ROUTEST_HIER_LABELS": "junk"}])
def test_level_targets_and_knobs_match(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for n in (500, 8192, 50_066, 250_000):
        assert th._level_targets(n) == jh._level_targets(n)
        assert th._level_targets(n, 40) == jh._level_targets(n, 40)
    assert th.build_params() == jh.build_params()
    assert th._LABEL_STOP == jh._LABEL_STOP
    assert th._ELL_W == jh._ELL_W and th._K_SWEEPS == jh._K_SWEEPS
    assert th._CACHE_VERSION == jh._CACHE_VERSION
    fp = {"n_nodes": 10, "coords_crc32": 1, "n_edges": 9, "edges_crc32": 2}
    assert th._fingerprint_digest(fp) == jh._fingerprint_digest(fp)


def test_hier_min_nodes_knob(monkeypatch):
    assert th.hier_min_nodes() == jh.hier_min_nodes() == 4096
    for raw in ("1", "0", "junk"):
        monkeypatch.setenv("ROUTEST_HIER_MIN_NODES", raw)
        assert th.hier_min_nodes() == jh.hier_min_nodes()


def _roundabout(m=24):
    theta = 2 * np.pi * np.arange(m) / m
    coords = np.stack([np.sin(theta), np.cos(theta)], axis=1).astype(
        np.float32)
    s = np.concatenate([np.arange(m), (np.arange(m) + 1) % m])
    r = np.concatenate([(np.arange(m) + 1) % m, np.arange(m)])
    return coords, s, r, np.full(len(s), 10.0, np.float32)


@pytest.mark.parametrize("case", ["sub", "oneway", "roundabout", "none"])
def test_contract_chains_matches(case):
    if case == "roundabout":
        g = _roundabout()
    elif case == "none":
        g = _gen(300, 4)
    else:
        g = _gen(300, 4, dict(bends_per_edge=3, seed=1,
                              oneway_frac=0.4 if case == "oneway" else 0.0))
    for cap in (1, 2, 5):
        got = th._contract_chains(*g, cap)
        want = jh._contract_chains(*g, cap)
        assert (got is None) == (want is None) == (case == "none")
        if want is None:
            continue
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key], key)


def test_ell_packings_and_tiers_match():
    rng = np.random.default_rng(8)
    P, c_max, E = 6, 30, 400
    cell = np.sort(rng.integers(0, P, E))
    s_loc = rng.integers(0, c_max, E)
    r_loc = rng.integers(0, c_max, E)
    order = np.lexsort((r_loc, cell))
    cell, s_loc, r_loc = cell[order], s_loc[order], r_loc[order]
    w = rng.uniform(1, 9, E).astype(np.float32)
    for got, want in zip(th._ell_pack(cell, s_loc, r_loc, w, P, c_max),
                         jh._ell_pack(cell, s_loc, r_loc, w, P, c_max)):
        _same(got, want, "ell_pack")
    for got, want in zip(th._ell_pack(cell[:0], s_loc[:0], r_loc[:0], w[:0],
                                      P, c_max),
                         jh._ell_pack(cell[:0], s_loc[:0], r_loc[:0], w[:0],
                                      P, c_max)):
        _same(got, want, "ell_pack empty")
    n = 90
    r = np.sort(rng.integers(0, n, E)).astype(np.int32)
    s = rng.integers(0, n, E).astype(np.int32)
    tags = rng.integers(0, 10_000, E).astype(np.int32)
    for got, want in zip(th._pack_ell_flat(s, r, w, tags, n),
                         jh._pack_ell_flat(s, r, w, tags, n)):
        _same(got, want, "pack_ell_flat")
    for got, want in zip(th._pack_ell_flat(s[:0], r[:0], w[:0], tags[:0], n),
                         jh._pack_ell_flat(s[:0], r[:0], w[:0], tags[:0], n)):
        _same(got, want, "pack_ell_flat empty")
    for bc in ([50, 49, 30, 20, 20, 11, 9, 3, 0, 0], [7] * 20,
               list(range(40, 0, -1)), [0, 0]):
        bc = np.asarray(bc)
        assert th._stitch_tiers(bc) == jh._stitch_tiers(bc)
        assert th._stitch_tiers(bc, 2, 1) == jh._stitch_tiers(bc, 2, 1)
    for args in ((64, 46, 600, 128), (4, 145, 90_000, 286), (1000, 3, 4, 9)):
        assert th._table_chunk(*args) == jh._table_chunk(*args)
    for n in (5, 17):
        for key, val in jh._identity_fill(n).items():
            _same(th._identity_fill(n)[key], val, key)


# ---------------------------------------------------------------------------
# Device primitives against their JAX twins
# ---------------------------------------------------------------------------

def _cells(rng, G, c_max, e_max, zero_frac=0.1):
    """(G, e_max) cell-local edges sorted by receiver, padded with
    (0, c_max-1, INF) edges; some zero weights for ties."""
    ces = np.zeros((G, e_max), np.int32)
    cer = np.full((G, e_max), c_max - 1, np.int32)
    cew = np.full((G, e_max), 3e38, np.float32)
    for g in range(G):
        k = rng.integers(e_max // 2, e_max + 1)
        r = np.sort(rng.integers(0, c_max, k))
        ces[g, :k] = rng.integers(0, c_max, k)
        cer[g, :k] = r
        cew[g, :k] = np.where(rng.random(k) < zero_frac, 0.0,
                              rng.choice([1.0, 2.5, 7.25, 13.0], k))
    return ces, cer, cew


def test_relax_blockdiag_bitwise():
    rng = np.random.default_rng(1)
    G, c_max, e_max, R = 5, 24, 70, 6
    ces, cer, cew = _cells(rng, G, c_max, e_max)
    d0 = np.full((R, G * c_max), 3e38, np.float32)
    d0[np.arange(R)[:, None], rng.integers(0, G * c_max, (R, 3))] = 0.0
    want = jh._relax_blockdiag(jnp.asarray(ces), jnp.asarray(cer),
                               jnp.asarray(cew), jnp.asarray(d0),
                               c_max=c_max, max_iters=c_max + 4)
    got = th._relax_blockdiag(th._dev_i64(ces, "cpu"),
                              th._dev_i64(cer, "cpu"),
                              th._dev_f32(cew, "cpu"), torch.from_numpy(d0),
                              c_max=c_max, max_iters=c_max + 4)
    _same(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_iters", [4, 8, 40])
def test_relax_ell_bitwise_and_counts(max_iters):
    rng = np.random.default_rng(max_iters)
    P, c_max, E = 7, 28, 500
    cell = np.sort(rng.integers(0, P, E))
    s_loc = rng.integers(0, c_max, E)
    r_loc = rng.integers(0, c_max, E)
    order = np.lexsort((r_loc, cell))
    cell, s_loc, r_loc = cell[order], s_loc[order], r_loc[order]
    w = rng.choice([0.0, 1.0, 3.5, 11.0], E).astype(np.float32)
    es, ew_, er = jh._ell_pack(cell, s_loc, r_loc, w, P, c_max)
    p = rng.integers(0, P, 9)
    d0 = np.full((9, c_max), 3e38, np.float32)
    d0[np.arange(9), rng.integers(0, c_max, 9)] = 0.0
    d0[np.arange(9), rng.integers(0, c_max, 9)] = 4.0
    want = jh._relax_ell(jnp.asarray(es)[p], jnp.asarray(ew_)[p],
                         jnp.asarray(er)[p], jnp.asarray(d0), c_max=c_max,
                         max_iters=max_iters)
    th._relax_ell.calls = th._relax_ell.sweeps = th._relax_ell.checks = 0
    got = th._relax_ell(th._dev_i64(es, "cpu")[p], th._dev_f32(ew_, "cpu")[p],
                        th._dev_i64(er, "cpu")[p], torch.from_numpy(d0),
                        c_max=c_max, max_iters=max_iters)
    _same(got.numpy(), np.asarray(want))
    assert th._relax_ell.calls == 1
    assert th._relax_ell.sweeps == 4 * th._relax_ell.checks
    assert 1 <= th._relax_ell.checks <= -(-max_iters // 4)


@pytest.mark.parametrize("n_sweeps", [1, 2, 3])
def test_polish_bitwise(n_sweeps):
    rng = np.random.default_rng(n_sweeps)
    n, e = 60, 300
    r = np.sort(rng.integers(0, n, e)).astype(np.int32)
    s = rng.integers(0, n, e).astype(np.int32)
    w = rng.choice([0.0, 1.5, 2.0, 9.0], e).astype(np.float32)
    dist = rng.choice([0.0, 3.0, 5.5, 3e38], (4, n)).astype(np.float32)
    want = jh.polish(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                     jnp.asarray(dist), n_nodes=n, n_sweeps=n_sweeps)
    before = th.polish.sweeps
    got = th.polish(torch.from_numpy(s.astype(np.int64)),
                    torch.from_numpy(r.astype(np.int64)), torch.from_numpy(w),
                    torch.from_numpy(dist), n_sweeps=n_sweeps)
    _same(got.numpy(), np.asarray(want))
    assert th.polish.sweeps - before == n_sweeps


@pytest.mark.parametrize("slack", [0.0, 2e-7, 1e-3])
def test_prune_cliques_bitwise(slack):
    rng = np.random.default_rng(4)
    P, b = 3, 17
    # restricted metrics with exact triangles, near ties, sub-1 m legs
    # and unreachable pairs
    pts = rng.uniform(0, 50, (P, b, 2))
    T = np.abs(pts[:, :, None, 0] - pts[:, None, :, 0]) + np.abs(
        pts[:, :, None, 1] - pts[:, None, :, 1])
    T = np.where(rng.random(T.shape) < 0.05, T * (1 + 1e-7), T)
    T[:, 0, 1] = 0.5
    T[:, 2, :] = 3e38
    T = T.astype(np.float32)
    want = np.asarray(jh._prune_cliques(jnp.asarray(T), slack=slack))
    got = th._prune_cliques(torch.from_numpy(T), slack=slack).numpy()
    assert got.dtype == want.dtype == bool
    assert (got == want).all() and 0 < got.sum() < got.size


def test_cell_all_pairs_and_labels_bitwise():
    rng = np.random.default_rng(6)
    P, c_max, e_max = 3, 40, 150
    ces, cer, cew = _cells(rng, P, c_max, e_max)
    sizes = np.asarray([40, 33, 21])
    _same(th._cell_all_pairs(ces, cer, cew, sizes, c_max, "cpu"),
          jh._cell_all_pairs(ces, cer, cew, sizes, c_max))
    n_top = 90
    r = np.sort(rng.integers(0, n_top, 600)).astype(np.int32)
    s = rng.integers(0, n_top, 600).astype(np.int32)
    w = rng.uniform(1, 40, 600).astype(np.float32)
    got, gstats = th._build_labels(s, r, w, n_top, "cpu")
    want, wstats = jh._build_labels(s, r, w, n_top)
    _same(got, want)
    assert {k: v for k, v in gstats.items() if k != "build_s"} == \
        {k: v for k, v in wstats.items() if k != "build_s"}


# ---------------------------------------------------------------------------
# Built indexes
# ---------------------------------------------------------------------------

def _strip_timings(d):
    if isinstance(d, dict):
        return {k: _strip_timings(v) for k, v in d.items()
                if not k.endswith("_s")}
    if isinstance(d, list):
        return [_strip_timings(x) for x in d]
    return d


def _npz(index, path, fp):
    index._save(str(path), fp)
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_build_payload_bitwise(pair, tmp_path):
    name, g, j, t = pair
    assert j is not None and t is not None
    if name == "dense160":
        assert t.levels[0].d_pt is not None
    if name == "stars284":
        assert t.levels[1].d_pt is not None and t.n_levels == 2
    if name == "sub600":
        assert t.n_levels >= 2 and t.n_contracted < t.n_nodes
    if name == "deep410":
        assert t.n_levels == 3
    fp = {"graph": name}
    want = _npz(j, tmp_path / "j.npz", fp)
    got = _npz(t, tmp_path / "t.npz", fp)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "_stats":
            gs, ws = (json.loads(bytes(x[key]).decode()) for x in (got, want))
            assert _strip_timings(gs) == _strip_timings(ws)
            continue
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key
    assert [lv.tiers for lv in t.levels] == [lv.tiers for lv in j.levels]


def _sources(index, rng):
    """Random, level-1 boundary and chain-interior full-graph nodes."""
    kept = np.flatnonzero(index._expand_idx >= 0)
    interior = np.flatnonzero(index._expand_idx < 0)
    cid_to_full = np.full(index.n_contracted, -1, np.int64)
    cid_to_full[index._expand_idx[kept]] = kept
    boundary = cid_to_full[index.levels[0].b_global]
    picks = [rng.integers(0, index.n_nodes, 4),
             rng.choice(boundary, 3, replace=False)]
    if len(interior):
        picks.append(rng.choice(interior, 3, replace=False))
    return np.concatenate(picks).astype(np.int64)


def _walk_ok(senders, pred_row, source, target, n):
    node = int(target)
    for _ in range(n):
        if node == source:
            return True
        e = int(pred_row[node])
        if e < 0:
            return False
        node = int(senders[e])
    return node == source


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_full_solve_and_query_bitwise(pair, n_sweeps):
    name, g, j, t = pair
    coords, s, r, w = g
    rng = np.random.default_rng(n_sweeps)
    src = _sources(t, rng)
    jd, jp = jax.jit(j.full_solve_fn(n_sweeps))(
        *j.prep_sources(src), jnp.asarray(src.astype(np.int32)))
    args = t.prep_sources(src)
    for got, want in zip(args, j.prep_sources(src)):
        _same(got.numpy(), np.asarray(want))
    td, tp = t.full_solve_fn(n_sweeps)(*args, torch.from_numpy(src))
    td, tp = td.numpy(), tp.numpy()
    _same(td, np.asarray(jd), "dist")
    assert (tp == np.asarray(jp)).all()
    _same(t.query_fn(*args).numpy(),
          np.asarray(j.query_fn(*j.prep_sources(src))), "query")
    # against the oracle; unreachable stays unreachable
    want = _oracle(t.n_nodes, s, r, w, src)
    finite = np.isfinite(want)
    assert finite.mean() > 0.5
    np.testing.assert_allclose(td[finite], want[finite], rtol=1e-4)
    assert (td[~finite] > 1e37).all()
    # predecessor walks reconstruct
    senders = np.asarray(s)
    for si in range(len(src)):
        for tgt in rng.integers(0, t.n_nodes, 5):
            if finite[si, tgt]:
                assert _walk_ok(senders, tp[si], int(src[si]), int(tgt),
                                t.n_nodes)


def test_timed_query_stages(pair):
    name, g, j, t = pair
    src = np.asarray([0, 7, 11])
    dist, phases = t.timed_query(src)
    _same(dist, t.query_fn(*t.prep_sources(src)).numpy())
    jdist, jphases = j.timed_query(src)
    _same(dist, jdist)
    assert list(phases) == list(jphases)
    assert all(ms >= 0 for ms in phases.values())


def test_build_declines_tiny_graphs():
    g = _gen(64, 0)
    assert th.HierarchicalIndex.build(*g, cell_target=4096,
                                      device="cpu") is None
    assert jh.HierarchicalIndex.build(*g, cell_target=4096) is None


def test_build_refuses_a_missing_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        th.HierarchicalIndex.build(*_gen(300, 1), device="cuda")


def test_same_cell_leave_and_reenter(monkeypatch):
    """Source and target in the SAME cell whose shortest path exits and
    re-enters: the descend stitch must beat the in-cell-only value."""
    coords = np.asarray([[0.0, x] for x in range(8)], np.float32)
    s, r, w = [], [], []

    def edge(a, b, wt):
        s.extend([a, b])
        r.extend([b, a])
        w.extend([wt, wt])

    for a, b, wt in ((0, 1, 100.0), (1, 2, 100.0), (2, 3, 100.0),
                     (0, 4, 2.0), (4, 5, 2.0), (5, 6, 2.0), (6, 7, 2.0),
                     (7, 3, 2.0)):
        edge(a, b, wt)
    monkeypatch.setenv("ROUTEST_HIER_CONTRACT", "0")
    g = (coords, np.asarray(s), np.asarray(r), np.asarray(w, np.float32))
    j = jh.HierarchicalIndex.build(*g, cell_targets=[4])
    t = th.HierarchicalIndex.build(*g, cell_targets=[4], device="cpu")
    src = np.asarray([0, 3])
    dist = t.query_fn(*t.prep_sources(src)).numpy()
    _same(dist, np.asarray(j.query_fn(*j.prep_sources(src))))
    np.testing.assert_allclose(dist[0, [3, 2, 1]], [10.0, 110.0, 100.0],
                               rtol=1e-6)
    td, tp = t.full_solve_fn(1)(*t.prep_sources(src), torch.from_numpy(src))
    jd, jp = jax.jit(j.full_solve_fn(1))(*j.prep_sources(src),
                                         jnp.asarray(src.astype(np.int32)))
    _same(td.numpy(), np.asarray(jd))
    assert (tp.numpy() == np.asarray(jp)).all()
    assert _walk_ok(np.asarray(s), tp.numpy()[0], 0, 2, 8)


def test_unreachable_pocket_stays_unreachable(monkeypatch):
    """A pocket with only OUTGOING edges to the main graph is
    undirected-connected but directionally unreachable: INF, as the
    reference and the flat solver say."""
    monkeypatch.setenv("ROUTEST_HIER_CELL_TARGET", "48")
    g = generate_road_graph(n_nodes=400, seed=17)
    n = len(g["node_coords"])
    pocket = 6
    coords = np.concatenate([
        g["node_coords"],
        g["node_coords"][:1] + 0.001 * (1 + np.arange(pocket))[:, None]],
        axis=0).astype(np.float32)
    ps = np.arange(n, n + pocket - 1)
    s = np.concatenate([g["senders"], ps, ps + 1, [n]]).astype(np.int32)
    r = np.concatenate([g["receivers"], ps + 1, ps, [0]]).astype(np.int32)
    w = np.concatenate([g["length_m"],
                        np.full(2 * (pocket - 1) + 1, 50.0)]).astype(
                            np.float32)
    j = jh.HierarchicalIndex.build(coords, s, r, w)
    t = th.HierarchicalIndex.build(coords, s, r, w, device="cpu")
    src = np.random.default_rng(2).integers(0, n, 4)
    td, tp = t.full_solve_fn(1)(*t.prep_sources(src), torch.from_numpy(src))
    jd, jp = jax.jit(j.full_solve_fn(1))(*j.prep_sources(src),
                                         jnp.asarray(src.astype(np.int32)))
    _same(td.numpy(), np.asarray(jd))
    assert (tp.numpy() == np.asarray(jp)).all()
    assert (td.numpy()[:, n:] > 1e37).all()
    assert (tp.numpy()[:, n:] == -1).all()
    want = _oracle(len(coords), s, r, w, src)
    finite = np.isfinite(want)
    np.testing.assert_allclose(td.numpy()[finite], want[finite], rtol=1e-4)


def test_contraction_roundabout_cycle_exact():
    """An all-degree-2 cycle has no natural chain endpoint; contraction
    breaks it, and the full solve synthesizes every interior exactly."""
    coords, s, r, w = _roundabout()
    j = jh.HierarchicalIndex.build(coords, s, r, w, cell_targets=[3])
    t = th.HierarchicalIndex.build(coords, s, r, w, cell_targets=[3],
                                   device="cpu")
    assert t._contracted
    src = np.asarray([0, 5, 7])
    td, tp = t.full_solve_fn(1)(*t.prep_sources(src), torch.from_numpy(src))
    jd, jp = jax.jit(j.full_solve_fn(1))(*j.prep_sources(src),
                                         jnp.asarray(src.astype(np.int32)))
    _same(td.numpy(), np.asarray(jd))
    assert (tp.numpy() == np.asarray(jp)).all()
    m = len(coords)
    ring = np.minimum(np.abs(src[:, None] - np.arange(m)[None, :]),
                      m - np.abs(src[:, None] - np.arange(m)[None, :])) * 10.0
    np.testing.assert_allclose(td.numpy(), ring, rtol=1e-6)


# ---------------------------------------------------------------------------
# The cache file, shared by both packages
# ---------------------------------------------------------------------------

def test_cache_round_trips_between_packages(tmp_path):
    name, g, j, t = ("sub600",) + _build_pair("sub600")
    fp = {"n_nodes": int(t.n_nodes), "graph": name}
    src = _sources(t, np.random.default_rng(5))
    j._save(str(tmp_path / "from_jax.npz"), fp)
    t._save(str(tmp_path / "from_port.npz"), fp)
    t_from_j = th.HierarchicalIndex.load(str(tmp_path / "from_jax.npz"), fp,
                                         device="cpu")
    j_from_t = jh.HierarchicalIndex.load(str(tmp_path / "from_port.npz"), fp)
    assert t_from_j.stats["loaded_from_cache"] is True
    assert j_from_t.stats["loaded_from_cache"] is True
    assert t_from_j._structure is not None
    for key in ("c_senders", "c_receivers", "edge_comp", "fill_comp"):
        _same(t_from_j._structure[key], j._structure[key], key)
    want_d, want_p = t.full_solve_fn(1)(*t.prep_sources(src),
                                        torch.from_numpy(src))
    got_d, got_p = t_from_j.full_solve_fn(1)(*t_from_j.prep_sources(src),
                                             torch.from_numpy(src))
    _same(got_d.numpy(), want_d.numpy())
    assert (got_p.numpy() == want_p.numpy()).all()
    jd, jp = jax.jit(j_from_t.full_solve_fn(1))(
        *j_from_t.prep_sources(src), jnp.asarray(src.astype(np.int32)))
    _same(np.asarray(jd), want_d.numpy())
    assert (np.asarray(jp) == want_p.numpy()).all()
    # the embedded fingerprint binds the payload to its graph
    assert th.HierarchicalIndex.load(str(tmp_path / "from_jax.npz"),
                                     {"graph": "other"}, device="cpu") is None
    assert th.HierarchicalIndex.load(str(tmp_path / "nope.npz"), fp,
                                     device="cpu") is None


def test_cache_wrong_version_rejected(tmp_path):
    _, j, t = _build_pair("sym1500")
    path = tmp_path / "hier.npz"
    t._save(str(path), {})
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["_version"] = np.int64(999)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    path.write_bytes(buf.getvalue())
    assert th.HierarchicalIndex.load(str(path), device="cpu") is None
    assert jh.HierarchicalIndex.load(str(path)) is None
    path.write_bytes(b"garbage")
    assert th.HierarchicalIndex.load(str(path), device="cpu") is None


def test_build_params_change_cache_filename(monkeypatch, tmp_path):
    monkeypatch.setenv("ROUTEST_HIER_CACHE", str(tmp_path))
    fp = {"n_nodes": 10, "coords_crc32": 1, "n_edges": 9, "edges_crc32": 2}
    a = th.hier_cache_path(fp)
    assert a == jh.hier_cache_path(fp)
    monkeypatch.setenv("ROUTEST_HIER_PRUNE_SLACK", "1e-6")
    b = th.hier_cache_path(fp)
    monkeypatch.delenv("ROUTEST_HIER_PRUNE_SLACK")
    monkeypatch.setenv("ROUTEST_HIER_MAX_LEVELS", "1")
    c = th.hier_cache_path(fp)
    assert len({a, b, c}) == 3
    monkeypatch.setenv("ROUTEST_HIER_CACHE", "off")
    assert th.hier_cache_path(fp) is None
    monkeypatch.delenv("ROUTEST_HIER_CACHE")
    assert th.hier_cache_path(fp) == jh.hier_cache_path(fp)
    assert os.path.basename(th.hier_cache_path(fp)).startswith("hier-v4-")


# ---------------------------------------------------------------------------
# The router over the overlay
# ---------------------------------------------------------------------------

@pytest.fixture()
def force_hier(monkeypatch):
    """Route small graphs through the overlay; the JAX router compiles
    no AOT buckets (the port has none)."""
    monkeypatch.setenv("ROUTEST_HIER_MIN_NODES", "1")
    monkeypatch.setenv("ROUTEST_ROUTER_AOT", "off")


def test_router_overlay_bitwise_and_solver_info(force_hier, monkeypatch):
    graph = generate_road_graph(n_nodes=900, seed=3)
    jr = jrr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False,
                        device="cpu")
    assert tr._hier is not None
    for n_src in (1, 5, 17):
        src = np.random.default_rng(n_src).integers(0, tr.n_nodes, n_src)
        jd, jp = jr.shortest(src)
        td, tp = tr.shortest(src)
        assert td.dtype == jd.dtype and tp.dtype == jp.dtype == np.int32
        assert td.tobytes() == jd.tobytes() and tp.tobytes() == jp.tobytes()
    info, jinfo = tr.solver_info, jr.solver_info
    assert list(info) == list(jinfo)
    assert info["solver"] == "hierarchy" and info["aot_buckets"] == []
    assert info["hub_labels"] is jinfo["hub_labels"] is True
    assert _strip_timings(info["overlay"]) == _strip_timings(jinfo["overlay"])
    assert info["overlay"]["cache_version"] == 4
    json.dumps(info)
    # ... and agrees with the flat solver to float32 re-association
    monkeypatch.setenv("ROUTEST_HIER_MIN_NODES", "0")
    flat = trr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False,
                          device="cpu")
    assert flat._hier is None and flat.solver_info["solver"] == "flat_bf"
    np.testing.assert_allclose(flat.shortest(src)[0], td, rtol=1e-5)


def test_router_disk_cache_shared_with_jax(force_hier, monkeypatch,
                                           tmp_path):
    monkeypatch.setenv("ROUTEST_HIER_CACHE", str(tmp_path))
    graph = generate_road_graph(n_nodes=1200, seed=6)
    built = trr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False,
                           device="cpu")
    files = list(tmp_path.glob("hier-v4-*.npz"))
    assert len(files) == 1
    assert not built.solver_info["overlay"]["loaded_from_cache"]
    # the JAX router rehydrates the port's file (same name) ...
    jr = jrr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False)
    assert jr._hier.stats.get("loaded_from_cache") is True
    # ... and a second port router too; all answer identically
    loaded = trr.RoadRouter(graph=graph, use_gnn=False,
                            use_transformer=False, device="cpu")
    assert loaded.solver_info["overlay"]["loaded_from_cache"] is True
    src = np.random.default_rng(3).integers(0, built.n_nodes, 5)
    want = built.shortest(src)
    for other in (loaded, jr):
        got = other.shortest(src)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()
    # corruption degrades to a fresh build, never an error
    files[0].write_bytes(b"garbage")
    rebuilt = trr.RoadRouter(graph=graph, use_gnn=False,
                             use_transformer=False, device="cpu")
    assert not rebuilt.solver_info["overlay"]["loaded_from_cache"]
    assert rebuilt.shortest(src)[0].tobytes() == want[0].tobytes()


def test_router_counts_overlay_relaxations(force_hier):
    tr = trr.RoadRouter(graph=generate_road_graph(n_nodes=600, seed=9),
                        use_gnn=False, use_transformer=False, device="cpu")
    before = (th._relax_ell.calls, th.relax_from.calls)
    tr._solve_rows(np.asarray([0, 5, 9]))
    # one ELL relaxation per level (phase1 + each ascend), hub labels on
    # top: no flat relaxation
    assert th._relax_ell.calls - before[0] == tr._hier.n_levels
    assert th.relax_from.calls == before[1]


def test_overlay_runs_without_jax(tmp_path):
    """The port's overlay builds, caches, reloads and solves with jax and
    the JAX package unimportable."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import sys
for m in ("jax", "flax", "msgpack", "werkzeug", "routest_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {repo!r})
import numpy as np, torch
from routest_tpu_torch.data.road_graph import generate_road_graph
from routest_tpu_torch.optimize.hierarchy import HierarchicalIndex
g = generate_road_graph(n_nodes=500, seed=1)
args = (g["node_coords"], g["senders"], g["receivers"], g["length_m"])
path = {str(tmp_path / "h.npz")!r}
built = HierarchicalIndex.build(*args, cache_path=path, fingerprint={{}},
                                device="cpu")
loaded = HierarchicalIndex.load(path, {{}}, device="cpu")
src = np.asarray([0, 9])
a = built.full_solve_fn(1)(*built.prep_sources(src), torch.from_numpy(src))
b = loaded.full_solve_fn(1)(*loaded.prep_sources(src), torch.from_numpy(src))
assert all(torch.equal(x, y) for x, y in zip(a, b))
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "msgpack", "werkzeug", "routest_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
