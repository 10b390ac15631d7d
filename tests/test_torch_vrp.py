"""The port's VRP (``routest_tpu_torch/optimize/vrp.py``) against the JAX
package's on the same problems, the port on the CPU.

Both sides get the same float32 distance matrix, so only the solvers are
compared: orders, trip ids, trip lists and unroutable reports must be
equal, bit for bit, on the fixtures of ``tests/test_vrp.py`` and
``tests/test_refine.py``, on seeded random problems with fractional
demands and tight constraints, and on seeded 256-problem (greedy) and
32-problem (refined) batches. There is no exception to bitwise
equality here: the per-trip float sums are taken in XLA's order, which
``test_tour_views_bitwise`` pins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.data import geo as jgeo
from routest_tpu.optimize import vrp as jvrp
from routest_tpu_torch.optimize import vrp as tvrp


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
    return torch.tensor(a, dtype=dtype)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _euclid(rng, n, scale=100.0):
    pts = rng.uniform(0, scale, size=(n + 1, 2))
    return np.linalg.norm(pts[:, None] - pts[None, :],
                          axis=-1).astype(np.float32)


def _manila(rng, n):
    """``tests/test_refine.py::_random_instance``: haversine over random
    Metro Manila points (the JAX matrix, handed to both sides)."""
    latlon = np.stack([14.4 + 0.3 * rng.random(n + 1),
                       120.95 + 0.18 * rng.random(n + 1)],
                      axis=1).astype(np.float32)
    return np.asarray(jgeo.distance_matrix_m(jnp.asarray(latlon), 1.3))


def _line_world():
    x = np.asarray([0.0, 10.0, 10.1, -10.0, -10.1], np.float32)
    return np.abs(x[:, None] - x[None, :])


def _pair_setup():
    pts = np.asarray([[0.0, 0.0], [0.0, 10.0], [105.0, 0.5], [105.0, -0.5],
                      [0.0, 20.0], [100.0, 10.0], [100.0, -10.0]], np.float64)
    dist = np.linalg.norm(pts[:, None] - pts[None, :],
                          axis=-1).astype(np.float32)
    return (dist, np.ones(6, np.float32), np.arange(6, dtype=np.int32),
            np.asarray([0, 0, 0, 0, 1, 1], np.int32))


def _triple_setup():
    pts = np.asarray([[0.0, 0.0], [0.0, 10.0], [105.0, 0.8], [105.0, 0.0],
                      [105.0, -0.8], [0.0, 20.0], [100.0, 10.0],
                      [100.0, -10.0]], np.float64)
    dist = np.linalg.norm(pts[:, None] - pts[None, :],
                          axis=-1).astype(np.float32)
    return (dist, np.ones(7, np.float32), np.arange(7, dtype=np.int32),
            np.asarray([0, 0, 0, 0, 0, 1, 1], np.int32))


def _both_solve(dist, demands, cap, maxd, refine):
    want = jvrp.solve_host(dist, demands, cap, maxd, refine=refine)
    got = tvrp.solve_host(dist, demands, cap, maxd, refine=refine,
                          device="cpu")
    assert got == want
    return got


# ── greedy: the tests/test_vrp.py fixtures ──────────────────────────────


@pytest.mark.parametrize("n,cap,maxd", [(5, 1e12, 1e12), (8, 15.0, 1e12),
                                        (8, 1e12, 260.0), (10, 18.0, 300.0)])
def test_greedy_matches_on_oracle_fixtures(n, cap, maxd):
    rng = np.random.default_rng(0)
    for _ in range(5):
        dist = _euclid(rng, n)
        demands = rng.uniform(0, 10, size=n).astype(np.float32)
        _both_solve(dist, demands, cap, maxd, refine=False)


@pytest.mark.parametrize("case", ["heavy", "far", "all_masked", "single"])
def test_greedy_unroutable_and_edge_fixtures(case):
    rng = np.random.default_rng(1)
    if case == "heavy":
        dist = _euclid(rng, 6)
        demands = rng.uniform(0, 10, 6).astype(np.float32)
        demands[2] = 1000.0
        got = _both_solve(dist, demands, 50.0, 1e12, refine=False)
        assert got["unroutable"] == [2]
    elif case == "far":
        dist = _euclid(rng, 4)
        dist[0, 3] = dist[3, 0] = 1e6
        got = _both_solve(dist, np.ones(4, np.float32), 1e12, 500.0, False)
        assert 2 in got["unroutable"]
    elif case == "all_masked":
        dist = np.full((4, 4), 10.0, np.float32)
        np.fill_diagonal(dist, 0.0)
        got = _both_solve(dist, np.full(3, 99.0, np.float32), 1.0, 1e12,
                          False)
        assert got["trips"] == [] and got["unroutable"] == [0, 1, 2]
    else:
        _both_solve(np.asarray([[0, 5], [5, 0]], np.float32),
                    np.ones(1, np.float32), 10.0, 1e12, True)


def test_greedy_solution_arrays_match():
    """The raw fixed-shape arrays (order, trip ids, counts, mask), with
    duplicate stops so the stable scan order is exercised."""
    rng = np.random.default_rng(2)
    for n in (3, 9):
        dist = _euclid(rng, n)
        dist[:, 2] = dist[:, 1]
        dist[2, :] = dist[1, :]
        demands = rng.integers(1, 4, n).astype(np.float32)
        want = jvrp.greedy_vrp(jnp.asarray(dist), jnp.asarray(demands),
                               jnp.float32(5.0), jnp.float32(400.0))
        got = tvrp.greedy_vrp(_t(dist), _t(demands), 5.0, 400.0)
        for name in ("order", "trip_ids", "n_trips", "n_routed",
                     "unroutable"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)).astype(np.int64),
                _np(getattr(want, name)), err_msg=name)


def test_greedy_batch_matches_vmap():
    rng = np.random.default_rng(3)
    dists = np.stack([_euclid(rng, 7) for _ in range(6)])
    demands = rng.uniform(0, 10, (6, 7)).astype(np.float32)
    caps = np.full(6, 20.0, np.float32)
    maxds = np.full(6, 400.0, np.float32)
    want = jvrp.greedy_vrp_batch(jnp.asarray(dists), jnp.asarray(demands),
                                 jnp.asarray(caps), jnp.asarray(maxds))
    got = tvrp.greedy_vrp_batch(_t(dists), _t(demands), _t(caps), _t(maxds))
    for name in ("order", "trip_ids", "n_trips", "n_routed", "unroutable"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy().astype(np.int64),
            _np(getattr(want, name)), err_msg=name)


# ── refiners: the tests/test_refine.py fixtures ─────────────────────────


def test_tour_views_bitwise():
    """Per-trip loads and closed-tour distances with fractional demands
    and distances: the float sums agree bit for bit."""
    rng = np.random.default_rng(4)
    for n in (5, 9, 9):
        dist = _euclid(rng, n, scale=10_000.0)
        dem = rng.uniform(0.3, 2.7, n).astype(np.float32)
        sol = jvrp.greedy_vrp(jnp.asarray(dist), jnp.asarray(dem),
                              jnp.float32(4.0), jnp.float32(60_000.0))
        want = jvrp._tour_views(jnp.asarray(dist), jnp.asarray(dem),
                                sol.order, sol.trip_ids)
        got = tvrp._tour_views(_t(dist)[None], _t(dem)[None],
                               _t(_np(sol.order))[None],
                               _t(_np(sol.trip_ids))[None])
        for name in want._fields:
            a = np.asarray(getattr(want, name))
            b = getattr(got, name)[0].numpy()
            assert a.astype(b.dtype).tobytes() == b.tobytes(), name


def _greedy_pair(dist, demands, cap, maxd):
    sol = jvrp.greedy_vrp(jnp.asarray(dist), jnp.asarray(demands),
                          jnp.float32(cap), jnp.float32(maxd))
    return sol, _t(_np(sol.order)), _t(_np(sol.trip_ids))


@pytest.mark.parametrize("refiner", ["2opt", "relocate", "swap", "oropt2",
                                     "oropt3"])
def test_each_refiner_matches_on_random_instances(refiner):
    rng = np.random.default_rng(5)
    for k, n in enumerate((6, 9, 6, 9)):
        dist = _manila(rng, n) if k % 2 else _euclid(rng, n, 10_000.0)
        demands = rng.integers(1, 4, n).astype(np.float32)
        cap, maxd = 6.0, float(np.median(dist[0, 1:]) * 6)
        sol, order, trips = _greedy_pair(dist, demands, cap, maxd)
        args = (jnp.asarray(dist), jnp.asarray(demands), jnp.float32(cap),
                jnp.float32(maxd), sol.order, sol.trip_ids)
        targs = (_t(dist), _t(demands), cap, maxd, order, trips)
        if refiner == "2opt":
            want = (jvrp.refine_2opt(args[0], sol.order, sol.trip_ids),)
            got = (tvrp.refine_2opt(targs[0], order, trips),)
        elif refiner == "swap":
            want = (jvrp.refine_swap(*args),)
            got = (tvrp.refine_swap(*targs),)
        elif refiner == "relocate":
            want = jvrp.refine_relocate(*args)
            got = tvrp.refine_relocate(*targs)
        else:
            seg = int(refiner[-1])
            want = jvrp.refine_oropt(*args, seg_len=seg)
            got = tvrp.refine_oropt(*targs, seg_len=seg)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("fixture", ["line_cap3", "line_cap2", "pair",
                                     "triple"])
def test_crafted_refine_fixtures_match(fixture):
    """The crafted instances where relocate, swap, Or-opt-2 and Or-opt-3
    each make the move the others cannot; every refiner and the full
    ``solve_host(refine=True)``."""
    if fixture.startswith("line"):
        dist = _line_world()
        demands = np.ones(4, np.float32)
        cap = 3.0 if fixture == "line_cap3" else 2.0
        sol, order, trips = _greedy_pair(dist, demands, cap, 1e12)
        jorder, jtrips = sol.order, sol.trip_ids
    else:
        dist, demands, order_np, trips_np = (_pair_setup() if fixture == "pair"
                                             else _triple_setup())
        cap = 4.0 if fixture == "pair" else 5.0
        jorder, jtrips = jnp.asarray(order_np), jnp.asarray(trips_np)
        order, trips = _t(order_np.astype(np.int64)), _t(trips_np.astype(
            np.int64))
    jargs = (jnp.asarray(dist), jnp.asarray(demands), jnp.float32(cap),
             jnp.float32(1e12), jorder, jtrips)
    targs = (_t(dist), _t(demands), cap, 1e12, order, trips)
    np.testing.assert_array_equal(
        tvrp.refine_2opt(targs[0], order, trips).numpy(),
        _np(jvrp.refine_2opt(jargs[0], jorder, jtrips)))
    np.testing.assert_array_equal(tvrp.refine_swap(*targs).numpy(),
                                  _np(jvrp.refine_swap(*jargs)))
    for jfn, tfn in ((jvrp.refine_relocate, tvrp.refine_relocate),
                     (jvrp.refine_oropt2, tvrp.refine_oropt2),
                     (jvrp.refine_oropt3, tvrp.refine_oropt3)):
        want, got = jfn(*jargs), tfn(*targs)
        np.testing.assert_array_equal(got.order.numpy(), _np(want.order))
        np.testing.assert_array_equal(got.trip_ids.numpy(),
                                      _np(want.trip_ids))
    got = _both_solve(dist, demands, cap, 1e12, refine=True)
    assert tvrp.trips_cost(dist, got["trips"]) < 450


@pytest.mark.parametrize("case", ["single", "empty"])
def test_refine_noop_fixtures_match(case):
    dist = np.asarray([[0.0, 5.0], [5.0, 0.0]], np.float32)
    o = np.asarray([0] if case == "single" else [-1], np.int32)
    args = (jnp.asarray(dist), jnp.asarray([1.0], jnp.float32),
            jnp.float32(10.0), jnp.float32(1e12), jnp.asarray(o),
            jnp.asarray(o))
    targs = (_t(dist), _t(np.ones(1, np.float32)), 10.0, 1e12,
             _t(o.astype(np.int64)), _t(o.astype(np.int64)))
    assert tvrp.refine_relocate(*targs).order.tolist() == \
        _np(jvrp.refine_relocate(*args).order).tolist()
    assert tvrp.refine_2opt(targs[0], targs[4], targs[5]).tolist() == \
        _np(jvrp.refine_2opt(args[0], args[4], args[5])).tolist()
    assert tvrp.refine_swap(*targs).tolist() == \
        _np(jvrp.refine_swap(*args)).tolist()


@pytest.mark.parametrize("kind", ["manila_cap", "manila_maxd", "euclid_frac"])
def test_solve_host_refine_matches(kind):
    rng = np.random.default_rng({"manila_cap": 6, "manila_maxd": 7,
                                 "euclid_frac": 8}[kind])
    for n in (6, 9, 9):
        if kind == "euclid_frac":
            dist = _euclid(rng, n, 10_000.0)
            demands = rng.uniform(0.5, 2.0, n).astype(np.float32)
            cap, maxd = 4.0, 60_000.0
        else:
            dist = _manila(rng, n)
            demands = rng.integers(1, 4, n).astype(np.float32)
            cap = 5.0 if kind == "manila_cap" else 1e12
            maxd = (1e12 if kind == "manila_cap"
                    else float(np.median(dist[0, 1:]) * 4))
        _both_solve(dist, demands, cap, maxd, refine=False)
        _both_solve(dist, demands, cap, maxd, refine=True)


# ── batches ─────────────────────────────────────────────────────────────


def _batch(rng, count, sizes):
    dists, dems, caps, maxds = [], [], [], []
    for _ in range(count):
        n = int(rng.choice(sizes))
        d = _euclid(rng, n, 10_000.0)
        dists.append(d)
        dems.append(rng.uniform(0.5, 2.0, n).astype(np.float32))
        caps.append(float(rng.choice([3.0, 5.0, 9e12])))
        maxds.append(float(rng.choice([40_000.0, 9e12])))
    return dists, dems, caps, maxds


def test_solve_host_batch_256_greedy_matches():
    """A seeded 256-problem batch of mixed sizes (pads to 16 stops)."""
    problems = _batch(np.random.default_rng(9), 256, (2, 5, 9, 10, 13))
    want = jvrp.solve_host_batch(*problems)
    got = tvrp.solve_host_batch(*problems, device="cpu")
    assert got == want


def test_solve_host_batch_32_refined_matches():
    """A seeded 32-problem batch through the fixed refine rounds: the
    per-problem masks freeze converged problems as vmap does."""
    problems = _batch(np.random.default_rng(10), 32, (4, 7, 10))
    want = jvrp.solve_host_batch(*problems, refine=True)
    got = tvrp.solve_host_batch(*problems, refine=True, device="cpu")
    assert got == want


def test_solve_host_batch_guards_and_empty():
    assert tvrp.solve_host_batch([], [], [], [], device="cpu") == []
    with pytest.raises(ValueError, match="finite"):
        tvrp.solve_host_batch([np.zeros((3, 3), np.float32)],
                              [np.ones(2, np.float32)], [np.inf], [1e9],
                              device="cpu")


def test_cost_oracles_equal():
    rng = np.random.default_rng(11)
    dist = _euclid(rng, 8)
    sol = jvrp.greedy_vrp(jnp.asarray(dist), jnp.ones(8, jnp.float32),
                          jnp.float32(3.0), jnp.float32(1e12))
    order, trips = np.asarray(sol.order), np.asarray(sol.trip_ids)
    assert tvrp.tour_cost(dist, order, trips) == jvrp.tour_cost(dist, order,
                                                                trips)
    host = jvrp.solve_host(dist, np.ones(8, np.float32), 3.0, 1e12)
    assert tvrp.trips_cost(dist, host["trips"]) == jvrp.trips_cost(
        dist, host["trips"])


def test_solve_on_a_missing_card_raises(monkeypatch):
    monkeypatch.delenv("ROUTEST_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvrp.solve_host(np.zeros((2, 2), np.float32), np.ones(1, np.float32),
                        1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvrp.solve_host_batch([np.zeros((2, 2), np.float32)],
                              [np.ones(1, np.float32)], [1.0], [1.0],
                              device="cuda")
