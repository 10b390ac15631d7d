"""The port's dispatch core (``routest_tpu_torch/optimize/vrp.py``'s
dispatch solver, ``routest_tpu_torch/dispatch/``) against the JAX
package's on the same problems, the port on the CPU.

Plans — trips, ``optimized_order``, ``spill_lane``, ``spilled``,
``unroutable``, ``n_trips`` — and ``penalty`` are bitwise equal on the
bodies of ``tests/test_dispatch.py``'s solver tests and on seeded
problems with integer-valued matrices (ties), windows, over-capacity and
unreachable stops, non-zero diagonals and mixed sizes padded into one
batch. The batcher, registry and re-optimization loop hold the JAX
package's behaviour (merge, epoch groups, the oversized entry, snapshot,
exactly-the-degraded re-solve, chunked drains, matrix-mode skips, the
``plan_update`` events); the config reads the same knobs."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from routest_tpu import dispatch as jdispatch
from routest_tpu.core.config import DispatchConfig as JDispatchConfig
from routest_tpu.core.config import load_dispatch_config as jload
from routest_tpu.optimize import vrp as jvrp
from routest_tpu_torch import dispatch as tdispatch
from routest_tpu_torch.core.config import (Config, DispatchConfig,
                                           load_config, load_dispatch_config)
from routest_tpu_torch.optimize import vrp as tvrp

CPU = "cpu"


def _matrix(n, seed=0, scale=60.0):
    """``tests/test_dispatch.py::_matrix``: (n+1, n+1) random symmetric
    cost matrix, zero diagonal."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n + 1, 2)) * scale
    m = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    return np.round(m, 3).astype(np.float32)


def _both(*args, **kw):
    """The same problem through the JAX package and the port (CPU): the
    plans must be equal, ``penalty`` bit for bit. → the port's plan."""
    want = jvrp.solve_host_dispatch(*args, **kw)
    got = tvrp.solve_host_dispatch(*args, **kw, device=CPU)
    assert got == want
    assert np.float32(got["penalty"]).tobytes() == \
        np.float32(want["penalty"]).tobytes()
    return got


def _both_batch(*args, **kw):
    want = jvrp.solve_host_dispatch_batch(*args, **kw)
    got = tvrp.solve_host_dispatch_batch(*args, **kw, device=CPU)
    assert got == want
    return got


# ── solver: the bodies of tests/test_dispatch.py ─────────────────────


def test_window_free_feasible_matches_solve_host():
    for seed in range(5):
        m = _matrix(7, seed=seed)
        rng = np.random.default_rng(seed)
        dem = rng.integers(1, 3, 7).astype(np.float32)
        plan = _both(m, dem, 6.0, 1e6)
        ref = tvrp.solve_host(m, dem, 6.0, 1e6, device=CPU)
        assert plan["trips"] == ref["trips"], seed
        assert plan["spill_lane"] == [] and plan["penalty"] == 0.0
        assert plan["spilled"] == [] and plan["unroutable"] == []


def test_generous_windows_are_a_noop():
    m = _matrix(6, seed=3)
    dem = np.ones(6, np.float32)
    free = _both(m, dem, 4.0, 1e6)
    wide = _both(m, dem, 4.0, 1e6, tw_open=np.zeros(6, np.float32),
                 tw_close=np.full(6, tvrp.NO_WINDOW, np.float32))
    assert wide["trips"] == free["trips"]
    assert wide["penalty"] == 0.0 and wide["spill_lane"] == []


def test_tight_window_spills_with_lateness_penalty():
    m = _matrix(5, seed=1)
    dem = np.ones(5, np.float32)
    tw_open = np.zeros(5, np.float32)
    tw_close = np.full(5, tvrp.NO_WINDOW, np.float32)
    tw_close[2] = 0.5
    plan = _both(m, dem, 10.0, 1e6, tw_open=tw_open, tw_close=tw_close)
    assert plan["spill_lane"] == [2] and 2 in plan["spilled"]
    assert plan["penalty"] > 0.0 and 2 not in plan["optimized_order"]
    assert sorted(plan["optimized_order"] + plan["spill_lane"]) \
        == list(range(5))


def test_overweight_stop_spills_to_next_trip_lane():
    m = _matrix(4, seed=2)
    dem = np.asarray([1.0, 9.0, 1.0, 1.0], np.float32)
    plan = _both(m, dem, 5.0, 1e6)
    assert plan["spill_lane"] == [1] and plan["spilled"] == [1]
    assert plan["penalty"] == 0.0 and plan["unroutable"] == []
    assert sorted(plan["optimized_order"]) == [0, 2, 3]


def test_batch_solve_matches_singles():
    sizes = [3, 5, 8, 4]
    dists, dems, caps, maxds, opens, closes = [], [], [], [], [], []
    for i, n in enumerate(sizes):
        dists.append(_matrix(n, seed=10 + i))
        rng = np.random.default_rng(100 + i)
        dems.append(rng.integers(1, 3, n).astype(np.float32))
        caps.append(5.0)
        maxds.append(500.0)
        if i == 1:
            c = np.full(n, tvrp.NO_WINDOW, np.float32)
            c[0] = 0.5
            opens.append(np.zeros(n, np.float32))
            closes.append(c)
        else:
            opens.append(None)
            closes.append(None)
    batch = _both_batch(dists, dems, caps, maxds, tw_opens=opens,
                        tw_closes=closes)
    for i in range(len(sizes)):
        assert batch[i] == _both(dists[i], dems[i], caps[i], maxds[i],
                                 opens[i], closes[i]), i
        lanes = (batch[i]["optimized_order"] + batch[i]["spill_lane"]
                 + batch[i]["unroutable"])
        assert all(0 <= s < sizes[i] for s in lanes), i


def test_nonfinite_constraints_rejected():
    m = _matrix(3)
    dem = np.ones(3, np.float32)
    for args in ((m, dem, float("inf"), 100.0), (m, dem, 5.0, float("nan"))):
        with pytest.raises(ValueError) as want:
            jvrp.solve_host_dispatch(*args)
        with pytest.raises(ValueError) as got:
            tvrp.solve_host_dispatch(*args, device=CPU)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jvrp.solve_host_dispatch_batch([m], [dem], [6.0], [float("nan")])
    with pytest.raises(ValueError) as got:
        tvrp.solve_host_dispatch_batch([m], [dem], [6.0], [float("nan")],
                                       device=CPU)
    assert str(got.value) == str(want.value)
    assert tvrp.solve_host_dispatch_batch([], [], [], [], device=CPU) == []


def test_dispatch_on_a_missing_card_raises(monkeypatch):
    monkeypatch.delenv("ROUTEST_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m, dem = _matrix(3), np.ones(3, np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvrp.solve_host_dispatch(m, dem, 5.0, 1e6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvrp.solve_host_dispatch_batch([m], [dem], [5.0], [1e6],
                                       device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdispatch.DispatchBatcher().solve(
            [tdispatch.DispatchProblem(m, dem, 5.0, 1e6)])


def test_solution_tensors_match_the_jax_solution():
    """The device-level solution (before unpacking) on one problem with
    windows, a spill and an unreachable stop: the same counts, masks,
    order, trip ids and penalty."""
    m = np.round(_matrix(6, seed=5) / 7.0).astype(np.float32)
    m[0, 4] = m[4, 0] = 500.0               # unreachable under 200
    dem = np.asarray([1, 2, 9, 1, 1, 2], np.float32)
    tw_open = np.asarray([0, 3, 0, 0, 5, 0], np.float32)
    tw_close = np.asarray([1e30, 9, 1e30, 2, 1e30, 1e30], np.float32)
    want = jvrp.greedy_vrp_dispatch(m, dem, np.float32(4.0),
                                    np.float32(200.0), tw_open, tw_close)
    got = tvrp.greedy_vrp_tw(torch.from_numpy(m), torch.from_numpy(dem),
                             4.0, 200.0, torch.from_numpy(tw_open),
                             torch.from_numpy(tw_close))
    for field in tvrp.DispatchSolution._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.astype(w.dtype).tobytes() == w.tobytes(), field
    spill_w = jvrp.greedy_vrp_spill(m, dem, np.float32(4.0),
                                    np.float32(200.0))
    spill_g = tvrp.greedy_vrp_spill(torch.from_numpy(m),
                                    torch.from_numpy(dem), 4.0, 200.0)
    for field in tvrp.DispatchSolution._fields:
        w = np.asarray(getattr(spill_w, field))
        assert getattr(spill_g, field).numpy().astype(w.dtype).tobytes() \
            == w.tobytes(), field


# ── solver: a seeded sweep ───────────────────────────────────────────


def _problem(seed):
    """One seeded problem of 1-12 stops: integer-valued costs (ties) on
    even seeds, a non-zero diagonal on every third, over-capacity stops,
    a budget that leaves some stops (or, on seed % 8 == 5, every stop)
    unreachable, and windows on one problem in four."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 13))
    m = _matrix(n, seed=seed)
    if seed % 2 == 0:
        m = np.round(m / 8.0).astype(np.float32)
    if seed % 3 == 0:
        m[np.diag_indices(n + 1)] = rng.integers(1, 6, n + 1)
    dem = rng.integers(1, 4, n).astype(np.float32)
    dem[rng.random(n) < 0.15] = 40.0
    maxd = float(rng.choice([40.0, 90.0, 1e6]))
    if seed % 8 == 5:
        maxd = 0.5
    opens = closes = None
    if seed % 4 == 0:
        opens = rng.integers(0, 20, n).astype(np.float32)
        closes = (opens + rng.integers(2, 120, n)).astype(np.float32)
        closes[rng.random(n) < 0.3] = tvrp.NO_WINDOW
    return m, dem, 6.0, maxd, opens, closes


@pytest.mark.parametrize("seed", range(32))
def test_seeded_problem_bitwise(seed):
    m, dem, cap, maxd, opens, closes = _problem(seed)
    plan = _both(m, dem, cap, maxd, opens, closes)
    n = len(dem)
    # every stop is in exactly one of: the real trips, the lane, the
    # unroutable list
    assert sorted(plan["optimized_order"] + plan["spill_lane"]
                  + plan["unroutable"]) == list(range(n))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_mixed_batch_bitwise(seed):
    """Mixed sizes padded into one batch (stops to a power of two, the
    batch to a power of two): each plan equals the JAX batch's and the
    port's single solve."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 8))
    probs = [_problem(100 + 8 * seed + i) for i in range(k)]
    dists, dems, caps, maxds, opens, closes = (list(x) for x in zip(*probs))
    batch = _both_batch(dists, dems, caps, maxds, tw_opens=opens,
                        tw_closes=closes)
    for i, p in enumerate(probs):
        assert batch[i] == tvrp.solve_host_dispatch(*p, device=CPU), i


# ── batcher ──────────────────────────────────────────────────────────


def test_batcher_merges_concurrent_requests():
    batcher = tdispatch.DispatchBatcher(max_rows=16, window_s=0.15,
                                        device=CPU)
    problems = []
    for i in range(4):
        n = 4 + i
        rng = np.random.default_rng(i)
        problems.append(tdispatch.DispatchProblem(
            _matrix(n, seed=i), rng.integers(1, 3, n).astype(np.float32),
            5.0, 1e6))
    results = [None] * 4
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait()
        results[i] = batcher.solve([problems[i]])[0]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, p in enumerate(problems):
        assert results[i] == jvrp.solve_host_dispatch(
            p.dist, p.demands, p.capacity, p.max_cost), i
    st = batcher.stats()
    assert set(st) == set(jdispatch.DispatchBatcher().stats())
    assert st["requests"] == 4 and st["rows"] == 4
    assert st["dispatches"] < 4
    assert st["merged_requests"] >= 2 and st["max_occupancy"] >= 2


def test_batcher_epoch_groups_never_share_a_drain():
    local = threading.local()
    batcher = tdispatch.DispatchBatcher(max_rows=16, window_s=0.2,
                                        epoch_fn=lambda: local.e,
                                        device=CPU)
    m = _matrix(3)
    dem = np.ones(3, np.float32)
    barrier = threading.Barrier(3)
    out = []

    def worker(e):
        local.e = e
        barrier.wait()
        out.append(batcher.solve(
            [tdispatch.DispatchProblem(m, dem, 5.0, 1e6)])[0])

    threads = [threading.Thread(target=worker, args=(e,))
               for e in (0, 0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == 3
    assert all(p == jvrp.solve_host_dispatch(m, dem, 5.0, 1e6) for p in out)
    st = batcher.stats()
    assert st["requests"] == 3 and st["dispatches"] >= 2


def test_batcher_oversized_entry_dispatches_alone():
    batcher = tdispatch.DispatchBatcher(max_rows=2, device=CPU)
    m = _matrix(3)
    dem = np.ones(3, np.float32)
    probs = [tdispatch.DispatchProblem(m, dem, 5.0, 1e6) for _ in range(5)]
    out = {}
    t = threading.Thread(target=lambda: out.update(r=batcher.solve(probs)),
                         daemon=True)
    t.start()
    t.join(30.0)
    assert "r" in out, "oversized entry wedged the batcher"
    expect = jvrp.solve_host_dispatch(m, dem, 5.0, 1e6)
    assert len(out["r"]) == 5 and all(r == expect for r in out["r"])
    st = batcher.stats()
    assert st["dispatches"] == 1 and st["rows"] == 5
    assert st["max_occupancy"] == 5 and st["oversized_batches"] == 1


def test_batcher_error_reaches_every_merged_caller():
    """A drain that fails (here: a non-finite capacity inside the merged
    batch) fails every caller that rode it, and the batcher keeps
    serving."""
    batcher = tdispatch.DispatchBatcher(max_rows=16, window_s=0.15,
                                        device=CPU)
    m = _matrix(3)
    dem = np.ones(3, np.float32)
    errors = []
    barrier = threading.Barrier(3)

    def worker(cap):
        barrier.wait()
        try:
            batcher.solve([tdispatch.DispatchProblem(m, dem, cap, 1e6)])
        except ValueError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=worker, args=(cap,))
               for cap in (5.0, float("inf"), 5.0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = batcher.stats()
    # the 0.15 s leader window merges all three into one failed drain
    assert st["dispatches"] == 1 and st["merged_requests"] == 3
    assert len(errors) == 3
    assert all("must be finite" in e for e in errors)
    assert batcher.solve([tdispatch.DispatchProblem(m, dem, 5.0, 1e6)])[0] \
        == jvrp.solve_host_dispatch(m, dem, 5.0, 1e6)


# ── registry ─────────────────────────────────────────────────────────


def _mask(snap):
    for d in snap["dispatches"]:
        d.pop("created_unix")
    return snap


def test_registry_snapshot_and_eviction_match():
    m = _matrix(3, seed=6)
    plan = jvrp.solve_host_dispatch(m, np.ones(3, np.float32), 5.0, 1e6)
    regs = (jdispatch.DispatchRegistry(max_active=3),
            tdispatch.DispatchRegistry(max_active=3))
    ids = []
    for reg in regs:
        got = []
        for i in range(5):
            rec = reg.register(
                channel=None if i == 2 else f"veh-{i}",
                latlon=None if i == 3 else np.full((4, 2), 0.1 * i,
                                                   np.float32),
                demands=np.ones(3, np.float32), capacity=5.0, max_cost=1e6,
                plan=plan, baseline_cost=jdispatch.plan_cost(m, plan),
                epoch=i, sim_seed=i if i % 2 else None)
            got.append((rec.id, rec.channel))
        assert reg.complete(got[3][0]) and not reg.complete("d99")
        ids.append(got)
    assert ids[1] == ids[0]
    assert ids[0][2] == ("d3", "d3")          # anonymous: streams on id
    assert _mask(regs[1].snapshot()) == _mask(regs[0].snapshot())
    assert regs[1].snapshot()["evicted"] == 2
    assert [r.id for r in regs[1].active()] == ["d3", "d5"]
    assert regs[1].get("d5").snapshot()["stops"] == 3


# ── re-optimization ──────────────────────────────────────────────────


def _mk_reopt(pkg, jam_ids, batcher=None, degrade_ratio=1.2):
    """``tests/test_dispatch.py::_mk_reopt`` for either package: two
    active dispatches over one 3-stop corridor shape; ``matrix_fn``
    prices a dispatch whose key is in ``jam_ids`` at 3×."""
    base = _matrix(3, seed=6)
    registry = pkg.DispatchRegistry()
    epoch = {"v": 0}
    published = []

    def matrix_fn(latlon):
        rec_key = int(round(float(latlon[0][0]) * 10))
        return base * 3.0 if rec_key in jam_ids else base

    recs = {}
    for key, name in ((1, "veh-a"), (2, "veh-b")):
        plan = jvrp.solve_host_dispatch(base, np.ones(3, np.float32),
                                        5.0, 1e6)
        recs[key] = registry.register(
            channel=name, latlon=np.full((4, 2), key / 10.0, np.float32),
            demands=np.ones(3, np.float32), capacity=5.0, max_cost=1e6,
            plan=plan, baseline_cost=pkg.plan_cost(base, plan), epoch=0,
            sim_seed=42)
    restarted = []
    if batcher is None:
        batcher = (pkg.DispatchBatcher(device=CPU) if pkg is tdispatch
                   else pkg.DispatchBatcher())
    loop = pkg.ReoptLoop(
        registry, batcher, lambda ch, ev: published.append((ch, ev)),
        lambda: epoch["v"], matrix_fn, degrade_ratio=degrade_ratio,
        poll_s=0.0, sim_restart=lambda rec: restarted.append(rec.id))
    return loop, recs, epoch, published, restarted


def test_reopt_resolves_exactly_the_degraded_like_jax():
    runs = []
    for pkg in (jdispatch, tdispatch):
        loop, recs, epoch, published, restarted = _mk_reopt(pkg, {1})
        ticks = [loop.tick(), loop.tick()]
        epoch["v"] = 1
        ticks += [loop.tick(), loop.tick()]
        runs.append((ticks, published, restarted,
                     [(r.updates, r.epoch, r.plan, r.baseline_cost)
                      for r in recs.values()]))
        snap = loop.snapshot()
        assert snap["ticks"] == 1 and snap["resolves"] == 1
    assert runs[1] == runs[0]
    ticks, published, restarted, _ = runs[1]
    assert [t["result"] for t in ticks] == ["armed", "idle", "resolved",
                                            "idle"]
    assert ticks[2]["degraded"] == ticks[2]["resolved"] == ["d1"]
    assert len(published) == 1 and published[0][0] == "veh-a"
    ev = published[0][1]
    assert ev["event"] == "plan_update" and ev["epoch"] == 1
    assert ev["reason"]["previous_cost"] >= ev["reason"]["new_cost"]
    assert restarted == ["d1"]


def test_reopt_mass_degradation_chunks_to_batcher_drains():
    base = _matrix(3, seed=6)
    registry = tdispatch.DispatchRegistry()
    epoch = {"v": 0}
    published = []
    jam = {"on": False}
    plan = jvrp.solve_host_dispatch(base, np.ones(3, np.float32), 5.0, 1e6)
    recs = [registry.register(
        channel=f"veh-{i}", latlon=np.full((4, 2), 0.1, np.float32),
        demands=np.ones(3, np.float32), capacity=5.0, max_cost=1e6,
        plan=plan, baseline_cost=tdispatch.plan_cost(base, plan), epoch=0)
        for i in range(5)]
    batcher = tdispatch.DispatchBatcher(max_rows=2, device=CPU)
    loop = tdispatch.ReoptLoop(
        registry, batcher, lambda ch, ev: published.append((ch, ev)),
        lambda: epoch["v"],
        lambda latlon: base * 3.0 if jam["on"] else base, poll_s=0.0)
    loop.tick()
    jam["on"] = True
    epoch["v"] = 1
    out = loop.tick()
    assert out["result"] == "resolved"
    assert sorted(out["resolved"]) == sorted(r.id for r in recs)
    assert len(published) == 5
    st = batcher.stats()
    assert st["dispatches"] == 3 and st["max_occupancy"] <= 2
    want = jvrp.solve_host_dispatch(base * 3.0, np.ones(3, np.float32),
                                    5.0, 1e6)
    assert all(ev["plan"] == want for _, ev in published)


def test_reopt_skips_matrix_mode_dispatches_like_jax():
    outs = []
    for pkg in (jdispatch, tdispatch):
        loop, recs, epoch, published, _ = _mk_reopt(pkg, set())
        m = _matrix(3, seed=9)
        plan = jvrp.solve_host_dispatch(m, np.ones(3, np.float32), 5.0, 1e6)
        loop.registry.register(
            channel="mx", latlon=None, demands=np.ones(3, np.float32),
            capacity=5.0, max_cost=1e6, plan=plan,
            baseline_cost=pkg.plan_cost(m, plan), epoch=0)
        loop.tick()
        epoch["v"] = 1
        outs.append((loop.tick(), published,
                     [r.epoch for r in loop.registry.active()]))
    assert outs[1] == outs[0]
    out = outs[1][0]
    assert out["result"] == "clean" and out["skipped"] == 1
    assert out["checked"] == 3 and outs[1][1] == []
    assert outs[1][2] == [1, 1, 0]        # the matrix-mode record keeps 0


def test_reopt_thread_ticks_on_its_own():
    loop, recs, epoch, published, _ = _mk_reopt(tdispatch, {2})
    loop.poll_s = 0.01
    loop.start()
    try:
        deadline = threading.Event()
        for _ in range(500):
            if loop.snapshot()["last_epoch"] == 0:
                break
            deadline.wait(0.01)
        epoch["v"] = 3
        for _ in range(500):
            if published:
                break
            deadline.wait(0.01)
    finally:
        loop.stop()
    assert loop.snapshot()["running"] is False
    assert [ch for ch, _ in published] == ["veh-b"]
    assert published[0][1]["epoch"] == 3


def test_plan_cost_matches_jax():
    m = _matrix(6, seed=4)
    plan = jvrp.solve_host_dispatch(m, np.asarray([1, 2, 9, 1, 2, 1],
                                                  np.float32), 5.0, 400.0)
    assert plan["spill_lane"]
    assert tdispatch.plan_cost(m, plan) == jdispatch.plan_cost(m, plan)


# ── config ───────────────────────────────────────────────────────────

ENVS = [
    {},
    {"RTPU_DISPATCH": "0"},
    {"RTPU_DISPATCH_MAX_ROWS": "16", "RTPU_DISPATCH_WINDOW_S": "0.05",
     "RTPU_DISPATCH_MAX_STOPS": "12", "RTPU_DISPATCH_REOPT": "0",
     "RTPU_DISPATCH_REOPT_POLL_S": "0", "RTPU_DISPATCH_DEGRADE_RATIO": "1.5",
     "RTPU_DISPATCH_MAX_ACTIVE": "8", "RTPU_DISPATCH_SPEED_MPS": "9.5"},
    {"RTPU_DISPATCH_MAX_ROWS": "x", "RTPU_DISPATCH_DEGRADE_RATIO": "fast"},
]


@pytest.mark.parametrize("env", ENVS)
def test_config_round_trip_matches_jax(env):
    assert dataclasses.asdict(load_dispatch_config(env)) == \
        dataclasses.asdict(jload(env))
    assert load_config(env).dispatch == load_dispatch_config(env)
    assert dataclasses.asdict(DispatchConfig()) == \
        dataclasses.asdict(JDispatchConfig())
    assert Config().dispatch == DispatchConfig()
