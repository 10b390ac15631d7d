"""The port's road-model training half against the JAX package's, on
the CPU: GNN and route-transformer losses and grads against
``jax.value_and_grad`` (f32 class: rtol 1e-5 on losses; grads within rtol
1e-4 plus 1e-4 of the largest grad entry), ``sample_route_sequences``
bitwise, the single-device trainers at ``--quick`` sizes, and one
``ContinuousTrainer.run_once`` against the JAX trainer on the same
probes (params within rtol 1e-4 / atol 1e-5 after 8 AdamW steps from
inits that differ by a few ulp; result keys equal; the port's router
swaps to the new artifact).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.live.state import CongestionState as JState
from routest_tpu.live.trainer import ContinuousTrainer as JTrainer
from routest_tpu.models import gnn as jgnn
from routest_tpu.models import route_transformer as jrt
from routest_tpu.optimize.road_router import RoadRouter as JRouter
from routest_tpu.train import checkpoint as jck
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.data.road_graph import (add_congestion_observations,
                                               generate_road_graph)
from routest_tpu_torch.live.state import CongestionState
from routest_tpu_torch.live.trainer import ContinuousTrainer
from routest_tpu_torch.models import gnn
from routest_tpu_torch.models import route_transformer as rt
from routest_tpu_torch.optimize.road_router import RoadRouter
from routest_tpu_torch.train.checkpoint import graph_fingerprint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: these tests run many small CPU ops,
    and beside the suite's other workers a full thread pool per worker
    oversubscribes the cores (its threads spin), which slowed this file
    twentyfold in the parallel run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_close(module, grads, want_tree):
    """Port grads against the JAX grad pytree: rtol 1e-4, and an atol of
    1e-4 times the largest grad entry of the whole tree (some leaves are
    zero up to rounding, e.g. the key bias, which softmax cancels). A
    copy of the module with every parameter replaced by its grad lays
    the grads out as the JAX pytree (``to_numpy``)."""
    import copy

    view = copy.deepcopy(module)
    with torch.no_grad():
        for p, g in zip(view.parameters(), grads):
            p.copy_(g)
    want = jax.tree_util.tree_leaves(_np(want_tree))
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(jax.tree_util.tree_leaves(view.to_numpy()), want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)


@pytest.fixture(scope="module")
def graph():
    return add_congestion_observations(generate_road_graph(64, seed=0),
                                       seed=0)


@pytest.mark.parametrize("subset", [False, True])
def test_gnn_loss_and_grads(graph, subset):
    jm = jgnn.RoadGNN(n_nodes=64, hidden=16, n_rounds=2, policy=JF32)
    params = jm.init(jax.random.PRNGKey(0))
    tm = gnn.RoadGNN.from_numpy(_np(params), 64, 16, 2, F32_POLICY)
    e = len(graph["senders"])
    # padded so padding carries no message, as the JAX graph_batch pads
    jb = jgnn.graph_batch(graph, pad_to=16)
    tb = gnn.graph_batch(graph, pad_to=16, device="cpu")
    assert tb.senders.shape[0] == jb.senders.shape[0] > e
    lw = None
    if subset:
        mask = np.zeros(tb.senders.shape[0], np.float32)
        mask[:e:3] = 1.0
        lw = mask
    coords = graph["node_coords"]
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, coords, jb,
        loss_weights=None if lw is None else jnp.asarray(lw))
    loss = tm.loss(torch.from_numpy(np.asarray(coords, np.float32)), tb,
                   loss_weights=None if lw is None else torch.from_numpy(lw))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    _grads_close(tm, grads, jgrads)


def test_gnn_serving_forward_unchanged(graph):
    """``forward`` (no weights) is ``predict`` with all-ones weights."""
    from routest_tpu_torch.core import prng

    tm = gnn.RoadGNN(64, 16, 2, F32_POLICY).init(prng.prng_key(3))
    tb = gnn.graph_batch(graph, device="cpu")
    coords = torch.from_numpy(np.asarray(graph["node_coords"], np.float32))
    args = (coords, tb.senders, tb.receivers, tb.edge_feats, tb.length_m,
            tb.speed_limit)
    with torch.no_grad():
        assert torch.equal(tm(*args), tm.predict(*args, weights=tb.weights))


@pytest.mark.parametrize("relative", [True, False])
def test_transformer_loss_and_grads(graph, relative):
    f, ff, y, m = rt.sample_route_sequences(graph, 12, 10, seed=4)
    jm = jrt.RouteTransformer(d_model=16, n_heads=2, n_layers=2, d_mlp=32)
    params = jm.init(jax.random.PRNGKey(5))
    tm = rt.RouteTransformer.from_numpy(_np(params), 16, 2, 2, 32)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, f, ff, jnp.arange(10), y, m, relative=relative)
    t = [torch.from_numpy(a) for a in (f, ff, y, m)]
    loss = tm.loss(t[0], t[1], torch.arange(10), t[2], t[3],
                   relative=relative)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    _grads_close(tm, grads, jgrads)
    sq, cnt = rt.RouteTransformer.squared_residual(
        t[1] * 1.1, t[2], t[1], t[3], relative)
    jsq, jcnt = jrt.RouteTransformer.squared_residual(
        ff * np.float32(1.1), y, ff, m, relative)
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-6)
    assert float(cnt) == float(jcnt)


@pytest.mark.parametrize("kw", [dict(n_routes=40, seq_len=12, seed=0),
                                dict(n_routes=25, seq_len=7, seed=3,
                                     noise_sigma=0.2)])
def test_sample_route_sequences_bitwise(graph, kw):
    got = rt.sample_route_sequences(graph, return_hours=True,
                                    return_true=True, **kw)
    want = jrt.sample_route_sequences(graph, return_hours=True,
                                      return_true=True, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("cli", ["gnn", "transformer"])
def test_trainers_run_on_cpu(tmp_path, cli):
    """``--quick`` runs of both trainers on the CPU write their report
    and an artifact the JAX loader reads with the trained graph's
    fingerprint; the exit code says whether the run beat naive physics
    (the GNN's 120 quick steps do)."""
    import importlib

    mod = importlib.import_module(f"routest_tpu_torch.train.{cli}")
    out, art = str(tmp_path / "r.json"), str(tmp_path / "m.msgpack")
    rc = mod.main(["--quick", "--device", "cpu", "--report-out", out,
                   "--save", art])
    with open(out) as f:
        rec = json.load(f)
    assert rc == (0 if rec["beats_naive"] else 1)
    if cli == "gnn":
        assert rec["beats_naive"], rec
    assert rec["device"]["device"] == "cpu" and rec["nodes"] == 512
    assert np.isfinite(rec[f"{cli}_rmse_s"])
    load = jck.load_gnn if cli == "gnn" else jck.load_transformer
    _model, _params, meta = load(art)
    fp = meta.get("graph", meta)
    graph = RoadRouter(graph=generate_road_graph(512, k=4, seed=0),
                       use_gnn=False, use_transformer=False,
                       device="cpu").graph_dict()
    assert fp == graph_fingerprint(graph["node_coords"], graph["senders"],
                                   graph["receivers"], graph["length_m"])


def _probe_states(router, jrouter, n_obs, seed=0):
    """The same seeded observations folded into a port and a JAX
    congestion state."""
    rng = np.random.default_rng(seed)
    e = len(router.senders)
    states = (CongestionState(router.freeflow_time_s),
              JState(jrouter.freeflow_time_s))
    for batch in range(4):
        edges = rng.integers(0, e, n_obs // 4)
        times = router.freeflow_time_s[edges] * rng.uniform(1.0, 2.5,
                                                            len(edges))
        for s in states:
            s.fold(edges, times, t=1000.0 + batch, hour=8 + batch)
    return states


def test_continuous_trainer_matches_jax(tmp_path, monkeypatch):
    fixed = time.struct_time((2026, 10, 17, 9, 0, 0, 5, 290, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)
    g = generate_road_graph(96, seed=2)
    tpath, jpath = str(tmp_path / "t.msgpack"), str(tmp_path / "j.msgpack")
    router = RoadRouter(graph=g, gnn_path=tpath, use_transformer=False,
                        device="cpu")
    jrouter = JRouter(graph=g, gnn_path=jpath, use_transformer=False)
    assert router.leg_cost_model == "freeflow"
    state, jstate = _probe_states(router, jrouter, 400)
    trainer = ContinuousTrainer(router, state, steps=8, min_obs=100,
                                hidden=16)
    jtrainer = JTrainer(jrouter, jstate, steps=8, min_obs=100, hidden=16)
    got, want = trainer.run_once(), jtrainer.run_once()
    assert got["trained"] and want["trained"], (got, want)
    assert set(got) == set(want)
    assert got["observations"] == want["observations"] == 400
    assert got["edges_labeled"] == want["edges_labeled"]
    assert got["path"] == tpath
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    _, tparams, tfp = jck.load_gnn(tpath)
    _, jparams, jfp = jck.load_gnn(jpath)
    assert tfp == jfp
    for a, b in zip(jax.tree_util.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # the router swaps to the artifact through its verified gate
    before = router.edge_time_s(8).copy()
    router._maybe_reload_models()
    assert router.leg_cost_model == "gnn"
    assert not np.array_equal(router.edge_time_s(8), before)
    legs = router.route_legs(router.coords[[0, 40, 80]])
    assert np.isfinite(legs.duration_matrix()).all()
    # a second cycle warm-starts from the carried params
    again = trainer.run_once()
    assert again["trained"] and trainer.cycles == 2


def test_continuous_trainer_skips_and_threads(tmp_path):
    g = generate_road_graph(64, seed=1)
    router = RoadRouter(graph=g, gnn_path=str(tmp_path / "x.msgpack"),
                        use_transformer=False, device="cpu")
    state = CongestionState(router.freeflow_time_s)
    trainer = ContinuousTrainer(router, state, min_obs=10)
    assert trainer.run_once() == {"trained": False,
                                  "reason": "window 0 < min_obs 10"}
    trainer.start(interval_s=3600.0)
    assert trainer._thread.name == "live-trainer"
    assert trainer._thread.is_alive()
    trainer.stop()
    assert not trainer._thread.is_alive()


def test_continuous_trainer_refuses_jax_artifact():
    """The live retrainer never saves over the GNN the JAX package ships,
    which is the default router's artifact."""
    import types

    from routest_tpu_torch.train.report import artifacts_path

    router = types.SimpleNamespace(
        _gnn_path=artifacts_path("road_gnn.msgpack"), device="cpu")
    with pytest.raises(ValueError, match="ROAD_GNN_PATH"):
        ContinuousTrainer(router, None)


def test_live_service_arms_trainer(monkeypatch, tmp_path):
    from routest_tpu_torch.core.config import load_live_config
    from routest_tpu_torch.live.service import LiveTrafficService
    from routest_tpu_torch.optimize import road_router
    from routest_tpu_torch.serve.bus import InMemoryBus

    router = RoadRouter(graph=generate_road_graph(64, seed=3),
                        gnn_path=str(tmp_path / "g.msgpack"),
                        use_transformer=False, device="cpu")
    monkeypatch.setattr(road_router, "default_router", lambda dev: router)
    cfg = load_live_config({"RTPU_LIVE": "1", "RTPU_LIVE_RETRAIN_S": "3600",
                            "RTPU_LIVE_RETRAIN_STEPS": "3",
                            "RTPU_LIVE_CUSTOMIZE_S": "3600"})
    svc = LiveTrafficService(InMemoryBus(), cfg, device="cpu")
    svc.start()
    svc._boot.join(timeout=60)
    try:
        assert svc.ready, svc.error
        assert svc.trainer is not None and svc.trainer.steps == 3
        snap = svc.snapshot()
        assert snap["retrain"] == {"cycles": 0, "last": {}}
    finally:
        svc.stop()
    assert not svc.trainer._thread.is_alive()
