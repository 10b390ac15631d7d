"""The port's sharded paths against the JAX package's on the same inputs:
mesh serving, ``fit``/``rmse`` with a runtime, the GNN's edge-sharded
loss and step, the route transformer's sequence-parallel forward and
step, and candidate-sharded ranking.

The mesh cases of ``tests/test_route_transformer.py``,
``test_gnn.py``, ``test_models_train.py``, ``test_ranking.py``,
``test_serve.py``, ``test_quantile.py``, ``test_scoring_artifact.py``
and ``test_batcher.py`` run with the JAX function on its 8-device mesh
and the port's on a mesh of CPU shards (``[torch.device("cpu")] * n``),
at the JAX test's tolerance; ranking orders, bucket sizes and kernel
choices are compared exactly. A mesh service answers a batch whose row
count is not a multiple of the data axis with exactly its rows, and a
replica entry point with ``ROUTEST_MESH=1`` on one device serves
single-device (``tests/test_torch_fleet_placement.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as JP
from werkzeug.test import Client

from routest_tpu.core.config import MeshConfig as JMeshConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.config import TrainConfig as JTrainConfig
from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.core.mesh import MeshRuntime as JMeshRuntime
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.data.synthetic import generate_dataset, train_eval_split
from routest_tpu.models import gnn as jgnn
from routest_tpu.models import route_transformer as jtf
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.optimize.ranking import rank_routes as jrank
from routest_tpu.serve.ml_service import DynamicBatcher as JBatcher
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu.train import loop as jloop
from routest_tpu.train.checkpoint import save_model as jsave_model
from routest_tpu_torch.core.config import (Config, MeshConfig, ServeConfig,
                                           TrainConfig)
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.core.mesh import Mesh, MeshRuntime
from routest_tpu_torch.data.features import batch_from_mapping
from routest_tpu_torch.models import gnn as tgnn
from routest_tpu_torch.models import route_transformer as ttf
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.optimize.ranking import rank_routes as trank
from routest_tpu_torch.parallel import tensor as ttp
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import DynamicBatcher, EtaService
from routest_tpu_torch.train import loop as tloop
from routest_tpu_torch.train.checkpoint import export_serving_fn
from routest_tpu_torch.utils.logging import get_logger

CPU = torch.device("cpu")
Q = (0.1, 0.5, 0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _runtime(data=-1, model=1, n=8):
    return MeshRuntime.create(MeshConfig(data=data, model=model),
                              devices=[CPU] * n)


def _seq_mesh(n):
    grid = np.empty(n, dtype=object)
    grid[:] = [CPU] * n
    return Mesh(grid, ("seq",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


class _SGD:
    """optax's ``sgd`` with the port optimizer's interface."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    @torch.no_grad()
    def step(self, grads):
        for p, g in zip(self.params, grads):
            p.sub_(self.lr * g)


# ── the route transformer (tests/test_route_transformer.py) ──────────

N_DEV = 8
SEQ = 8 * N_DEV
TF_CFG = dict(d_model=32, n_heads=8, n_layers=2, d_mlp=64)


@pytest.fixture(scope="module")
def seqs():
    graph = generate_road_graph(n_nodes=256, k=3, seed=2)
    return jtf.sample_route_sequences(graph, n_routes=32, seq_len=SEQ,
                                      seed=3)


@pytest.fixture(scope="module")
def tf_pair():
    model = jtf.RouteTransformer(**TF_CFG)
    return model, _np(model.init(jax.random.PRNGKey(0)))


def _jshard(arrs):
    mesh = JMesh(np.asarray(jax.devices()[:N_DEV]), ("seq",))
    return mesh, [jax.device_put(jnp.asarray(a),
                                 NamedSharding(mesh, JP(None, "seq")))
                  for a in arrs]


@pytest.mark.parametrize("flavor,n", [("ring", 8), ("ulysses", 8),
                                      ("ring", 2), ("ulysses", 4)])
def test_sp_forward_matches_full_attention(seqs, tf_pair, flavor, n):
    feats, freeflow, _, mask = seqs
    jm, params = tf_pair
    want = np.asarray(jm.apply(params, jnp.asarray(feats),
                               jnp.asarray(freeflow), jnp.arange(SEQ),
                               key_mask=jnp.asarray(mask)))
    mesh, sharded = _jshard((feats, freeflow, mask))
    jgot = np.asarray(jtf.make_sp_apply(jm, mesh, flavor=flavor)(
        params, *sharded))
    tm = ttf.RouteTransformer.from_numpy(params, **TF_CFG)
    with torch.no_grad():
        got = ttf.make_sp_apply(tm, _seq_mesh(n), flavor=flavor)(
            _t(feats), _t(freeflow), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, jgot, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("flavor", ["ring", "ulysses"])
def test_sp_train_step_matches_full_attention_oracle(seqs, tf_pair, flavor):
    """One SGD step under sequence-sharded attention = one SGD step under
    full attention = the JAX sequence-parallel step."""
    feats, freeflow, targets, mask = seqs
    jm, params = tf_pair
    opt = optax.sgd(1e-4)
    d_loss, d_grads = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(feats), jnp.asarray(freeflow), jnp.arange(SEQ),
        jnp.asarray(targets), jnp.asarray(mask)))(params)
    want = optax.apply_updates(
        params, opt.update(d_grads, opt.init(params), params)[0])
    mesh, sharded = _jshard((feats, freeflow, targets, mask))
    jnew, _, jloss = jtf.make_sp_train_step(jm, opt, mesh, flavor=flavor)(
        params, opt.init(params), *sharded)
    tm = ttf.RouteTransformer.from_numpy(params, **TF_CFG)
    step = ttf.make_sp_train_step(tm, _SGD(tm.parameters(), 1e-4),
                                  _seq_mesh(N_DEV), flavor=flavor)
    loss = step(_t(feats), _t(freeflow), _t(targets), _t(mask))
    np.testing.assert_allclose(float(loss), float(d_loss), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    got = jax.tree_util.tree_leaves(tm.to_numpy())
    for ref in (want, jnew):
        for g, w in zip(got, jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=5e-4,
                                       atol=1e-5)


def test_sp_training_beats_freeflow(seqs):
    """Short SP training (the port's AdamW, ring over 2 shards) learns
    the congestion structure: held-out masked RMSE below free-flow."""
    from routest_tpu_torch.core import prng

    feats, freeflow, targets, mask = seqs
    train, held = slice(0, 24), slice(24, 32)
    tm = ttf.RouteTransformer(**TF_CFG).init(prng.prng_key(1))
    step = ttf.make_sp_train_step(
        tm, tloop.AdamW(list(tm.parameters()), 3e-3, 0.0),
        _seq_mesh(2), flavor="ring")
    args = [_t(a[train]) for a in (feats, freeflow, targets, mask)]
    losses = [float(step(*args)) for _ in range(150)]
    assert losses[-1] < 0.5 * losses[0], losses[::50]
    pred = tm(_t(feats[held]), _t(freeflow[held]), torch.arange(SEQ),
              key_mask=_t(mask[held])).numpy()
    w = mask[held]

    def rmse(x):
        return float(np.sqrt((w * (x - targets[held]) ** 2).sum() / w.sum()))

    assert rmse(pred) < rmse(freeflow[held]), (rmse(pred),
                                               rmse(freeflow[held]))


# ── the GNN (tests/test_gnn.py) ──────────────────────────────────────


@pytest.fixture(scope="module")
def small_graph():
    return generate_road_graph(n_nodes=256, k=3, seed=0)


def test_sharded_gnn_loss_matches_dense(small_graph):
    g = small_graph
    jm = jgnn.RoadGNN(n_nodes=256, hidden=32, n_rounds=2, policy=JF32)
    params = _np(jm.init(jax.random.PRNGKey(1)))
    jrt = JMeshRuntime.create()
    dense = float(jm.loss(params, g["node_coords"], jgnn.graph_batch(g)))
    jshard = float(jax.jit(jm.make_sharded_loss(jrt.mesh))(
        params, g["node_coords"], jgnn.graph_batch(g, pad_to=jrt.n_data)))
    tm = tgnn.RoadGNN.from_numpy(params, n_nodes=256, hidden=32,
                                 n_rounds=2, policy=F32_POLICY)
    coords = _t(g["node_coords"])
    for n in (2, 8):
        rt = _runtime(n=n)
        batch = tgnn.graph_batch(g, pad_to=rt.n_data, device="cpu")
        with torch.no_grad():
            got = float(tm.make_sharded_loss(rt.mesh)(coords, batch))
            tdense = float(tm.loss(coords, tgnn.graph_batch(g,
                                                            device="cpu")))
        for ref in (dense, jshard, tdense):
            assert abs(got - ref) < 1e-2 * max(1.0, ref), (n, got, ref)


def test_sharded_gnn_training_reduces_loss(small_graph):
    from routest_tpu_torch.core import prng

    g = small_graph
    tm = tgnn.RoadGNN(n_nodes=256, hidden=32, n_rounds=2,
                      policy=F32_POLICY).init(prng.prng_key(2))
    rt = _runtime()
    step = tm.make_sharded_train_step(
        rt.mesh, tloop.AdamW(list(tm.parameters()), 3e-3, 0.0))
    batch = tgnn.graph_batch(g, pad_to=rt.n_data, device="cpu")
    coords = _t(g["node_coords"])
    losses = [float(step(coords, batch)) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, losses[::10]


# ── fit and rmse (tests/test_models_train.py, test_quantile.py) ──────


@pytest.fixture(scope="module")
def tiny_dataset():
    return train_eval_split(generate_dataset(4000, seed=0))


def test_sharded_training_matches_jax_fit(tiny_dataset):
    """A full fit on an 8-shard mesh runs, converges, and follows the
    JAX fit on its 8-device mesh (the fit class, rtol 1e-4); a 2-shard
    run is the same function."""
    train, ev = tiny_dataset
    cfg = dict(batch_size=1024, epochs=4, learning_rate=3e-3)
    want = jloop.fit(JEtaMLP(hidden=(32, 32), policy=JF32), train, ev,
                     JTrainConfig(**cfg), runtime=JMeshRuntime.create())
    for n in (8, 2):
        got = tloop.fit(EtaMLP(hidden=(32, 32), policy=F32_POLICY), train,
                        ev, TrainConfig(**cfg), runtime=_runtime(n=n))
        assert got.train_losses[-1] < got.train_losses[0]
        assert np.isfinite(got.eval_rmse)
        np.testing.assert_allclose(got.train_losses, want.train_losses,
                                   rtol=1e-4)
        np.testing.assert_allclose(got.eval_rmse, want.eval_rmse, rtol=1e-4)


def test_sharded_eval_matches_single_device(tiny_dataset):
    train, ev = tiny_dataset
    features = batch_from_mapping(train)
    jm = JEtaMLP(hidden=(32, 32), policy=JF32)
    params = _np(jm.init(jax.random.PRNGKey(3),
                         norm_mean=features.mean(0),
                         norm_std=features.std(0)))
    want = jloop.rmse(jm, params, ev, runtime=JMeshRuntime.create())
    tm = EtaMLP.from_numpy(params, hidden=(32, 32), policy=F32_POLICY)
    single = tloop.rmse(tm, ev)
    # 991 eval rows: the last chunk pads to the shard multiple
    for n in (8, 3):
        sharded = tloop.rmse(tm, ev, runtime=_runtime(n=n))
        assert abs(single - sharded) < 1e-3 * max(1.0, single)
        assert abs(want - sharded) < 1e-3 * max(1.0, want)


def test_quantile_training_under_mesh_runtime():
    train, ev = train_eval_split(generate_dataset(8_000, seed=3))
    cfg = dict(epochs=4, batch_size=2048)
    want = jloop.fit(JEtaMLP(hidden=(16,), policy=JF32, quantiles=Q),
                     train, ev, JTrainConfig(**cfg),
                     runtime=JMeshRuntime.create())
    model = EtaMLP(hidden=(16,), policy=F32_POLICY, quantiles=Q)
    got = tloop.fit(model, train, ev, TrainConfig(**cfg),
                    runtime=_runtime())
    assert np.isfinite(got.eval_rmse)
    assert got.train_losses[-1] < got.train_losses[0]
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-4)
    with torch.no_grad():
        preds = model.apply_quantiles(
            torch.from_numpy(batch_from_mapping(ev)[:128])).numpy()
    assert (np.diff(preds, axis=1) >= 0).all()


# ── ranking (tests/test_ranking.py) ──────────────────────────────────


def _random_dist(rng, n):
    pts = rng.uniform(0, 10, size=(n + 1, 2))
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(
        np.float32)


def test_sharded_ranking_matches_single():
    dist = _random_dist(np.random.default_rng(0), 6) * 1000.0
    jsingle = jrank(dist, k=5)
    jsharded = jrank(dist, k=5, runtime=JMeshRuntime.create())
    for n in (8, 4):
        got = trank(dist, k=5, runtime=_runtime(n=n))
        for ref in (jsingle, jsharded):
            np.testing.assert_array_equal(got.orders, ref.orders)
            np.testing.assert_allclose(got.distances_m, ref.distances_m,
                                       rtol=1e-5)


def test_sharded_ranking_pads_awkward_candidate_counts():
    dist = _random_dist(np.random.default_rng(1), 8) * 1000.0
    want = jrank(dist, k=10, max_candidates=30,
                 runtime=JMeshRuntime.create())
    got = trank(dist, k=10, max_candidates=30, runtime=_runtime())
    assert got.orders.shape == (10, 8)
    for order in got.orders:
        assert sorted(order.tolist()) == list(range(8))
    assert (got.distances_m < 1e30).all()
    np.testing.assert_array_equal(got.orders, want.orders)
    np.testing.assert_array_equal(got.distances_m, want.distances_m)


# ── serving (tests/test_serve.py, test_quantile.py, ──────────────────
#    test_scoring_artifact.py, test_batcher.py)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A point artifact (hidden 16/8), a quantile one (32/16), and one
    whose widths do not divide a 4-wide model axis (30/16), written by
    the JAX saver."""
    root = tmp_path_factory.mktemp("mesh_artifacts")
    out = {}
    for name, hidden, quantiles in (("point", (16, 8), ()),
                                    ("quantile", (32, 16), Q),
                                    ("odd", (30, 16), ())):
        model = JEtaMLP(hidden=hidden, policy=JF32, quantiles=quantiles)
        data = generate_dataset(512, seed=11)
        feats = np.asarray(batch_from_mapping(data), np.float32)
        params = model.init(jax.random.PRNGKey(11),
                            norm_mean=feats.mean(0), norm_std=feats.std(0))
        path = str(root / f"{name}.msgpack")
        jsave_model(path, model, params)
        out[name] = (path, model, _np(params), feats)
    return out


def _cfg(**kw):
    return ServeConfig(device="cpu", **kw)


KW = dict(weather="Stormy", traffic="Jam", distance_m=6983.0,
          pickup_time="2026-07-29T18:00:00", driver_age=44)


def test_tp_serving_parity(artifacts):
    path = artifacts["point"][0]
    tp = EtaService(_cfg(), model_path=path, runtime=_runtime(4, 2))
    assert tp.available, tp.load_error
    assert tp.kernel == "torch_tp"
    jtp = JEtaService(JServeConfig(), model_path=path,
                      runtime=JMeshRuntime.create(JMeshConfig(data=4,
                                                              model=2)))
    assert jtp.kernel == "xla_tp"
    plain = EtaService(_cfg(), model_path=path, device="cpu")
    m_tp, _ = tp.predict_eta_minutes(**KW)
    for ref in (plain.predict_eta_minutes(**KW)[0],
                jtp.predict_eta_minutes(**KW)[0]):
        assert abs(m_tp - ref) < 1e-3, (m_tp, ref)


def test_tp_serving_falls_back_on_indivisible_widths(artifacts,
                                                     monkeypatch):
    warned = []
    log = get_logger("routest_tpu_torch.serve")
    monkeypatch.setattr(log, "warning",
                        lambda event, **kw: warned.append(event))
    path = artifacts["odd"][0]
    eta = EtaService(_cfg(), model_path=path, runtime=_runtime(2, 4))
    jeta = JEtaService(JServeConfig(), model_path=path,
                       runtime=JMeshRuntime.create(JMeshConfig(data=2,
                                                               model=4)))
    assert eta.available and jeta.kernel == "xla"
    assert eta.kernel == "torch_mesh"     # the replicated path
    assert "tp_serving_unavailable" in warned
    m, _ = eta.predict_eta_minutes(weather="Sunny", traffic="Low",
                                   distance_m=5000.0,
                                   pickup_time="2026-07-29T08:00:00")
    jm_, _ = jeta.predict_eta_minutes(weather="Sunny", traffic="Low",
                                      distance_m=5000.0,
                                      pickup_time="2026-07-29T08:00:00")
    assert m is not None and abs(m - jm_) < 1e-3


def test_tp_serves_quantiles_and_training_refuses():
    jm = JEtaMLP(hidden=(16, 8), policy=JF32, quantiles=Q)
    params = _np(jm.init(jax.random.PRNGKey(0)))
    x = batch_from_mapping(generate_dataset(64, seed=5))
    want = np.asarray(jm.apply_quantiles(params, x))
    tm = EtaMLP.from_numpy(params, hidden=(16, 8), quantiles=Q,
                           policy=F32_POLICY)
    rt = _runtime(4, 2)
    with torch.no_grad():
        got = ttp.make_tp_apply(tm, rt.mesh)(
            ttp.shard_tp_params(params, tm, rt.mesh), _t(x)).numpy()
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.diff(got, axis=1) >= 0).all()
    with pytest.raises(ValueError, match="point-model"):
        ttp.make_tp_loss(tm, rt.mesh)


def test_tp_serving_of_quantile_artifact(artifacts):
    path = artifacts["quantile"][0]
    tp = EtaService(_cfg(), model_path=path, runtime=_runtime(4, 2))
    assert tp.kernel == "torch_tp" and tp.quantiles == Q
    plain = EtaService(_cfg(), model_path=path, device="cpu")
    jtp = JEtaService(JServeConfig(), model_path=path,
                      runtime=JMeshRuntime.create(JMeshConfig(data=4,
                                                              model=2)))
    kw = dict(weather="Stormy", traffic="Jam", distance_m=9000.0,
              pickup_time=None, driver_age=40)
    eta_tp, _, bands_tp = tp.predict_eta_quantiles(**kw)
    assert set(bands_tp) == {"p10", "p90"}
    for ref in (plain, jtp):
        eta, _, bands = ref.predict_eta_quantiles(**kw)
        assert abs(eta_tp - eta) < 1e-3
        for k in bands_tp:
            assert abs(bands_tp[k] - bands[k]) < 1e-3


def test_mesh_runtime_serves_the_msgpack_path_sharded(artifacts):
    path, jm, params, feats = artifacts["quantile"]
    cfg = _cfg(batch_buckets=(8, 64), max_wait_ms=1.0)
    svc = EtaService(cfg, model_path=path, runtime=_runtime())
    jsvc = JEtaService(JServeConfig(batch_buckets=(8, 64), max_wait_ms=1.0),
                       model_path=path, runtime=JMeshRuntime.create())
    assert svc.available and svc.kernel == "torch_mesh"
    assert svc._batcher._buckets == list(jsvc._batcher._buckets) == [8, 64]
    want = np.asarray(jm.apply_quantiles(params, feats[:16]))
    for n in (16, 13):   # 13 rows: not a multiple of the 8 shards
        out = svc.predict_batch(feats[:n])
        assert out.shape == (n, 3)
        np.testing.assert_allclose(np.asarray(out, np.float64), want[:n],
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(out, jsvc.predict_batch(feats[:n]),
                                   rtol=2e-5, atol=1e-4)
    info = svc.mesh_info()
    assert info["sharded"] is True and info["devices"] == 1
    assert info["axis_shapes"] == {"data": 8, "model": 1}


def test_fused_kernel_is_ignored_under_a_mesh(artifacts, monkeypatch):
    """``ROUTEST_FUSED=1`` asks for the single-device kernel: under a
    mesh it is named and ignored, as in the JAX package."""
    warned = []
    log = get_logger("routest_tpu_torch.serve")
    monkeypatch.setattr(log, "warning",
                        lambda event, **kw: warned.append(event))
    monkeypatch.setenv("ROUTEST_FUSED", "1")
    svc = EtaService(_cfg(), model_path=artifacts["point"][0],
                     runtime=_runtime(2, 1, 2))
    assert svc.available and svc.kernel == "torch_mesh"
    assert warned.count("fused_kernel_ignored") == 1


def test_torch_export_serves_under_a_mesh(artifacts, tmp_path):
    path, jm, params, feats = artifacts["quantile"]
    tm = EtaMLP.from_numpy(params, hidden=(32, 16), quantiles=Q,
                           policy=F32_POLICY)
    export = str(tmp_path / "eta_q.pt2")
    export_serving_fn(export, tm, "cpu")
    cfg = _cfg(batch_buckets=(8, 64), max_wait_ms=1.0)
    svc = EtaService(cfg, model_path=export, runtime=_runtime(4, 1))
    assert svc.available, svc.load_error
    assert svc.kernel == "torch_export_sharded"
    assert svc.scoring_info()["family"] == "eta_mlp"
    out = svc.predict_batch(feats[:16])
    want = np.asarray(jm.apply_quantiles(params, feats[:16]))
    np.testing.assert_allclose(np.asarray(out, np.float64), want,
                               rtol=2e-5, atol=1e-4)


def test_mesh_app_answers_as_the_single_device_app(artifacts):
    """The batch endpoint through a 2×1 mesh service: a batch of 13 rows
    (not a multiple of the data axis) answers 13 rows, equal to the
    single-device app's, and health's mesh block names the layout."""
    path = artifacts["quantile"][0]
    mesh_svc = EtaService(_cfg(), model_path=path, runtime=_runtime(2, 1, 2))
    one_svc = EtaService(_cfg(), model_path=path, device="cpu")
    body = {"distance_m": [1000.0 + 700 * i for i in range(13)],
            "weather": ["Sunny", "Stormy", "Fog"] * 4 + ["Cloudy"],
            "pickup_time": "2026-07-29T18:00:00+08:00"}
    answers = []
    for svc in (mesh_svc, one_svc):
        app = create_app(Config(), eta_service=svc)
        try:
            client = Client(app)
            r = client.post("/api/predict_eta_batch", json=body)
            assert r.status_code == 200
            answers.append(r.get_json())
            health = client.get("/api/health").get_json()
        finally:
            app.close()
        mesh = health["checks"]["engine"]["mesh"]
        assert mesh["sharded"] is (svc is mesh_svc)
    got, want = answers
    assert len(got["eta_minutes_ml"]) == 13
    np.testing.assert_allclose(got["eta_minutes_ml"], want["eta_minutes_ml"],
                               rtol=1e-5, atol=1e-4)
    assert got["eta_completion_time_ml"] == want["eta_completion_time_ml"]


def _echo_score(calls):
    def score(x):
        calls.append(x.shape)
        return x[:, 0] * 2.0
    return score


def test_alignment_rounds_buckets_to_shard_multiples():
    """With a 6-way data axis every padded batch divides by 6, and the
    bucket ladder is the JAX batcher's."""
    got_calls, want_calls = [], []
    b = DynamicBatcher(_echo_score(got_calls), buckets=(8, 64),
                       max_batch=64, max_wait_ms=1.0, align=6)
    jb = JBatcher(_echo_score(want_calls), buckets=(8, 64), max_batch=64,
                  max_wait_ms=1.0, align=6)
    assert b._buckets == list(jb._buckets) == [12, 66]
    for n in (1, 12, 13, 66, 67, 72, 73):
        assert b._bucket(n) == jb._bucket(n), n
    for rows in (3, 70):
        x = np.ones((rows, 12), np.float32)
        assert len(b.submit(x)) == len(jb.submit(x)) == rows
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    assert all(c[0] % 6 == 0 for c in got_calls)
