"""The port's learned leg pricers against the JAX package's:
``models/gnn.py`` (``RoadGNN``, edge features), ``models/
route_transformer.py`` (``RouteTransformer`` with its private
``full_attention``) and their artifact loaders in ``train/
checkpoint.py``, the port on the CPU.

Edge features and loaded params are bitwise equal.
Forwards are held to the f32 class of ``tests/test_ops_fused.py``
(rtol 1e-4, atol 1e-3) — ``index_add_`` and the einsums sum in another
order than XLA — and the artifact GNN computed in bf16 on both sides to
the bf16 class (rtol 2e-2, atol 0.5)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.models import gnn as jgnn
from routest_tpu.models import route_transformer as jtf
from routest_tpu.optimize.road_router import RoadRouter as JRouter
from routest_tpu.parallel.ring import full_attention as j_full_attention
from routest_tpu.train import checkpoint as jck
from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from routest_tpu_torch.models import gnn as tgnn
from routest_tpu_torch.models import route_transformer as ttf
from routest_tpu_torch.optimize.road_router import RoadRouter as TRouter
from routest_tpu_torch.train import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = (1e-4, 1e-3)
BF16 = (2e-2, 0.5)
J_F32 = dataclasses.replace(J_BF16, compute_dtype=jnp.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_gnn(model, params, graph, hour):
    e = len(graph["senders"])
    batch = jgnn.GraphBatch(
        senders=jnp.asarray(graph["senders"]),
        receivers=jnp.asarray(graph["receivers"]),
        edge_feats=jnp.asarray(jgnn.edge_feature_array(
            graph["length_m"], graph["speed_limit"], graph["road_class"],
            hour)),
        length_m=jnp.asarray(graph["length_m"]),
        speed_limit=jnp.asarray(graph["speed_limit"]),
        targets=jnp.zeros((e,), jnp.float32),
        weights=jnp.ones((e,), jnp.float32))
    return np.asarray(model.apply(params, jnp.asarray(graph["node_coords"]),
                                  batch), np.float32)


def _port_gnn(model, graph, hour):
    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype))

    return model(t(graph["node_coords"], np.float32),
                 t(graph["senders"], np.int64),
                 t(graph["receivers"], np.int64),
                 torch.from_numpy(tgnn.edge_feature_array(
                     graph["length_m"], graph["speed_limit"],
                     graph["road_class"], hour)),
                 t(graph["length_m"], np.float32),
                 t(graph["speed_limit"], np.float32)).numpy()


@pytest.mark.parametrize("hour", [0, 8, 17.5, np.arange(5) * 5])
def test_edge_features_bitwise(hour):
    rng = np.random.default_rng(0)
    length = rng.uniform(1, 900, 5).astype(np.float32)
    speed = rng.uniform(5, 12, 5).astype(np.float32)
    cls = rng.integers(0, 3, 5).astype(np.int32)
    assert (tgnn.edge_feature_array(length, speed, cls, hour).tobytes()
            == jgnn.edge_feature_array(length, speed, cls, hour).tobytes())
    assert tgnn.N_EDGE_FEATURES == jgnn.N_EDGE_FEATURES


@pytest.mark.parametrize("hidden,n_rounds,seed", [(16, 1, 0), (24, 2, 1),
                                                  (8, 3, 2)])
def test_road_gnn_tiny_init_matches(hidden, n_rounds, seed):
    graph = generate_road_graph(n_nodes=256, seed=1)
    jm = jgnn.RoadGNN(n_nodes=256, hidden=hidden, n_rounds=n_rounds,
                      policy=J_F32)
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    tm = tgnn.RoadGNN.from_numpy(params, n_nodes=256, hidden=hidden,
                                 n_rounds=n_rounds, policy=F32_POLICY)
    for hour in (3, 8):
        _close(_port_gnn(tm, graph, hour), _jax_gnn(jm, params, graph, hour),
               F32)


@pytest.fixture(scope="module")
def serving_graph():
    return JRouter(use_gnn=False, use_transformer=False).graph_dict()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_road_gnn_artifact_matches(serving_graph, compute):
    path = os.path.join(REPO, "artifacts", "road_gnn.msgpack")
    jm, jparams, jfp = jck.load_gnn(path)
    tm, tparams, tfp = tck.load_gnn(path)
    assert tfp == jfp
    jm = dataclasses.replace(jm, policy=dataclasses.replace(
        jm.policy, compute_dtype=getattr(jnp, compute)))
    tm.policy = dataclasses.replace(tm.policy,
                                    compute_dtype=getattr(torch, compute))
    want = _jax_gnn(jm, jparams, serving_graph, 8)
    got = _port_gnn(tm, serving_graph, 8)
    _close(got, want, F32 if compute == "float32" else BF16)


def test_loaded_params_bitwise():
    for name, jload, tload in (
            ("road_gnn.msgpack", jck.load_gnn, tck.load_gnn),
            ("road_gnn_manila.msgpack", jck.load_gnn, tck.load_gnn),
            ("route_transformer.msgpack", jck.load_transformer,
             tck.load_transformer)):
        path = os.path.join(REPO, "artifacts", name)
        jm, jp, jmeta = jload(path)
        tm, tp, tmeta = tload(path)
        assert tmeta == jmeta
        jl = jax.tree_util.tree_leaves(jp)
        tl = jax.tree_util.tree_leaves(tp)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert a.shape == b.shape and a.astype(np.float32).tobytes() \
                == np.asarray(b, np.float32).tobytes()
    assert tck.load_gnn(os.path.join(REPO, "artifacts", "road_gnn.msgpack")
                        )[0].policy == DEFAULT_POLICY


@pytest.mark.parametrize("loader,case", [
    ("gnn", "magic"), ("gnn", "format"), ("gnn", "version"),
    ("gnn", "features"), ("transformer", "magic"),
    ("transformer", "format"), ("transformer", "version")])
def test_artifact_errors_match(tmp_path, loader, case):
    src = os.path.join(REPO, "artifacts", "road_gnn.msgpack" if loader ==
                       "gnn" else "route_transformer.msgpack")
    raw = open(src, "rb").read()
    magic, rest = raw[:6], raw[6:]
    header, blob = rest.split(b"\n", 1)
    if case == "magic":
        raw = b"NOPE1\n" + rest
    elif case == "format":
        raw = magic + header.replace(b'"routest_tpu.', b'"other.') + \
            b"\n" + blob
    elif case == "version":
        raw = magic + header.replace(b'"version": 1', b'"version": 9') + \
            b"\n" + blob
    else:
        # a hidden width the message MLP's input does not fit: the
        # feature-count gate fires
        raw = magic + header.replace(b'"hidden": 96', b'"hidden": 95') + \
            b"\n" + blob
    path = tmp_path / "bad.msgpack"
    path.write_bytes(raw)
    jfn = jck.load_gnn if loader == "gnn" else jck.load_transformer
    tfn = tck.load_gnn if loader == "gnn" else tck.load_transformer
    with pytest.raises(ValueError) as want:
        jfn(str(path))
    with pytest.raises(ValueError) as got:
        tfn(str(path))
    assert str(got.value) == str(want.value)


def test_default_artifact_paths(monkeypatch):
    for var in ("ROAD_GNN_PATH", "ROUTE_TRANSFORMER_PATH"):
        monkeypatch.delenv(var, raising=False)
    assert tck.default_gnn_path() == jck.default_gnn_path()
    assert tck.default_transformer_path() == jck.default_transformer_path()
    monkeypatch.setenv("ROAD_GNN_PATH", "/x/g.msgpack")
    monkeypatch.setenv("ROUTE_TRANSFORMER_PATH", "/x/t.msgpack")
    assert tck.default_gnn_path() == "/x/g.msgpack"
    assert tck.default_transformer_path() == "/x/t.msgpack"
    rng = np.random.default_rng(0)
    args = (rng.uniform(14, 15, (9, 2)).astype(np.float32),
            rng.integers(0, 9, 20), rng.integers(0, 9, 20),
            rng.uniform(1, 99, 20).astype(np.float32))
    assert tck.graph_fingerprint(*args) == jck.graph_fingerprint(*args)


def _masks(b, s, rng):
    mask = np.zeros((b, s), np.float32)
    for i, k in enumerate(rng.integers(1, s + 1, b)):
        mask[i, :k] = 1.0
    mask[-1] = 0.0        # a fully masked row
    return mask


@pytest.mark.parametrize("b,s,h,d", [(3, 7, 2, 4), (4, 24, 4, 16)])
def test_full_attention_matches(b, s, h, d):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = _masks(b, s, rng)
    want = np.asarray(j_full_attention(*map(jnp.asarray, (q, k, v)),
                                       key_mask=jnp.asarray(mask)))
    got = ttf.full_attention(*map(torch.from_numpy, (q, k, v)),
                             key_mask=torch.from_numpy(mask)).numpy()
    _close(got, want, F32)
    assert not got[-1].any()          # a fully masked row attends to nothing


@pytest.mark.parametrize("d_model", [8, 32, 64])
def test_positional_encoding_matches(d_model):
    pos = np.arange(40)
    _close(ttf.positional_encoding(torch.from_numpy(pos), d_model).numpy(),
           np.asarray(jtf.positional_encoding(jnp.asarray(pos), d_model)),
           F32)


def _transformer_inputs(b, s, rng):
    feats = rng.standard_normal((b, s, jgnn.N_EDGE_FEATURES)).astype(
        np.float32)
    freeflow = rng.uniform(2, 120, (b, s)).astype(np.float32)
    return feats, freeflow, np.arange(s), _masks(b, s, rng)


@pytest.mark.parametrize("cfg", [dict(d_model=16, n_heads=2, n_layers=1,
                                      d_mlp=32),
                                 dict(d_model=32, n_heads=8, n_layers=2,
                                      d_mlp=64)])
def test_route_transformer_tiny_init_matches(cfg):
    jm = jtf.RouteTransformer(**cfg)
    params = _np(jm.init(jax.random.PRNGKey(1)))
    tm = ttf.RouteTransformer.from_numpy(params, **cfg)
    rng = np.random.default_rng(2)
    feats, freeflow, pos, mask = _transformer_inputs(5, 11, rng)
    want = np.asarray(jm.apply(params, jnp.asarray(feats),
                               jnp.asarray(freeflow), jnp.asarray(pos),
                               key_mask=jnp.asarray(mask)))
    got = tm(torch.from_numpy(feats), torch.from_numpy(freeflow),
             torch.from_numpy(pos), key_mask=torch.from_numpy(mask)).numpy()
    _close(got, want, F32)


def test_route_transformer_artifact_matches():
    path = os.path.join(REPO, "artifacts", "route_transformer.msgpack")
    jm, jp, meta = jck.load_transformer(path)
    tm, _, _ = tck.load_transformer(path)
    rng = np.random.default_rng(3)
    feats, freeflow, pos, mask = _transformer_inputs(6, meta["seq_len"], rng)
    want = np.asarray(jm.apply(jp, jnp.asarray(feats), jnp.asarray(freeflow),
                               jnp.asarray(pos), key_mask=jnp.asarray(mask)))
    got = tm(torch.from_numpy(feats), torch.from_numpy(freeflow),
             torch.from_numpy(pos), key_mask=torch.from_numpy(mask)).numpy()
    _close(got, want, F32)


def test_router_pricers_match():
    """The default router's GNN table per hour and the transformer's
    trip re-pricing, port against JAX (both on the CPU, f32)."""
    jr, tr = JRouter(), TRouter(device="cpu")
    assert (tr.leg_cost_model, tr.has_transformer) == (
        jr.leg_cost_model, jr.has_transformer) == ("gnn", True)
    for hour in (3, 8, 18):
        _close(tr.edge_time_s(hour), jr.edge_time_s(hour), F32)
    assert tr.edge_time_s(8) is tr.edge_time_s(8)
    pts = np.asarray([[14.58, 121.04], [14.53, 120.98], [14.55, 121.02],
                      [14.65, 121.03], [14.60, 120.97]], np.float32)
    jl, tl = jr.route_legs(pts, 1.2, hour=17), tr.route_legs(pts, 1.2,
                                                              hour=17)
    trips = [[0, 1, 2, 3]]
    want, got = jl.reprice_trips(trips), tl.reprice_trips(trips)
    assert sorted(got) == sorted(want)
    _close([got[k] for k in sorted(want)], [want[k] for k in sorted(want)],
           F32)
    orders = [[3, 2, 1, 0], [1, 0, 3, 2]]
    _close(tl.reprice_orders(orders), jl.reprice_orders(orders), F32)
