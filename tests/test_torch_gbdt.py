"""The port's tensorized GBDT (``routest_tpu_torch/models/gbdt.py``) and
its serving branch against the JAX package's, on the CPU.

The model files are generated in XGBoost's JSON schema by a copy of
``tests/test_xgboost_import.py``'s generator, and an independent
pure-Python walker of XGBoost's documented semantics (strict
``x < split_condition`` goes left, NaN follows ``default_left``,
prediction = base_score + Σ leaf values) is the oracle: leaf indices
bitwise, predictions within 1e-5 (float32 sums against float64).
Against the JAX ``GBDT`` the packed arrays are bitwise and predictions
within 1e-6 relative (each sums the trees in one reduction, in its
library's order); the apps' JSON answers agree at that tolerance.
"""

import datetime as dt
import gzip
import json
import random

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.models import gbdt as jgbdt
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.models import gbdt
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

N_FEATURES = 12
GRID = (0.0, 0.25, 0.5, 1.0, 2.0, 30.0)


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


def _random_tree(rng: random.Random, max_depth: int):
    """Random binary tree in xgboost JSON array form."""
    lc, rc, cond, split, default = [], [], [], [], []

    def grow(depth):
        nid = len(lc)
        lc.append(-1)
        rc.append(-1)
        cond.append(0.0)
        split.append(0)
        default.append(0)
        if depth >= max_depth or rng.random() < 0.3:
            cond[nid] = rng.uniform(-4, 4)  # leaf value
            return nid
        split[nid] = rng.randrange(N_FEATURES)
        # thresholds on a coarse grid so exact x == thr collisions occur
        cond[nid] = float(np.float32(rng.choice(GRID)))
        default[nid] = rng.randrange(2)
        left = grow(depth + 1)
        right = grow(depth + 1)
        lc[nid], rc[nid] = left, right
        return nid

    grow(0)
    return {"left_children": lc, "right_children": rc,
            "split_conditions": cond, "split_indices": split,
            "default_left": default}


def _model_json(n_trees=5, seed=0, base_score=1.5,
                objective="reg:squarederror", depth=5):
    rng = random.Random(seed)
    return {"learner": {
        "objective": {"name": objective},
        "learner_model_param": {"base_score": str(base_score)},
        "gradient_booster": {"model": {"trees": [
            _random_tree(rng, depth) for _ in range(n_trees)]}},
    }}


def _oracle(model_json, x: np.ndarray):
    """(predictions float64 (B,), leaf node ids (B, T)) by walking each
    tree per row with XGBoost's rules."""
    learner = model_json["learner"]
    trees = learner["gradient_booster"]["model"]["trees"]
    out = np.full(len(x), float(learner["learner_model_param"]["base_score"]))
    leaves = np.zeros((len(x), len(trees)), np.int32)
    for t, tree in enumerate(trees):
        for i, row in enumerate(x):
            nid = 0
            while tree["left_children"][nid] != -1:
                xv = np.float32(row[tree["split_indices"][nid]])
                thr = np.float32(tree["split_conditions"][nid])
                go_left = (bool(tree["default_left"][nid]) if np.isnan(xv)
                           else bool(xv < thr))
                nid = (tree["left_children"][nid] if go_left
                       else tree["right_children"][nid])
            leaves[i, t] = nid
            out[i] += tree["split_conditions"][nid]
    return out, leaves


def _batch(seed=0, n=256):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (n, N_FEATURES)).astype(np.float32)
    # exact threshold collisions (the < vs <= edge) and NaNs
    x[::5, rng.integers(0, N_FEATURES, len(x[::5]))] = \
        rng.choice(GRID, len(x[::5]))
    x[::7, 3] = np.nan
    return x


def _write(tmp_path, mj, name="xgb.json"):
    path = str(tmp_path / name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(mj, f)
    return path


@pytest.mark.parametrize("name,n_trees,seed,depth", [
    ("xgb.json", 8, 1, 5), ("xgb.json.gz", 3, 4, 5), ("deep.json", 20, 9, 8)])
def test_parity_with_oracle_and_jax(tmp_path, name, n_trees, seed, depth):
    mj = _model_json(n_trees=n_trees, seed=seed, depth=depth)
    path = _write(tmp_path, mj, name)
    model, params = gbdt.from_xgboost_json(path, device="cpu")
    assert model.strict and model.n_trees == n_trees
    assert params["feature"].dtype == torch.int32
    assert params["threshold"].dtype == torch.float32
    assert params["missing_left"].dtype == torch.bool
    x = _batch(seed=seed + 1)
    want, want_leaves = _oracle(mj, x)
    xt = torch.from_numpy(x)
    assert np.array_equal(model.leaf_cursors(params, xt).numpy(),
                          want_leaves)
    got = model.apply(params, xt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jmodel, jparams = jgbdt.from_xgboost_json(path)
    assert (jmodel.n_trees, jmodel.max_nodes, jmodel.max_depth,
            jmodel.strict) == (model.n_trees, model.max_nodes,
                               model.max_depth, model.strict)
    for key, value in jparams.items():
        assert np.array_equal(params[key].numpy(), np.asarray(value)), key
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, x)),
                               rtol=1e-6, atol=1e-6)


def test_zero_threshold_stays_strict(tmp_path):
    """``x < 0.0`` evaluated as declared, never as a nudged threshold."""
    tree = {"left_children": [1, -1, -1], "right_children": [2, -1, -1],
            "split_conditions": [0.0, 100.0, 200.0],
            "split_indices": [4, 0, 0], "default_left": [1, 0, 0]}
    mj = {"learner": {
        "objective": {"name": "reg:squarederror"},
        "learner_model_param": {"base_score": "0.0"},
        "gradient_booster": {"model": {"trees": [tree]}}}}
    model, params = gbdt.from_xgboost_json(_write(tmp_path, mj), "cpu")
    x = np.zeros((4, N_FEATURES), np.float32)
    x[1, 4], x[2, 4], x[3, 4] = -1.0, np.nan, -1e-45   # subnormal
    got = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [200.0, 100.0, 100.0, 100.0])


@pytest.mark.parametrize("case", ["classifier", "garbage", "empty"])
def test_refusals_match_jax(tmp_path, case):
    mj = {"classifier": _model_json(objective="binary:logistic"),
          "garbage": {"not": "a model"},
          "empty": _model_json(n_trees=0)}[case]
    path = _write(tmp_path, mj)
    with pytest.raises(ValueError) as got:
        gbdt.from_xgboost_json(path, device="cpu")
    with pytest.raises(ValueError) as want:
        jgbdt.from_xgboost_json(path)
    assert str(got.value) == str(want.value)


def test_tree_depth_chain():
    n = 3000
    lc = np.full(n, -1, np.int32)
    rc = np.full(n, -1, np.int32)
    lc[:-1] = np.arange(1, n)
    assert gbdt._tree_depth(lc, rc) == jgbdt._tree_depth(lc, rc) == n


def test_from_sklearn_non_strict():
    from sklearn.ensemble import HistGradientBoostingRegressor

    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (600, N_FEATURES)).astype(np.float32)
    x[::11, 2] = np.nan
    y = x[:, 0] * 2.0 + np.where(np.isnan(x[:, 2]), 5.0, x[:, 2]) \
        + rng.normal(0, 0.1, 600)
    skl = HistGradientBoostingRegressor(max_iter=15, max_depth=4,
                                        random_state=0).fit(x, y)
    model, params = gbdt.from_sklearn(skl, device="cpu")
    jmodel, jparams = jgbdt.from_sklearn(skl)
    assert not model.strict and model.max_depth == jmodel.max_depth
    got = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, x)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, skl.predict(x), rtol=1e-5, atol=1e-4)


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    path = _write(tmp_path, _model_json())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gbdt.load_xgboost_eta(path, device="cuda")


# ── served through EtaService and the app ─────────────────────────────────

@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    mj = _model_json(n_trees=6, seed=7, base_score=20.0)
    path = _write(tmp_path_factory.mktemp("gbdt"), mj, "xgb_eta_model.json")
    jsvc = JEtaService(JServeConfig(batch_buckets=(8, 64)), model_path=path)
    tsvc = EtaService(ServeConfig(batch_buckets=(8, 64)), model_path=path,
                      device="cpu")
    return (mj, tsvc, Client(jax_create_app(JConfig(), eta_service=jsvc)),
            Client(create_app(Config(), eta_service=tsvc)))


def test_service_serves_xgboost(apps):
    mj, tsvc, _, tclient = apps
    assert tsvc.available and tsvc.load_error is None
    assert tsvc.quantiles == ()
    assert tsvc.scoring_info() == {"family": "xgboost",
                                   "kernel": "gbdt_gather",
                                   "dtype": "float32", "device": "cpu"}
    health = tclient.get("/api/health").get_json()
    assert health["checks"]["model"]["status"] == "ok"
    assert health["checks"]["model"]["scoring"]["family"] == "xgboost"
    from routest_tpu_torch.serve.ml_service import golden_batch

    rows = golden_batch()
    want, _ = _oracle(mj, rows)
    np.testing.assert_allclose(tsvc.predict_batch(rows), want, rtol=1e-5)


@pytest.mark.parametrize("path,body", [
    ("/api/predict_eta", {"summary": {"distance": 12_000},
                          "weather": "Sunny", "traffic": "High",
                          "pickup_time": "2026-07-29T08:00:00",
                          "driver_age": 35}),
    ("/api/predict_eta", {"summary": {"distance": 3_500},
                          "weather": "Fog", "traffic": "Jam",
                          "pickup_time": "2026-07-30T23:10:00+08:00"}),
    ("/api/predict_eta_batch", {
        "distance_m": [100.0, 2_500.5, 40_000.0, 12_345.0, 0.0],
        "weather": ["Sunny", "Cloudy", "Stormy", "Windy", "Fog"],
        "traffic": ["Low", "Medium", "High", "Jam", "Gridlock"],
        "driver_age": [18, 30, 45, 60, 70],
        "pickup_time": "2026-10-12T07:45:00"}),
    ("/api/predict_eta_batch", {"items": [
        {"distance_m": 900.0, "weather": "Sunny", "traffic": "Low",
         "pickup_time": "2026-10-13T17:05:00", "driver_age": 22},
        {"distance_m": 15_000.0, "weather": "Stormy", "traffic": "Jam",
         "pickup_time": "2026-10-14T02:00:00", "driver_age": 51}]}),
])
def test_predict_json_equals_jax_app(apps, path, body):
    _, _, jclient, tclient = apps
    want = jclient.post(path, json=body)
    got = tclient.post(path, json=body)
    assert got.status_code == want.status_code == 200, got.get_data()
    got, want = got.get_json(), want.get_json()
    if path == "/api/predict_eta_batch":
        assert got == want
        return
    assert got.keys() == want.keys()
    # The port sums the trees in torch's order and JAX in XLA's, so the
    # unrounded single-row minutes agree within 1e-6 relative and the
    # completion time within that many seconds (+ 1 µs of isoformat
    # truncation); the batch path rounds to 4 decimals and is equal.
    for key, value in want.items():
        if key == "eta_completion_time_ml":
            gap = (dt.datetime.fromisoformat(got[key])
                   - dt.datetime.fromisoformat(value)).total_seconds()
            assert abs(gap) <= 60 * 1e-6 * want["eta_minutes_ml"] + 1e-6
        elif isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-6, abs=0), key
        else:
            assert got[key] == value, key


def test_unloadable_file_reports_first_loader_error(tmp_path):
    path = tmp_path / "neither.json"
    path.write_text("{\"not\": \"a model\"}")
    jsvc = JEtaService(JServeConfig(batch_buckets=(8,)),
                       model_path=str(path))
    tsvc = EtaService(ServeConfig(batch_buckets=(8,)), model_path=str(path),
                      device="cpu")
    assert not tsvc.available and not jsvc.available
    assert tsvc.load_error == jsvc.load_error
    assert "not a routest_tpu model artifact" in tsvc.load_error
    assert tsvc.scoring_info()["family"] is None
