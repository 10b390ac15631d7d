"""The port's artifact writers against the JAX package's, and the serve
bootstrap, on the CPU.

``save_model``, ``save_gnn`` and ``save_transformer`` must write the
JAX writers' bytes for the same params and header (flax's msgpack:
sorted keys, lists as arrays, ndarrays as ext type 1), and the JAX
loaders must read them back bitwise. The bootstrap boots the port's
``main()`` on a missing artifact path with ``generate_dataset`` cut to a
few thousand rows: it trains, writes an artifact the JAX ``load_model``
reads, and serves it.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu.core.dtypes import DEFAULT_POLICY as JBF16
from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.models.gnn import RoadGNN as JRoadGNN
from routest_tpu.models.route_transformer import \
    RouteTransformer as JRouteTransformer
from routest_tpu.train import checkpoint as jck
from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY
from routest_tpu_torch.data.road_graph import generate_road_graph
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.models.gnn import RoadGNN
from routest_tpu_torch.models.route_transformer import RouteTransformer
from routest_tpu_torch.train import checkpoint as tck


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


def _bitwise(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("quantiles,policies", [
    ((), (DEFAULT_POLICY, JBF16)), ((0.1, 0.5, 0.9), (DEFAULT_POLICY, JBF16)),
    ((), (F32_POLICY, JF32)), ((0.05, 0.5, 0.95), (F32_POLICY, JF32))])
def test_save_model_bytes_identical(tmp_path, quantiles, policies):
    jm = JEtaMLP(hidden=(32, 16), policy=policies[1], quantiles=quantiles)
    params = _np(jm.init(jax.random.PRNGKey(4),
                         np.linspace(0, 1, 12).astype(np.float32),
                         np.linspace(1, 2, 12).astype(np.float32)))
    tm = EtaMLP.from_numpy(params, hidden=(32, 16), quantiles=quantiles,
                           policy=policies[0])
    want, got = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jck.save_model(want, jm, params)
    tck.save_model(got, tm)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    jmodel, jparams = jck.load_model(got)
    assert jmodel == jm
    _bitwise(jparams, params)
    tmodel, tparams = tck.load_model(got)
    assert tmodel.quantiles == quantiles
    assert tmodel.policy.compute_dtype == policies[0].compute_dtype
    _bitwise(tparams, params)
    _bitwise(tm.to_numpy(), params)


@pytest.fixture(scope="module")
def graph():
    return generate_road_graph(64, seed=0)


@pytest.mark.parametrize("policies", [(DEFAULT_POLICY, JBF16),
                                      (F32_POLICY, JF32)])
def test_save_gnn_bytes_identical(tmp_path, graph, policies):
    jm = JRoadGNN(n_nodes=64, hidden=16, n_rounds=2, policy=policies[1])
    params = _np(jm.init(jax.random.PRNGKey(1)))
    tm = RoadGNN.from_numpy(params, n_nodes=64, hidden=16, n_rounds=2,
                            policy=policies[0])
    want, got = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jck.save_gnn(want, jm, params, graph)
    tck.save_gnn(got, tm, graph)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    jmodel, jparams, fp = jck.load_gnn(got)
    assert jmodel == jm and fp == tck.graph_fingerprint(
        graph["node_coords"], graph["senders"], graph["receivers"],
        graph["length_m"])
    _bitwise(jparams, params)
    _bitwise(tck.load_gnn(got)[1], params)


def test_save_transformer_bytes_identical(tmp_path, graph):
    jm = JRouteTransformer(d_model=16, n_heads=2, n_layers=2, d_mlp=32)
    params = _np(jm.init(jax.random.PRNGKey(2)))
    tm = RouteTransformer.from_numpy(params, d_model=16, n_heads=2,
                                     n_layers=2, d_mlp=32)
    want, got = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jck.save_transformer(want, jm, params, graph, seq_len=12)
    tck.save_transformer(got, tm, graph, seq_len=12)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    jmodel, jparams, meta = jck.load_transformer(got)
    assert jmodel == jm and meta["seq_len"] == 12
    _bitwise(jparams, params)
    _bitwise(tck.load_transformer(got)[1], params)


def test_port_init_round_trips(tmp_path, graph):
    """Port-initialized modules write artifacts both packages read back
    as the module's own params."""
    from routest_tpu_torch.core import prng

    cases = [
        (RoadGNN(64, 16, 2).init(prng.prng_key(0)),
         lambda p, m: tck.save_gnn(p, m, graph), jck.load_gnn),
        (RouteTransformer(16, 2, 1, 32).init(prng.prng_key(1)),
         lambda p, m: tck.save_transformer(p, m, graph, seq_len=8),
         jck.load_transformer),
        (EtaMLP(hidden=(8,)).init(prng.prng_key(2)),
         tck.save_model, jck.load_model),
    ]
    for i, (module, save, jload) in enumerate(cases):
        path = str(tmp_path / f"{i}.msgpack")
        save(path, module)
        _bitwise(jload(path)[1], module.to_numpy())


def test_write_artifact_is_atomic_per_thread(tmp_path):
    """Concurrent writers never share a temp file; no temp file stays
    behind; a failed write leaves the old artifact and no temp."""
    path = str(tmp_path / "a.msgpack")
    blobs = [bytes([i]) * 50_000 for i in range(8)]

    def write(blob):
        for _ in range(5):
            tck._write_artifact(path, tck.MAGIC, {"format": "x"}, blob)

    threads = [threading.Thread(target=write, args=(b,)) for b in blobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert os.listdir(tmp_path) == ["a.msgpack"]
    with open(path, "rb") as f:
        raw = f.read()
    assert raw.split(b"\n", 2)[2] in blobs

    class Boom:
        pass

    with pytest.raises(TypeError):
        tck._write_artifact(path, tck.MAGIC, {"format": "x"}, Boom())
    assert os.listdir(tmp_path) == ["a.msgpack"]
    with open(path, "rb") as f:
        assert f.read() == raw


def test_trainers_refuse_jax_artifacts():
    from routest_tpu_torch.train.report import artifacts_path, \
        refuse_jax_artifact

    for name in ("road_gnn.msgpack", "road_gnn_manila.msgpack",
                 "route_transformer.msgpack", "eta_mlp.msgpack"):
        with pytest.raises(SystemExit, match="refusing"):
            refuse_jax_artifact(artifacts_path(name))
    refuse_jax_artifact(artifacts_path("road_gnn_cuda_run.msgpack.d/x"))


def test_cli_requires_a_path(monkeypatch):
    from routest_tpu_torch.train import __main__ as cli

    monkeypatch.delenv("ETA_MODEL_PATH", raising=False)
    with pytest.raises(SystemExit, match="no artifact path"):
        cli.main(["--n", "100"])


def test_cli_trains_and_reports(monkeypatch, tmp_path):
    """``python -m routest_tpu_torch.train`` on the CPU: a quantile model
    at a few thousand rows, its report and its artifact."""
    from routest_tpu_torch.train import __main__ as cli
    from routest_tpu_torch.train import baseline

    monkeypatch.setattr(baseline, "train_cpu_baseline",
                        lambda train, ev: {"rmse_minutes": 100.0,
                                           "n_train": 1, "n_eval": 1})
    model, report = str(tmp_path / "q.msgpack"), str(tmp_path / "r.json")
    rc = cli.main(["--n", "3000", "--epochs", "2", "--device", "cpu",
                   "--quantiles", "0.1,0.5,0.9", "--save", model,
                   "--report", report])
    with open(report) as f:
        rec = json.load(f)
    assert rc == 0 and rec["passed"] and rec["rmse_margin"] == 1.10
    assert rec["device"] == {"device": "cpu", "name": None,
                             "power_limit": None}
    assert set(rec["coverage"]) == {"0.1", "0.5", "0.9"}
    assert rec["cpu_baseline_source"] == "trained"
    assert jck.load_model(model)[0].quantiles == (0.1, 0.5, 0.9)


def test_cli_starts_from_the_environment(monkeypatch, tmp_path):
    """The CLI's training settings are the environment's ``TrainConfig``;
    ``--epochs``, ``--seed`` and ``--quick`` override it."""
    from routest_tpu_torch.core.config import TrainConfig
    from routest_tpu_torch.train import __main__ as cli

    for name in ("RTPU_TRAIN_BATCH", "RTPU_LR", "RTPU_EPOCHS", "RTPU_SEED",
                 "RTPU_CKPT_DIR"):
        monkeypatch.delenv(name, raising=False)
    assert cli.train_config(cli.parse_args([])) == TrainConfig()
    ckpt_dir = str(tmp_path / "ckpt")
    for name, value in {"RTPU_TRAIN_BATCH": "512", "RTPU_LR": "0.01",
                        "RTPU_EPOCHS": "3", "RTPU_SEED": "4",
                        "RTPU_CKPT_DIR": ckpt_dir}.items():
        monkeypatch.setenv(name, value)
    env = TrainConfig(batch_size=512, learning_rate=0.01, epochs=3, seed=4,
                      checkpoint_dir=ckpt_dir)
    assert cli.train_config(cli.parse_args([])) == env
    assert cli.train_config(cli.parse_args(["--epochs", "5", "--seed", "1"])) \
        == dataclasses.replace(env, epochs=5, seed=1)
    assert cli.train_config(cli.parse_args(["--quick"])).epochs == 8
    # the run follows them: 5 epochs of 512-row batches, checkpointed at 5
    monkeypatch.setenv("RTPU_EPOCHS", "5")
    monkeypatch.setattr(cli, "baseline_rmse",
                        lambda train, ev, n: {"rmse_minutes": 100.0,
                                              "source": "trained"})
    report = str(tmp_path / "r.json")
    assert cli.main(["--n", "2000", "--device", "cpu", "--report", report,
                     "--save", str(tmp_path / "m.msgpack")]) == 0
    with open(report) as f:
        rec = json.load(f)
    assert rec["epochs"] == 5 and rec["steps"] == 5 * 4  # ceil(1800 / 512)
    assert tck.latest_checkpoint_step(ckpt_dir)[0] == 5


def test_cli_reads_committed_baseline_without_sklearn(monkeypatch):
    """Where sklearn is missing, step 2 reads the committed record, and
    only for a dataset of its size."""
    import builtins

    from routest_tpu_torch.train import __main__ as cli

    real_import = builtins.__import__

    def no_sklearn(name, *a, **kw):
        if name.split(".")[0] == "sklearn":
            raise ImportError("no sklearn")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    rec = cli.baseline_rmse(None, None, 500_000)
    assert rec["source"] == "committed"
    assert rec["rmse_minutes"] == pytest.approx(4.743096064550795)
    with pytest.raises(SystemExit, match="500000"):
        cli.baseline_rmse(None, None, 50_000)


def test_bootstrap_trains_writes_and_serves(monkeypatch, tmp_path):
    from routest_tpu_torch.data import synthetic
    from routest_tpu_torch.serve import __main__ as entry

    path = tmp_path / "boot" / "eta.msgpack"
    real = synthetic.generate_dataset
    monkeypatch.setattr(synthetic, "generate_dataset",
                        lambda n, seed=0, **kw: real(3000, seed=seed, **kw))
    for name, value in {"ETA_MODEL_PATH": str(path), "ROUTEST_DEVICE": "cpu",
                        "RTPU_BATCH_BUCKETS": "8,64", "RTPU_DISPATCH": "0",
                        "ROUTEST_WARM_BUCKETS": "0"}.items():
        monkeypatch.setenv(name, value)
    seen = {}

    def serve(app, host, port):
        client = Client(app)
        seen["single"] = client.post("/api/predict_eta", json={
            "summary": {"distance": 8_000}, "weather": "Sunny",
            "traffic": "High", "pickup_time": "2026-07-29T08:00:00"})
        seen["batch"] = client.post("/api/predict_eta_batch", json={
            "distance_m": [1_000.0, 9_000.0], "weather": ["Sunny", "Fog"],
            "traffic": ["Low", "Jam"], "driver_age": [30, 40],
            "pickup_time": "2026-07-29T08:00:00"})
        seen["health"] = client.get("/api/health").get_json()
        return 0

    events = []

    class _Log:
        def _add(self, event, **fields):
            events.append((event, fields))

        info = warning = error = debug = _add

    monkeypatch.setattr(entry, "run_with_graceful_shutdown", serve)
    monkeypatch.setattr(entry, "_log", _Log())
    entry.main()
    names = [e for e, _ in events]
    assert names.index("model_bootstrap_started") \
        < names.index("model_bootstrap_finished") < names.index("model_loaded")
    finished = dict(events)["model_bootstrap_finished"]
    assert np.isfinite(finished["eval_rmse_min"])
    jmodel, _ = jck.load_model(str(path))
    assert jmodel.hidden == (256, 256, 128) and not jmodel.quantiles
    assert dataclasses.asdict(jmodel.policy)["compute_dtype"] == \
        JBF16.compute_dtype
    assert seen["single"].status_code == 200
    assert np.isfinite(seen["single"].get_json()["eta_minutes_ml"])
    assert seen["batch"].status_code == 200
    assert seen["batch"].get_json()["count"] == 2
    assert seen["health"]["checks"]["model"]["scoring"]["family"] == "eta_mlp"
    # a second boot serves the artifact as it is: no retraining
    before = path.stat().st_mtime_ns
    events.clear()
    entry.main()
    assert "model_bootstrap_started" not in [e for e, _ in events]
    assert path.stat().st_mtime_ns == before
