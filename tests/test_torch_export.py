"""The ``torch.export`` scoring artifact (``train/checkpoint.py::
export_serving_fn``), the counterpart of the JAX package's StableHLO
export, on the five cases of ``tests/test_export.py``.

One file serves every batch bucket (and batch 1); the exported program
is held to the port's plain forward within ``rtol=1e-6`` and to the JAX
``model.apply`` / ``apply_quantiles`` on the same weights within the
f32 class of ``tests/test_ops_fused.py``; predictions come from the
saved program, not from the model code; the serving layer runs the file
(kernel ``torch_export``) and answers as the direct forward; the
refusals name wrong magic, format, version, torch version, a quantile
export without the 0.5 median, and a JAX ``RTPUX1`` file. Every file is
written and read in this process (``torch.export`` bytes are not
portable across torch versions)."""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from routest_tpu.core.dtypes import F32_POLICY as JF32
from routest_tpu.data.features import batch_from_mapping
from routest_tpu.data.synthetic import generate_dataset
from routest_tpu.models.eta_mlp import EtaMLP as JEtaMLP
from routest_tpu.train.checkpoint import export_serving_fn as jexport
from routest_tpu_torch.core.config import ServeConfig
from routest_tpu_torch.core.dtypes import F32_POLICY
from routest_tpu_torch.models.eta_mlp import EtaMLP
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.train import checkpoint as ckpt
from routest_tpu_torch.train.checkpoint import (export_serving_fn,
                                                load_exported_serving_fn,
                                                save_model)

# f32 class of tests/test_ops_fused.py (kernel-free f32 forward vs XLA)
F32_RTOL, F32_ATOL = 1e-4, 1e-3
BUCKETS = (8, 64, 512, 1024, 2048, 4096)


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (transient threads of other modules' apps end within seconds)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(hidden, quantiles=(), seed=0):
    """The same weights as a JAX model and a port module."""
    jmodel = JEtaMLP(hidden=hidden, policy=JF32, quantiles=quantiles)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    tmodel = EtaMLP.from_numpy(params, hidden=hidden, quantiles=quantiles,
                               policy=F32_POLICY)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def point():
    return _pair((16, 8))


@pytest.fixture(scope="module")
def data():
    return batch_from_mapping(generate_dataset(4096, seed=1))


def test_roundtrip_parity_across_every_bucket(point, data, tmp_path):
    jmodel, params, tmodel = point
    path = str(tmp_path / "m.pt2")
    export_serving_fn(path, tmodel, "cpu")
    exported = load_exported_serving_fn(path, "cpu")
    assert exported.n_features == 12 and exported.quantiles == ()
    assert exported.hidden == (16, 8)
    # rows are independent: the JAX forward once over the largest batch
    want = np.asarray(jmodel.apply(params, data))
    for n in (1, 7) + BUCKETS:       # one export, every batch size
        x = torch.from_numpy(data[:n])
        with torch.no_grad():
            got = exported(x).numpy()
            plain = tmodel(x).numpy()
        assert got.shape == (n,)
        np.testing.assert_allclose(got, plain, rtol=1e-6)
        np.testing.assert_allclose(got, want[:n], rtol=F32_RTOL,
                                   atol=F32_ATOL)


def test_quantile_export(data, tmp_path):
    jmodel, params, tmodel = _pair((16,), quantiles=(0.1, 0.5, 0.9),
                                   seed=1)
    path = str(tmp_path / "q.pt2")
    export_serving_fn(path, tmodel, "cpu")
    exported = load_exported_serving_fn(path, "cpu")
    assert exported.quantiles == (0.1, 0.5, 0.9)
    x = torch.from_numpy(data[:32])
    with torch.no_grad():
        out = exported(x).numpy()
        plain = tmodel.apply_quantiles(x).numpy()
    assert out.shape == (32, 3)
    np.testing.assert_allclose(out, plain, rtol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(jmodel.apply_quantiles(params, data[:32])),
        rtol=F32_RTOL, atol=F32_ATOL)


def test_export_pins_numerics_against_model_code_drift(point, data,
                                                       tmp_path):
    _, _, tmodel = point
    path = str(tmp_path / "pinned.pt2")
    export_serving_fn(path, tmodel, "cpu")
    x = torch.from_numpy(data[:16])
    with torch.no_grad():
        want = load_exported_serving_fn(path, "cpu")(x).numpy()
    real_forward = EtaMLP.forward
    try:
        EtaMLP.forward = lambda self, xx: 0 * xx[..., 0]   # "code drift"
        with torch.no_grad():
            got = load_exported_serving_fn(path, "cpu")(x).numpy()
    finally:
        EtaMLP.forward = real_forward
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_serving_layer_runs_export(point, tmp_path, monkeypatch):
    from werkzeug.test import Client

    from routest_tpu_torch.core.config import Config
    from routest_tpu_torch.serve.app import create_app

    monkeypatch.setenv("ROUTEST_WARM_BUCKETS", "0")
    _, _, tmodel = point
    path = str(tmp_path / "serve.pt2")
    export_serving_fn(path, tmodel, "cpu")
    svc = EtaService(ServeConfig(batch_buckets=(8, 64), device="cpu"),
                     model_path=path, device="cpu")
    assert svc.available and svc.kernel == "torch_export"
    assert svc.scoring_info() == {"family": "eta_mlp",
                                  "kernel": "torch_export",
                                  "dtype": "float32", "device": "cpu"}
    app = create_app(Config(serve=ServeConfig(device="cpu")),
                     eta_service=svc)
    try:
        client = Client(app)
        r = client.post("/api/predict_eta",
                        json={"summary": {"distance": 8000}})
        assert r.status_code == 200
        eta = r.get_json()["eta_minutes_ml"]
        direct, _ = svc.predict_eta_minutes(
            weather="Sunny", traffic="Low", distance_m=8000,
            pickup_time=None)
        assert abs(eta - direct) < 1e-6
        rb = client.post("/api/predict_eta_batch",
                         json={"distance_m": [8000.0, 1000.0]})
        assert rb.status_code == 200 and rb.get_json()["count"] == 2
        health = client.get("/api/health").get_json()
        assert health["checks"]["model"]["scoring"]["kernel"] == \
            "torch_export"
        metrics = client.get("/api/metrics").get_json()
        assert metrics["batcher"]["kernel"] == "torch_export"
    finally:
        app.close()


def test_load_failure_modes(point, tmp_path):
    jmodel, params, tmodel = point
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(b"not an export")
    with pytest.raises(ValueError,
                       match="not a routest_tpu_torch torch.export"):
        load_exported_serving_fn(str(bad))
    good = str(tmp_path / "good.pt2")
    export_serving_fn(good, tmodel, "cpu")
    with open(good, "rb") as f:
        blob = f.read()
    magic = ckpt.TORCH_EXPORT_MAGIC
    header_end = blob.index(b"\n", len(magic)) + 1
    header = json.loads(blob[len(magic):header_end])

    def rewrite(name, **changes):
        p = tmp_path / name
        p.write_bytes(magic + json.dumps({**header, **changes}).encode()
                      + b"\n" + blob[header_end:])
        return str(p)

    with pytest.raises(ValueError, match="unknown artifact format"):
        load_exported_serving_fn(rewrite("fmt.pt2", format="other"))
    with pytest.raises(ValueError, match="artifact version 9"):
        load_exported_serving_fn(rewrite("ver.pt2", version=9))
    with pytest.raises(ValueError, match="exported by torch 1.0"):
        load_exported_serving_fn(rewrite("torch.pt2", torch="1.0.0"))
    with pytest.raises(ValueError, match="lacks the 0.5 median"):
        load_exported_serving_fn(rewrite("q.pt2", quantiles=[0.1, 0.9]))
    trunc = tmp_path / "trunc.pt2"
    trunc.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        load_exported_serving_fn(str(trunc))
    # the JAX package's StableHLO export is refused by name
    jfile = str(tmp_path / "jax.stablehlo")
    jexport(jfile, jmodel, params, platforms=("cpu",))
    with pytest.raises(ValueError, match="needs the JAX package"):
        load_exported_serving_fn(jfile)
    # the service reports each refusal as a load error, never raises
    for path in (jfile, str(trunc), rewrite("q2.pt2", quantiles=[0.9])):
        svc = EtaService(ServeConfig(batch_buckets=(8,)), model_path=path,
                         device="cpu")
        assert not svc.available and svc.load_error
    # an RTPU1 artifact still loads through the sniffing
    mp = str(tmp_path / "m.msgpack")
    save_model(mp, tmodel)
    assert EtaService(ServeConfig(batch_buckets=(8,)), model_path=mp,
                      device="cpu").kernel == "torch_plain"


def test_cli_exports_and_checks_its_output(tmp_path, monkeypatch):
    from routest_tpu_torch.train import export as export_cli

    _, _, tmodel = _pair((16,), quantiles=(0.1, 0.5, 0.9), seed=3)
    mp = str(tmp_path / "q.msgpack")
    save_model(mp, tmodel)
    out = str(tmp_path / "q.pt2")
    assert export_cli.main(["--model", mp, "--out", out,
                            "--device", "cpu"]) == 0
    svc = EtaService(ServeConfig(batch_buckets=(8, 64)), model_path=out,
                     device="cpu")
    ref = EtaService(ServeConfig(batch_buckets=(8, 64)), model_path=mp,
                     device="cpu")
    rows = batch_from_mapping(generate_dataset(50, seed=4))
    np.testing.assert_allclose(svc.predict_batch(rows),
                               ref.predict_batch(rows), rtol=1e-6)
