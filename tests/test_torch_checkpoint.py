"""Port parity: the ``RTPU1`` artifact reader and its msgpack decoder
against flax / ``msgpack`` / the JAX ``load_model``, and the port's
import isolation from jax, flax, msgpack, werkzeug and routest_tpu."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from flax import serialization

from routest_tpu.train import checkpoint as jck
from routest_tpu_torch.train import checkpoint as tck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("eta_mlp.msgpack", "eta_mlp_point.msgpack")


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_arrays_bitwise(name):
    path = os.path.join(REPO, "artifacts", name)
    jmodel, jparams = jck.load_model(path)
    model, params = tck.load_model(path)
    jleaves, jtree = jax.tree_util.tree_flatten(jparams)
    leaves, tree = jax.tree_util.tree_flatten(params)
    assert tree == jtree
    for a, b in zip(leaves, jleaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert model.hidden == jmodel.hidden
    assert model.quantiles == jmodel.quantiles
    assert str(model.policy.compute_dtype) == "torch.bfloat16"


def _write(path, magic, header, blob=b""):
    with open(path, "wb") as f:
        f.write(magic + json.dumps(header).encode() + b"\n" + blob)
    return str(path)


@pytest.mark.parametrize("case", ["magic", "format", "version", "quantiles"])
def test_error_text_identical(tmp_path, case):
    header = {"format": "routest_tpu.eta_mlp", "version": 2,
              "hidden": [8], "n_features": 12}
    magic = jck.MAGIC
    if case == "magic":
        magic = b"NOPE1\n"
    elif case == "format":
        header["format"] = "something.else"
    elif case == "version":
        header["version"] = 1
    else:
        header["version"] = 3
    path = _write(tmp_path / "bad.msgpack", magic, header)
    with pytest.raises(ValueError) as jerr:
        jck.load_model(path)
    with pytest.raises(ValueError) as terr:
        tck.load_model(path)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33,
    -129, -40000, -2**40, 1.5, -2.25e300, True, False, None,
    "", "a" * 31, "b" * 32, "c" * 300, "ü" * 40_000, b"", b"\x00" * 300,
    b"x" * 70_000, [], list(range(20)), list(range(70_000)),
    {"k": 1}, {str(i): i for i in range(20)},
    {"nested": [{"a": [1, 2.5, None]}, {"b": {"c": "d"}}]},
])
def test_msgpack_decoder_matches_msgpack(obj):
    packed = msgpack.packb(obj, use_bin_type=True)
    assert tck._unpackb(packed) == msgpack.unpackb(packed, raw=False)


def test_msgpack_float32_and_truncation():
    packed = msgpack.packb(1.25, use_single_float=True)
    assert tck._unpackb(packed) == 1.25
    with pytest.raises(ValueError):
        tck._unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError):
        tck._unpackb(msgpack.packb(1) + b"\x01")


def test_flax_pytree_roundtrip():
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w": rng.standard_normal((5, 3)).astype(np.float32),
                        "b": np.arange(3, dtype=np.int32)},
                       {"w": rng.standard_normal((3, 1)).astype(np.float16),
                        "b": np.zeros((1,), np.float64)}],
            "scalar": np.float32(2.5),
            "bf16": np.asarray(jnp.asarray([1.5, -2.0, 3.25], jnp.bfloat16))}
    blob = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(blob)
    got = tck._unpackb(blob)
    for a, b in zip(jax.tree_util.tree_leaves(got["layers"]),
                    jax.tree_util.tree_leaves(want["layers"])):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got["scalar"] == want["scalar"] == np.float32(2.5)
    # bf16 leaves widen exactly to float32
    np.testing.assert_array_equal(got["bf16"],
                                  np.asarray(want["bf16"], np.float32))


def test_default_model_path(monkeypatch):
    from routest_tpu_torch.core.config import ModelConfig

    monkeypatch.delenv("ETA_MODEL_PATH", raising=False)
    assert tck.default_model_path() == os.path.join(
        REPO, "artifacts", "eta_mlp.msgpack")
    monkeypatch.setenv("ETA_MODEL_PATH", "/elsewhere/m.msgpack")
    assert tck.default_model_path() == "/elsewhere/m.msgpack"
    assert tck.default_model_path(ModelConfig(model_path="x")) == "x"
    assert jck.default_model_path() == tck.default_model_path()


def test_import_isolation_subprocess():
    """The port, its app, its route-optimization, road-routing and
    training modules and its artifact readers and writers load (the
    default road router with its GNN and transformer included, and an
    artifact written and read back) with jax, flax, optax, orbax,
    msgpack, werkzeug and the JAX package all unimportable."""
    code = f"""
import sys
for m in ("jax", "flax", "optax", "orbax", "msgpack", "werkzeug",
          "routest_tpu"):
    sys.modules[m] = None
sys.path.insert(0, {REPO!r})
import routest_tpu_torch
import routest_tpu_torch.serve.app
import routest_tpu_torch.serve.__main__
import routest_tpu_torch.ops.build
import routest_tpu_torch.core.prng
import routest_tpu_torch.optimize.engine
import routest_tpu_torch.optimize.ranking
import routest_tpu_torch.serve.store
import routest_tpu_torch.data.osm
import routest_tpu_torch.optimize.hierarchy
import routest_tpu_torch.optimize.route_cache
import routest_tpu_torch.models.gnn
import routest_tpu_torch.models.route_transformer
import routest_tpu_torch.models.gbdt
import routest_tpu_torch.data.synthetic
import routest_tpu_torch.data.csv_io
import routest_tpu_torch.train.loop
import routest_tpu_torch.train.baseline
import routest_tpu_torch.train.report
import routest_tpu_torch.train.__main__
import routest_tpu_torch.train.gnn
import routest_tpu_torch.train.transformer
import routest_tpu_torch.live.trainer
import routest_tpu_torch.live.service
from routest_tpu_torch.optimize.road_router import RoadRouter
from routest_tpu_torch.train.checkpoint import load_model
model, params = load_model({os.path.join(REPO, "artifacts", "eta_mlp.msgpack")!r})
assert model.quantiles == (0.1, 0.5, 0.9), model.quantiles
router = RoadRouter(device="cpu")
assert router.leg_cost_model == "gnn" and router.has_transformer
import tempfile
from routest_tpu_torch.train.checkpoint import save_model
with tempfile.TemporaryDirectory() as d:
    save_model(d + "/m.msgpack", model)
    again, _ = load_model(d + "/m.msgpack")
    assert again.quantiles == model.quantiles
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "orbax", "msgpack", "werkzeug",
        "routest_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
