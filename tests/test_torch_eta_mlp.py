"""Port parity: the ``EtaMLP`` module built by the weight carry-over
(``from_numpy``) against the JAX ``EtaMLP.apply`` / ``apply_quantiles``,
and the port's dtype policy and config against the JAX package's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from routest_tpu.core import config as jconfig
from routest_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from routest_tpu.core.dtypes import F32_POLICY as J_F32
from routest_tpu.data.features import batch_from_mapping
from routest_tpu.data.synthetic import generate_dataset
from routest_tpu.models import eta_mlp as jm
from routest_tpu_torch.core import config as tconfig
from routest_tpu_torch.core.dtypes import (DEFAULT_POLICY, F32_POLICY,
                                           backend_compute_policy)
from routest_tpu_torch.models import eta_mlp as tm

TOL = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 0.5)}


def _pair(hidden, quantiles, jpolicy, tpolicy, seed=0, n=256):
    jmodel = jm.EtaMLP(hidden=hidden, policy=jpolicy, quantiles=quantiles)
    feats = batch_from_mapping(generate_dataset(n, seed=seed))
    mean, std = jm.fit_normalizer(feats)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), norm_mean=mean, norm_std=std))
    tmodel = tm.EtaMLP.from_numpy(params, hidden=hidden, quantiles=quantiles,
                                  policy=tpolicy)
    return jmodel, params, tmodel, feats


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hidden,quantiles", [
    ((256, 256, 128), ()),
    ((256, 256, 128), (0.1, 0.5, 0.9)),
    ((64, 32), (0.05, 0.5, 0.95)),
    ((200, 72), ()),
])
def test_forward_matches_jax_apply(dtype, hidden, quantiles):
    jpol, tpol = (J_F32, F32_POLICY) if dtype == "f32" else \
        (J_BF16, DEFAULT_POLICY)
    jmodel, params, tmodel, feats = _pair(hidden, quantiles, jpol, tpol)
    x = feats.copy()
    x[:5, 10] = -3.0                 # negative distances clamp to 0
    x[5:8, 9] = (24.0, -1.0, 30.0)   # out-of-range hours: all-zero group
    rtol, atol = TOL[dtype]
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, x)),
                               rtol=rtol, atol=atol)
    if quantiles:
        with torch.no_grad():
            gq = tmodel.apply_quantiles(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(
            gq, np.asarray(jmodel.apply_quantiles(params, x)),
            rtol=rtol, atol=atol)
        assert (np.diff(gq, axis=1) >= -1e-5).all()


def test_quantile_heads_fused_equals_unfused_and_jax():
    rng = np.random.default_rng(0)
    out = rng.standard_normal((64, 6)).astype(np.float32) * 3
    dist = rng.uniform(0, 40, 64).astype(np.float32)
    fused = tm.quantile_heads(torch.from_numpy(out), torch.from_numpy(dist), 3)
    unfused = tm.quantile_heads_unfused(torch.from_numpy(out),
                                        torch.from_numpy(dist), 3)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        fused.numpy(), np.asarray(jm.quantile_heads(out, dist, 3)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantiles", [(0.5, 0.1), (0.0, 0.5), (0.1, 0.9),
                                       (0.5, 0.5)])
def test_quantile_validation_matches_jax(quantiles):
    with pytest.raises(ValueError) as jerr:
        jm.EtaMLP(quantiles=quantiles)
    with pytest.raises(ValueError) as terr:
        tm.EtaMLP(quantiles=quantiles)
    assert str(terr.value) == str(jerr.value)


def test_apply_quantiles_on_point_model_raises():
    with pytest.raises(ValueError):
        tm.EtaMLP(hidden=(8,)).apply_quantiles(torch.zeros((1, 12)))


def test_from_numpy_rejects_mismatched_params():
    _, params, _, _ = _pair((64, 32), (), J_F32, F32_POLICY)
    with pytest.raises(ValueError):
        tm.EtaMLP.from_numpy(params, hidden=(64, 33))
    with pytest.raises(ValueError):
        tm.EtaMLP.from_numpy(params, hidden=(64,))


def test_softplus_matches_jax_and_is_stable():
    x = np.asarray([-200.0, -30.0, -1.0, 0.0, 1e-3, 5.0, 30.0, 200.0],
                   np.float32)
    want = np.asarray(jax.nn.softplus(x))
    np.testing.assert_allclose(tm.softplus(torch.from_numpy(x)).numpy(),
                               want, rtol=1e-6)
    from routest_tpu_torch.ops.fused_mlp import softplus as kernel_softplus

    np.testing.assert_allclose(kernel_softplus(torch.from_numpy(x)).numpy(),
                               want, rtol=1e-6)


def test_backend_compute_policy(monkeypatch):
    monkeypatch.delenv("RTPU_CPU_COMPUTE", raising=False)
    assert backend_compute_policy(DEFAULT_POLICY, "cpu").compute_dtype == \
        torch.float32
    assert backend_compute_policy(DEFAULT_POLICY, "cuda").compute_dtype == \
        torch.bfloat16
    assert backend_compute_policy(F32_POLICY, "cpu") == F32_POLICY
    monkeypatch.setenv("RTPU_CPU_COMPUTE", "bf16")
    assert backend_compute_policy(DEFAULT_POLICY, "cpu") == DEFAULT_POLICY
    # the JAX package swaps the same way on its CPU backend
    model = dataclasses.replace(jm.EtaMLP(), policy=J_BF16)
    monkeypatch.delenv("RTPU_CPU_COMPUTE", raising=False)
    from routest_tpu.core.dtypes import backend_compute_policy as jbcp

    assert np.dtype(jbcp(model).policy.compute_dtype).name == "float32"


@pytest.mark.parametrize("env", [
    {},
    {"PORT": "8123", "RTPU_HOST": "0.0.0.0", "RTPU_MAX_BATCH": "512",
     "RTPU_MAX_WAIT_MS": "4.5", "RTPU_BATCH_BUCKETS": "64,8,512",
     "ETA_MODEL_PATH": "/m.msgpack", "RTPU_FASTLANE_CACHE": "0",
     "RTPU_FASTLANE_CACHE_SIZE": "16", "RTPU_FASTLANE_CACHE_TTL_S": "2",
     "RTPU_FASTLANE_SINGLEFLIGHT": "0", "RTPU_FASTLANE_MAX_ROWS": "7",
     "RTPU_FASTLANE_ADAPTIVE": "0", "RTPU_FASTLANE_MIN_WAIT_MS": "0.5",
     "GIT_COMMIT_SHA": "abc123"},
    {"RTPU_PORT": "9000", "RTPU_BATCH_BUCKETS": "x,y",
     "RTPU_MODEL_PATH": "/other.msgpack"},
])
def test_load_config_matches_jax(env):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jconfig.load_config(env)
        got = tconfig.load_config(env)
    for field in dataclasses.fields(got.serve):
        if field.name != "device":
            assert getattr(got.serve, field.name) == \
                getattr(want.serve, field.name), field.name
    assert got.model.model_path == want.model.model_path
    assert got.serve.device == "cuda"
    assert tconfig.load_config({"ROUTEST_DEVICE": "cpu"}).serve.device == "cpu"
