"""Port parity: the fused ETA kernel's packing and its plain PyTorch
version against the JAX package — ``pack_eta_params`` bit for bit, the
plain version against ``fused_eta_forward(..., interpret=True)`` and
``EtaMLP.apply`` / ``apply_quantiles`` at the tolerance classes of
``tests/test_ops_fused.py``. The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from routest_tpu.core.dtypes import DEFAULT_POLICY as J_BF16
from routest_tpu.core.dtypes import F32_POLICY as J_F32
from routest_tpu.data.features import batch_from_mapping, encode_requests
from routest_tpu.data.synthetic import generate_dataset
from routest_tpu.models.eta_mlp import EtaMLP as JaxEtaMLP
from routest_tpu.models.eta_mlp import fit_normalizer
from routest_tpu.ops import fused_mlp as jops
from routest_tpu_torch.ops import build as kbuild
from routest_tpu_torch.ops import fused_mlp as tops

# (rtol, atol) — tests/test_ops_fused.py:145-149.
TOL = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 0.5)}


def _jax_model(hidden=(64, 32), quantiles=(), policy=J_F32, seed=0, n=512):
    model = JaxEtaMLP(hidden=hidden, policy=policy, quantiles=quantiles)
    feats = batch_from_mapping(generate_dataset(n, seed=seed))
    mean, std = fit_normalizer(feats)
    params = model.init(jax.random.PRNGKey(seed), norm_mean=mean,
                        norm_std=std)
    return model, jax.tree_util.tree_map(np.asarray, params), feats


def _plain(packed, x, n_q=0):
    return tops.fused_eta_forward(packed, torch.from_numpy(x),
                                  n_q=n_q).numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hidden,quantiles", [
    ((256, 256, 128), (0.1, 0.5, 0.9)),
    ((64, 32), ()),
    ((200, 72), (0.25, 0.5, 0.75, 0.9)),
])
def test_pack_matches_jax_bitwise(dtype, hidden, quantiles):
    model, params, _ = _jax_model(hidden, quantiles)
    want = jops.pack_eta_params(model, params, dtype=dtype)
    got = tops.pack_eta_params(None, params, dtype=dtype)
    assert len(got["w"]) == len(want["w"])
    for i, (jw, tw, jb, tb) in enumerate(zip(want["w"], got["w"],
                                             want["b"], got["b"])):
        k, n = tw.shape
        assert k == (tops.K0 if i == 0 else params["layers"][i]["w"].shape[0])
        assert n == params["layers"][i]["w"].shape[1]   # no width padding
        rows = 67 if i == 0 else k
        jw = np.asarray(jw)
        if dtype == "bf16":
            assert tw.dtype == torch.bfloat16
            jbits = jw.view(np.uint16)[:rows, :n]
            tbits = tw.view(torch.int16).numpy().view(np.uint16)[:rows]
            np.testing.assert_array_equal(tbits, jbits)
        else:
            assert tw.dtype == torch.float32
            assert tw.numpy()[:rows].tobytes() == \
                np.ascontiguousarray(jw[:rows, :n]).tobytes()
        if i == 0:
            assert not tw[67:].float().any()            # K pad rows are zero
        assert tb.dtype == torch.float32
        assert tb.numpy().tobytes() == np.asarray(jb)[0, :n].tobytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)])
@pytest.mark.parametrize("hidden", [(64, 32), (200, 72)])
def test_plain_matches_pallas_interpret(dtype, quantiles, hidden):
    model, params, feats = _jax_model(hidden, quantiles)
    n_q = len(quantiles)
    x = feats[:130]            # odd, not a multiple of any tile
    want = np.asarray(jops.fused_eta_forward(
        jops.pack_eta_params(model, params, dtype=dtype), x, n_q=n_q,
        tile=64, interpret=True))
    got = _plain(tops.pack_eta_params(None, params, dtype=dtype), x, n_q)
    assert got.shape == want.shape and got.dtype == np.float32
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if n_q:
        assert (np.diff(got, axis=1) >= -1e-5).all()


@pytest.mark.parametrize("dtype,policy", [("f32", J_F32), ("bf16", J_BF16)])
@pytest.mark.parametrize("quantiles", [(), (0.1, 0.5, 0.9)])
def test_plain_matches_eta_mlp_apply(dtype, policy, quantiles):
    model, params, feats = _jax_model((96, 40), quantiles, policy=policy)
    x = feats[:256]
    if quantiles:
        want = np.asarray(model.apply_quantiles(params, x))
    else:
        want = np.asarray(model.apply(params, x))
    got = _plain(tops.pack_eta_params(None, params, dtype=dtype), x,
                 len(quantiles))
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("n_q", [0, 3])
def test_plain_odd_batches(batch, n_q):
    quantiles = (0.1, 0.5, 0.9) if n_q else ()
    model, params, feats = _jax_model((64, 32), quantiles)
    want = np.asarray(jops.fused_eta_forward(
        jops.pack_eta_params(model, params, dtype="f32"), feats[:batch],
        n_q=n_q, interpret=True))
    got = _plain(tops.pack_eta_params(None, params, dtype="f32"),
                 feats[:batch], n_q)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_plain_empty_batch_shapes():
    _, params, feats = _jax_model((64, 32))
    packed = tops.pack_eta_params(None, params, dtype="f32")
    out = tops.fused_eta_forward(packed, torch.from_numpy(feats[:0]))
    assert tuple(out.shape) == (0,) and out.dtype == torch.float32
    _, qparams, _ = _jax_model((64, 32), (0.1, 0.5, 0.9))
    qpacked = tops.pack_eta_params(None, qparams, dtype="f32")
    out = tops.fused_eta_forward(qpacked, torch.from_numpy(feats[:0]), n_q=3)
    assert tuple(out.shape) == (0, 3)


def test_plain_unknown_categories_negative_distance_out_of_range_hours():
    model, params, _ = _jax_model((64, 32), (0.1, 0.5, 0.9))
    rows = encode_requests(
        weather=["Fog", "Sunny", "Cloudy", "Windy"],
        traffic=["Gridlock", "Medium", "Low", "Jam"],
        weekday=[0, 6, 3, 9], hour=[0, 23, 12, 30],
        distance_km=[5.0, 12.5, 0.0, 2.0],
        driver_age=[30.0, 55.0, 18.0, 41.0])
    rows[2, 10] = -4.0        # malformed negative distance: clamps to 0
    rows[1, 9] = -1.0         # out-of-range hour: hits no weight row
    want = np.asarray(jops.fused_eta_forward(
        jops.pack_eta_params(model, params, dtype="f32"), rows, n_q=3,
        interpret=True))
    got = _plain(tops.pack_eta_params(None, params, dtype="f32"), rows, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert np.isfinite(got).all() and (np.diff(got, axis=1) >= -1e-5).all()


def test_folded_normalizer_extreme_stats():
    model, params, feats = _jax_model((64, 32))
    params["norm"]["mean"] = params["norm"]["mean"].copy()
    params["norm"]["std"] = params["norm"]["std"].copy()
    params["norm"]["mean"][10:12] = (37.5, 44.0)
    params["norm"]["std"][10:12] = (0.25, 9.0)
    want = np.asarray(model.apply(params, feats[:128]))
    got = _plain(tops.pack_eta_params(None, params, dtype="f32"), feats[:128])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_resolve_kernel_dtype_matches_jax(monkeypatch):
    jmodel = JaxEtaMLP(policy=J_F32)

    @dataclasses.dataclass
    class _M:
        policy: object

    from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, F32_POLICY

    monkeypatch.delenv("RTPU_KERNEL_DTYPE", raising=False)
    assert tops.resolve_kernel_dtype(_M(F32_POLICY)) == \
        jops.resolve_kernel_dtype(jmodel) == "float32"
    assert tops.resolve_kernel_dtype(_M(DEFAULT_POLICY)) == "bfloat16"
    assert tops.resolve_kernel_dtype(None, "fp32") == "float32"
    monkeypatch.setenv("RTPU_KERNEL_DTYPE", "int8")
    assert tops.resolve_kernel_dtype(_M(F32_POLICY)) == "int8"
    monkeypatch.setenv("RTPU_KERNEL_DTYPE", "fp7")
    with pytest.raises(ValueError) as terr:
        tops.resolve_kernel_dtype(_M(F32_POLICY))
    with pytest.raises(ValueError) as jerr:
        jops.resolve_kernel_dtype(jmodel)
    assert str(terr.value) == str(jerr.value)


def test_int8_variant_not_ported_raises():
    _, params, _ = _jax_model((64, 32))
    with pytest.raises(NotImplementedError):
        tops.pack_eta_params(None, params, dtype="int8")


def test_wrapper_cpu_uses_plain_and_counts_no_launch():
    _, params, feats = _jax_model((64, 32))
    packed = tops.pack_eta_params(None, params, dtype="f32")
    before = tops.fused_eta_forward.launches
    x = torch.from_numpy(feats[:16])
    got = tops.fused_eta_forward(packed, x)
    torch.testing.assert_close(got, tops.fused_eta_forward_plain(packed, x),
                               rtol=0, atol=0)
    assert tops.fused_eta_forward.launches == before


def test_wrapper_refuses_non_cpu_non_cuda_device():
    _, params, feats = _jax_model((64, 32))
    packed = tops.pack_eta_params(None, params, dtype="f32")
    with pytest.raises(ValueError):
        tops.fused_eta_forward(packed, torch.empty((4, 12), device="meta"))


def test_launch_dims_accepts_served_shapes_and_rejects_others():
    _, params, _ = _jax_model((256, 256, 128), (0.1, 0.5, 0.9))
    packed = tops.pack_eta_params(None, params, dtype="bf16")
    x = torch.zeros((5, 12))
    assert tops._launch_dims(packed, x, 3) == [80, 256, 256, 128, 6]
    with pytest.raises(ValueError):
        tops._launch_dims(packed, x, 0)                 # 6 heads ≠ point
    with pytest.raises(ValueError):
        tops._launch_dims(packed, torch.zeros((5, 11)), 3)
    with pytest.raises(ValueError):
        tops._launch_dims(packed, torch.zeros((12, 5)).T, 3)
    mixed = {"w": [packed["w"][0].float()] + packed["w"][1:],
             "b": packed["b"]}
    with pytest.raises(ValueError):
        tops._launch_dims(mixed, x, 3)
    broken = {"w": [packed["w"][0], packed["w"][2]], "b": packed["b"][:2]}
    with pytest.raises(ValueError):
        tops._launch_dims(broken, x, 3)
    wide = {"w": [torch.zeros((80, 4000)), torch.zeros((4000, 2))],
            "b": [torch.zeros(4000), torch.zeros(2)]}
    with pytest.raises(ValueError):                     # shared memory
        tops._launch_dims(wide, x, 0)
    int8 = {"w": [w.to(torch.int8) for w in packed["w"]], "b": packed["b"]}
    with pytest.raises(NotImplementedError):
        tops._launch_dims(int8, x, 3)


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(kbuild.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.find_nvcc()


def test_kernel_source_and_flags():
    """The kernel is CUDA C++ for sm_90a with a plain C interface, and
    the launch counter is a plain integer."""
    import os

    src = os.path.join(os.path.dirname(kbuild.__file__), "csrc",
                       "fused_eta.cu")
    text = open(src).read()
    assert 'extern "C" int rtpu_fused_eta_forward' in text
    assert "cudaGetLastError" in text and "cublas" not in text.lower()
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS
    assert isinstance(tops.fused_eta_forward.launches, int)
    # the kernel's limits mirror the wrapper's
    assert "kTile = %d;" % tops._TILE_ROWS in text
    assert "kMaxLayers = %d;" % tops._MAX_LAYERS in text
    assert "kMaxQ = %d;" % tops._MAX_Q in text
    assert "kK0 = %d;" % tops.K0 in text
