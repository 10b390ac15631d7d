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

# (rtol, atol) — tests/test_ops_fused.py:145-149. The plain int8
# version against the Pallas interpreter on the same int8 packing is
# bf16 arithmetic (both dequantize to bf16 first): the bf16 class.
TOL = {"f32": (1e-4, 1e-3), "bf16": (2e-2, 0.5), "int8": (5e-2, 1.5)}


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


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hidden,quantiles", [
    ((256, 256, 128), (0.1, 0.5, 0.9)),
    ((64, 32), ()),
    ((200, 72), (0.25, 0.5, 0.75, 0.9)),
])
def test_pack_matches_jax_bitwise(dtype, hidden, quantiles):
    """Real rows and columns equal the JAX packing bit for bit (int8: q
    values and scales); every pad row and column is zero (scale 1)."""
    model, params, _ = _jax_model(hidden, quantiles)
    want = jops.pack_eta_params(model, params, dtype=dtype)
    got = tops.pack_eta_params(None, params, dtype=dtype)
    assert len(got["w"]) == len(want["w"])
    assert got["n_heads"] == params["layers"][-1]["w"].shape[1]
    assert ("scale" in got) == ("scale" in want) == (dtype == "int8")
    stored = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}[dtype]
    for i, (jw, tw, jb, tb) in enumerate(zip(want["w"], got["w"],
                                             want["b"], got["b"])):
        k_real, n_real = params["layers"][i]["w"].shape
        k, n = tw.shape
        assert k == (tops.K0 if i == 0 else -(-k_real // tops.PAD) * tops.PAD)
        assert n == -(-n_real // tops.PAD) * tops.PAD
        rows = 67 if i == 0 else k_real
        assert tw.dtype == stored
        jw = np.ascontiguousarray(np.asarray(jw)[:rows, :n_real])
        tnp = tw.view(torch.int16).numpy() if dtype == "bf16" else tw.numpy()
        assert np.ascontiguousarray(tnp[:rows, :n_real]).tobytes() == \
            jw.tobytes()
        assert not tw[rows:].float().any()            # K pad rows are zero
        assert not tw[:, n_real:].float().any()       # N pad columns too
        assert tb.dtype == torch.float32 and tuple(tb.shape) == (n,)
        assert tb.numpy()[:n_real].tobytes() == \
            np.asarray(jb)[0, :n_real].tobytes()
        assert not tb[n_real:].any()
        if dtype == "int8":
            js, ts = np.asarray(want["scale"][i]), got["scale"][i]
            assert ts.dtype == torch.float32 and tuple(ts.shape) == (n,)
            assert ts.numpy()[:n_real].tobytes() == js[0, :n_real].tobytes()
            assert (ts.numpy()[n_real:] == 1.0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
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
    rtol, atol = TOL["bf16" if dtype == "int8" else dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if n_q:
        assert (np.diff(got, axis=1) >= -1e-5).all()


@pytest.mark.parametrize("dtype,policy", [("f32", J_F32), ("bf16", J_BF16),
                                          ("int8", J_F32)])
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
    if quantiles:
        assert (np.diff(got, axis=1) >= -1e-5).all()


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


def test_int8_plain_dequantizes_like_the_pallas_kernel():
    """The plain int8 version is the bf16 path on bf16_rn(float(q) * s)
    weights (fused_mlp.py:271): equal, bit for bit, to the plain version
    run on that dequantized bf16 packing."""
    _, params, feats = _jax_model((64, 32), (0.1, 0.5, 0.9))
    packed = tops.pack_eta_params(None, params, dtype="int8")
    deq = {"w": tuple((w.float() * s).to(torch.bfloat16)
                      for w, s in zip(packed["w"], packed["scale"])),
           "b": packed["b"]}
    x = torch.from_numpy(feats[:64])
    torch.testing.assert_close(
        tops.fused_eta_forward_plain(packed, x, n_q=3),
        tops.fused_eta_forward_plain(deq, x, n_q=3), rtol=0, atol=0)


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
    assert tops._launch_dims(packed, x, 3) == [80, 256, 256, 128, 16]
    with pytest.raises(ValueError):
        tops._launch_dims(packed, x, 0)                 # 6 heads ≠ point
    with pytest.raises(ValueError):
        tops._launch_dims(packed, torch.zeros((5, 11)), 3)
    with pytest.raises(ValueError):
        tops._launch_dims(packed, torch.zeros((12, 5)).T, 3)
    mixed = dict(packed, w=(packed["w"][0].float(),) + packed["w"][1:])
    with pytest.raises(ValueError):
        tops._launch_dims(mixed, x, 3)
    broken = {"w": (packed["w"][0], packed["w"][2]), "b": packed["b"][:2]}
    with pytest.raises(ValueError):
        tops._launch_dims(broken, x, 3)
    wide = {"w": (torch.zeros((80, 4000)), torch.zeros((4000, 2))),
            "b": (torch.zeros(4000), torch.zeros(2))}
    with pytest.raises(ValueError):                     # shared memory
        tops._launch_dims(wide, x, 0)
    ragged = {"w": (torch.zeros((80, 40), dtype=torch.bfloat16),
                    torch.zeros((40, 2), dtype=torch.bfloat16)),
              "b": (torch.zeros(40), torch.zeros(2))}
    with pytest.raises(ValueError, match="multiples of 16"):
        tops._launch_dims(ragged, x, 0)                 # not mma-tiled
    f16 = dict(packed, w=tuple(w.half() for w in packed["w"]))
    with pytest.raises(NotImplementedError):
        tops._launch_dims(f16, x, 3)


@pytest.mark.parametrize("hidden", [(64, 32), (200, 72), (96, 40),
                                    (256, 256, 128)])
def test_launch_dims_int8_takes_scales(hidden):
    _, params, _ = _jax_model(hidden, (0.1, 0.5, 0.9))
    packed = tops.pack_eta_params(None, params, dtype="int8")
    x = torch.zeros((5, 12))
    dims = tops._launch_dims(packed, x, 3)
    assert dims[0] == 80 and dims[-1] == 16
    assert all(d % tops.PAD == 0 for d in dims)
    assert dims[1:-1] == [-(-h // 16) * 16 for h in hidden]
    unscaled = {k: v for k, v in packed.items() if k != "scale"}
    with pytest.raises(ValueError, match="scale"):
        tops._launch_dims(unscaled, x, 3)
    short = dict(packed, scale=packed["scale"][:-1])
    with pytest.raises(ValueError, match="scale"):
        tops._launch_dims(short, x, 3)
    wrong = dict(packed, scale=packed["scale"][:-1]
                 + (packed["scale"][-1][:8],))
    with pytest.raises(ValueError, match="scale"):
        tops._launch_dims(wrong, x, 3)
    halved = dict(packed, scale=tuple(s.half() for s in packed["scale"]))
    with pytest.raises(ValueError, match="scale"):
        tops._launch_dims(halved, x, 3)
    bf16 = tops.pack_eta_params(None, params, dtype="bf16")
    with pytest.raises(ValueError, match="no scales"):
        tops._launch_dims(dict(bf16, scale=packed["scale"]), x, 3)


def test_launch_args_cached_on_their_packing():
    """The C entry's arguments (dims array, slab stream or pointer
    arrays) are built once, by ``pack_eta_params`` on the card, and live
    on the packing (``packed["launch"]``), so they die with it. On the
    CPU the plain version runs and nothing is built."""
    import gc
    import weakref

    _, params, _ = _jax_model((64, 32), (0.1, 0.5, 0.9))
    packed = tops.pack_eta_params(None, params, dtype="int8")
    assert "launch" not in packed
    args = tops._launch_args(packed)
    assert list(args.c_dims) == args.dims == [80, 64, 32, 16]
    assert args.code == 2 and args.slabs.dtype == torch.uint8
    assert args.slabs_ptr == args.slabs.data_ptr() and args.sms is None
    assert args.c_w is None and args.c_b is None
    assert torch.equal(args.slabs, tops._slab_stream(packed))
    f32 = tops.pack_eta_params(None, params, dtype="f32")
    f32_args = tops._launch_args(f32)
    assert f32_args.slabs is None and f32_args.code == 0
    assert list(f32_args.c_w) == [w.data_ptr() for w in f32["w"]]
    assert list(f32_args.c_b) == [b.data_ptr() for b in f32["b"]]
    packed["launch"] = args         # where pack_eta_params keeps it
    ref = weakref.ref(args.slabs)
    del args, packed
    gc.collect()
    assert ref() is None
    unscaled = {k: v for k, v in f32.items()}
    unscaled["w"] = tuple(w.to(torch.int8) for w in f32["w"])
    with pytest.raises(ValueError, match="scale"):  # checked when built
        tops._launch_args(unscaled)


def test_tile_rule():
    """16-row tiles while every block has an SM of its own, then 32-row
    tiles; 16 wherever a 32-row tile does not fit in shared memory."""
    served = [80, 256, 256, 128, 16]
    for dtype in (torch.bfloat16, torch.int8):
        assert tops.tile_rows(1, served, dtype, 132) == 16
        assert tops.tile_rows(2112, served, dtype, 132) == 16
        assert tops.tile_rows(2113, served, dtype, 132) == 32
        assert tops.tile_rows(4224, served, dtype, 132) == 32
        assert tops.tile_rows(16384, served, dtype, 132) == 32
        assert tops._smem_bytes(served, dtype, 32) <= tops._MAX_SMEM
    wide = [80, 1536, 16]           # a 32-row tile would not fit
    assert tops._smem_bytes(wide, torch.bfloat16, 16) <= tops._MAX_SMEM
    assert tops._smem_bytes(wide, torch.bfloat16, 32) > tops._MAX_SMEM
    assert tops.tile_rows(16384, wide, torch.bfloat16, 132) == 16
    assert tops.tile_rows(100, wide, torch.bfloat16, 132) == 16


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("hidden", [(256, 256, 128), (200, 72), (512, 40)])
def test_slab_stream_layout(dtype, hidden):
    """Walking the stream record by record with the kernel's rules
    (record_bytes in csrc/fused_eta.cu) gives back every weight, scale
    and bias of the packing, with zero row padding, and ends exactly."""
    _, params, _ = _jax_model(hidden, (0.1, 0.5, 0.9))
    packed = tops.pack_eta_params(None, params, dtype=dtype)
    stream = tops._slab_stream(packed)
    quant = dtype == "int8"
    elt = 1 if quant else 2
    pad = 16 if quant else 8
    off = 0
    for i, (w, b) in enumerate(zip(packed["w"], packed["b"])):
        k, n = w.shape
        for c0 in range(0, n, tops._PASS_COLS):
            cols = min(tops._PASS_COLS, n - c0)
            for k0 in range(0, k, tops._SLAB_ROWS):
                rows = min(tops._SLAB_ROWS, k - k0)
                size = rows * (cols + pad) * elt
                assert off % 16 == 0 and size % 16 == 0
                blk = stream[off:off + size].view(w.dtype).reshape(
                    rows, cols + pad)
                assert torch.equal(blk[:, :cols], w[k0:k0 + rows, c0:c0 + cols])
                assert not blk[:, cols:].float().any()
                off += size
                if quant:
                    s = stream[off:off + 4 * cols].view(torch.float32)
                    assert torch.equal(s, packed["scale"][i][c0:c0 + cols])
                    off += 4 * cols
                if k0 + tops._SLAB_ROWS >= k:
                    got = stream[off:off + 4 * cols].view(torch.float32)
                    assert torch.equal(got, b[c0:c0 + cols])
                    off += 4 * cols
    assert off == stream.numel()


def test_build_keeps_compiler_report_beside_library(monkeypatch, tmp_path):
    """The register/spill report of a build is kept with its library and
    comes back when the library is already built, so a spill check holds
    on every run, not only the one that compiled."""
    import os
    import stat
    import sys

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "sys.stderr.write(\"ptxas info    : Used 48 registers\\n\")\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: str(fake))
    path, report = kbuild.build("fused_eta")
    assert "Used 48 registers" in report
    assert open(path).read() == "lib"
    assert open(path + ".ptxas.txt").read() == report

    def no_compiler():
        raise AssertionError("rebuilt a library that was already built")

    monkeypatch.setattr(kbuild, "find_nvcc", no_compiler)
    assert kbuild.build("fused_eta") == (path, report)
    os.remove(path + ".ptxas.txt")          # a library without its report
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: str(fake))
    assert kbuild.build("fused_eta") == (path, report)


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(kbuild.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.find_nvcc()


def test_kernel_source_and_flags():
    """The kernel is CUDA C++ for sm_90a with a plain C interface: bf16
    and int8 on the tensor cores (mma.sync fed by ldmatrix), weights
    staged through shared memory by TMA bulk copies (cp.async.bulk) that
    complete on mbarriers, no library GEMM, and the launch counter a
    plain integer."""
    import os
    import re

    src = os.path.join(os.path.dirname(kbuild.__file__), "csrc",
                       "fused_eta.cu")
    text = open(src).read()
    assert 'extern "C" int rtpu_fused_eta_forward' in text
    assert "mma.sync.aligned.m16n8k16" in text and "ldmatrix" in text
    assert "cp.async.bulk.shared::cluster.global.mbarrier" in text
    assert "mbarrier.try_wait.parity" in text
    assert "cudaGetLastError" in text and "cudaDeviceSynchronize" not in text
    assert "cublas" not in text.lower() and "cutlass/gemm" not in text.lower()
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS
    assert isinstance(tops.fused_eta_forward.launches, int)
    # the kernel's limits and shared-memory layout mirror the wrapper's
    for name, value in (("kMaxLayers", tops._MAX_LAYERS),
                        ("kMaxQ", tops._MAX_Q), ("kK0", tops.K0),
                        ("kPad", tops.PAD), ("kSlabRows", tops._SLAB_ROWS),
                        ("kStages", tops._STAGES),
                        ("kPassCols", tops._PASS_COLS),
                        ("kTileF32", tops._TILE_F32),
                        ("kThreads", 512)):
        assert re.search(r"constexpr int %s = %d;" % (name, value), text), name
    # slab rows pad by 8 bf16 / 16 int8 elements (_LDW, _LDQ at full width)
    assert "return kQuant ? cols + %d : (cols + %d) * 2;" % (
        tops._LDQ - tops._PASS_COLS, tops._LDW - tops._PASS_COLS) in text
    # the tiles the kernel is instantiated for are the wrapper's
    for quant in ("false", "true"):
        tiles = re.findall(r"fused_eta_tc_kernel<%s, (\d+)>" % quant, text)
        assert sorted(set(map(int, tiles))) == list(tops._TILES)
    codes = dict(re.findall(r"k(F32|Bf16|Int8) = (\d)", text))
    assert {torch.float32: int(codes["F32"]), torch.bfloat16:
            int(codes["Bf16"]), torch.int8: int(codes["Int8"])} == \
        tops._VARIANT_CODE
    # load_library's argtypes follow the C entry's parameters
    sig = re.search(r'extern "C" int rtpu_fused_eta_forward\((.*?)\)',
                    text, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    kinds = tuple(kbuild._I32 if p.startswith("int ") else kbuild._PTR
                  for p in params)
    assert kinds == kbuild.FUSED_ETA_ARGTYPES and len(kinds) == 12
