"""The native data plane (``routest_tpu_torch/native``) against the JAX
package's (``routest_tpu/native``) and the port's own numpy and
ElementTree twins, bitwise.

The cases of ``tests/test_native.py``, one for one: ``encode_batch`` and
``batch_from_mapping`` with unknown categories; ``load_csv`` through the
C parser and the Python parser (``force_python``) against the JAX
package's native ``load_csv`` on the same files: the round trip, unknown
categories, malformed rows with their line numbers, over-long lines, the
missing file, the header, the numeric grammar, an infinite weekday, and
a loaded CSV feeding ``fit``. Then ``load_osm`` through the C scanner
against the JAX package's scanner and the port's ElementTree path on the
metro extract and on malformed extracts; the cache-directory refusal;
``ROUTEST_NATIVE=0``; and the two ``fastfeat.cpp`` files' SHA-256.

A case skips only where ``g++`` is missing, as the JAX tests do; with
``g++`` a failed build fails. The library builds once per machine into
the per-user cache (concurrent builders rename atomically); cases that
must not touch that cache reset the loader and point it elsewhere.
"""

import gzip
import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from routest_tpu import native as jnative
from routest_tpu.data import csv_io as jcsv
from routest_tpu.data import osm as josm
from routest_tpu.data.features import batch_from_mapping as jbatch
from routest_tpu_torch import native
from routest_tpu_torch.data import csv_io, features, osm
from routest_tpu_torch.data.features import batch_from_mapping
from routest_tpu_torch.data.synthetic import generate_dataset

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain (g++)")

HEADER = "weather,traffic,weekday,hour,distance_km,driver_age,eta_minutes\n"
METRO = "artifacts/metro_8192.osm.gz"
KEYS = ("weather_idx", "traffic_idx", "weekday", "hour", "distance_km",
        "driver_age", "eta_minutes")


@pytest.fixture(autouse=True)
def built():
    """Both libraries load (a build failure fails, it does not skip)."""
    assert native.available() and jnative.available()


@pytest.fixture()
def fresh(monkeypatch):
    """The port's loader reset, so a case decides what ``load()`` finds;
    the loaded library comes back after the case."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("ROUTEST_NATIVE", raising=False)
    monkeypatch.delenv("ROUTEST_NATIVE_CACHE", raising=False)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _salted(n, seed):
    data = generate_dataset(n, seed=seed)
    data["weather_idx"] = np.asarray(data["weather_idx"], np.int32).copy()
    data["traffic_idx"] = np.asarray(data["traffic_idx"], np.int32).copy()
    data["weather_idx"][::17] = -1
    data["traffic_idx"][::23] = -1
    return data


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


# ── encode ────────────────────────────────────────────────────────────

def test_encode_parity_with_jax_and_numpy():
    """Unknown categories (index -1) give an all-zero group in the C
    encoder, as in numpy and in the JAX package's C encoder."""
    data = _salted(4096, 3)
    cols = [data[k] for k in KEYS[:6]]
    got = native.encode_batch(*cols)
    assert got.dtype == np.float32 and got.shape == (4096, 12)
    np.testing.assert_array_equal(got, jnative.encode_batch(*cols))
    assert not got[::17, :4].any() and not got[::23, 4:8].any()
    np.testing.assert_array_equal(
        got, batch_from_mapping(data, force_python=True))


def test_batch_from_mapping_uses_native_and_matches(monkeypatch):
    data = _salted(512, 4)
    calls = []
    encode = native.encode_batch
    monkeypatch.setattr(native, "encode_batch",
                        lambda *a: calls.append(1) or encode(*a))
    got = batch_from_mapping(data)
    assert calls == [1]
    np.testing.assert_array_equal(got, jbatch(data))
    np.testing.assert_array_equal(
        got, batch_from_mapping(data, force_python=True))
    assert calls == [1]


# ── CSV ───────────────────────────────────────────────────────────────

def test_csv_roundtrip_native_vs_python_vs_jax(tmp_path):
    data = generate_dataset(1000, seed=5)
    path = str(tmp_path / "deliveries.csv")
    csv_io.save_csv(path, data)
    via_native = csv_io.load_csv(path)
    _same(via_native, csv_io.load_csv(path, force_python=True))
    _same(via_native, jcsv.load_csv(path))
    np.testing.assert_array_equal(via_native["weather_idx"],
                                  np.asarray(data["weather_idx"], np.int32))
    np.testing.assert_allclose(via_native["distance_km"],
                               data["distance_km"], rtol=1e-5)


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
def test_csv_unknown_categories_map_to_minus_one(tmp_path, force):
    path = _write(tmp_path / "odd.csv", HEADER + "Fog,Gridlock,2,9,7.5,41,33.2\n"
                  "Sunny,Low,0,0,1.0,30,10\n")
    d = csv_io.load_csv(path, force_python=force)
    assert list(d["weather_idx"]) == [-1, 2]
    assert list(d["traffic_idx"]) == [-1, 2]
    _same(d, jcsv.load_csv(path))


def _raises_like_jax(path, marker, force):
    with pytest.raises(ValueError, match=marker) as got:
        csv_io.load_csv(path, force_python=force)
    with pytest.raises(ValueError, match=marker) as want:
        jcsv.load_csv(path)
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("row,marker", [
    ("Sunny,Low,0,0,1.0,30\n", "expected 7 fields"),
    ("Sunny,Low,0,0,oops,30,10\n", "non-numeric field"),
], ids=["fields", "numeric"])
def test_csv_malformed_rows_error_with_line(tmp_path, row, marker, force):
    path = _write(tmp_path / "bad.csv", HEADER + row)
    assert ":2:" in _raises_like_jax(path, marker, force)


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
def test_csv_overlong_line_same_error_both_paths(tmp_path, force):
    """The C parser's 4096-byte line buffer rejects 4095+-byte lines;
    the Python path rejects the same file with the same error. Just
    under the cap, an unknown 4070-byte category maps to -1."""
    long_path = _write(tmp_path / "long.csv",
                       HEADER + "W" * 5000 + ",Low,0,0,1.0,30,10\n")
    assert ":2:" in _raises_like_jax(long_path, "line exceeds 4094 bytes",
                                     force)
    ok_path = _write(tmp_path / "ok.csv",
                     HEADER + "W" * 4070 + ",Low,0,0,1.0,30,10\n")
    d = csv_io.load_csv(ok_path, force_python=force)
    assert d["weather_idx"].tolist() == [-1]
    _same(d, jcsv.load_csv(ok_path))


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
def test_csv_missing_file(tmp_path, force):
    for load in (lambda p: csv_io.load_csv(p, force_python=force),
                 jcsv.load_csv):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "nope.csv"))


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
def test_csv_header_validated(tmp_path, force):
    """A reordered header errors instead of swapping columns."""
    path = _write(tmp_path / "swapped.csv",
                  "traffic,weather,weekday,hour,distance_km,driver_age,"
                  "eta_minutes\nLow,Sunny,0,0,1.0,30,10\n")
    _raises_like_jax(path, "bad header", force)


GRAMMAR = {
    "trailing_space": ("Sunny,Low,0,0,1.0 ,30,10\n", False),
    "leading_space": ("Sunny,Low,0,0, 1.0,30,10\n", False),
    "hex": ("Sunny,Low,0,0,0x10,30,10\n", False),
    "underscore": ("Sunny,Low,0,0,1_0,30,10\n", False),
    "int32_overflow": ("Sunny,Low,1e30,9,7.5,41,33.2\n", False),
    "f32_overflow": ("Sunny,Low,0,0,1e300,30,10\n", False),
    "nan": ("Sunny,Low,0,0,nan,30,10\n", False),
    "fringe": ("Sunny,Low,2,9,+.5,41,3e1\n", True),
    "64_chars": ("Sunny,Low,0,0," + "0" * 63 + "9,30,10\n", False),
    "63_chars": ("Sunny,Low,0,0," + "0" * 62 + "9,30,10\n", True),
    "unicode_digit": ("Sunny,Low,٣,0,1.0,30,10\n", False),
}


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("case", sorted(GRAMMAR))
def test_csv_numeric_grammar_parity(tmp_path, case, force):
    """Where ``strtod`` and Python's ``float`` disagree, both paths (and
    the JAX parser) error or parse identically."""
    row, ok = GRAMMAR[case]
    path = _write(tmp_path / "g.csv", HEADER + row)
    if ok:
        d = csv_io.load_csv(path, force_python=force)
        assert len(d["eta_minutes"]) == 1
        _same(d, jcsv.load_csv(path))
    else:
        _raises_like_jax(path, "non-numeric field", force)


@pytest.mark.parametrize("force", [False, True], ids=["native", "python"])
def test_csv_inf_weekday_same_error_both_paths(tmp_path, force):
    path = _write(tmp_path / "inf.csv", HEADER + "Sunny,Low,inf,9,7.5,41,33.2\n")
    _raises_like_jax(path, "non-numeric field", force)


def test_csv_feeds_training(tmp_path):
    """CSV → dataset dict → ``fit``: the dict the C parser loads is the
    JAX parser's, and one epoch on it gives a finite eval RMSE."""
    from routest_tpu_torch.core.config import TrainConfig
    from routest_tpu_torch.core.dtypes import F32_POLICY
    from routest_tpu_torch.data.synthetic import train_eval_split
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.loop import fit

    path = str(tmp_path / "train.csv")
    csv_io.save_csv(path, generate_dataset(2000, seed=6))
    loaded = csv_io.load_csv(path)
    _same(loaded, jcsv.load_csv(path))
    train, ev = train_eval_split(loaded, eval_frac=0.2)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = fit(EtaMLP(hidden=(16,), policy=F32_POLICY), train, ev,
                  TrainConfig(epochs=1, batch_size=512), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(res.eval_rmse)


# ── OSM ───────────────────────────────────────────────────────────────

def test_osm_metro_extract_bitwise_jax_and_elementtree(monkeypatch):
    calls = []
    parse = native.parse_osm
    monkeypatch.setattr(native, "parse_osm",
                        lambda *a: calls.append(1) or parse(*a))
    got = osm.load_osm(METRO)
    assert calls == [1] and len(got["node_coords"]) == 8192
    _same(got, josm.load_osm(METRO))
    _same(got, osm.load_osm(METRO, force_python=True))
    assert calls == [1]


def _extract(path, body):
    with gzip.open(path, "wt") as f:
        f.write('<?xml version="1.0"?>\n<osm version="0.6">\n' + body)
    return str(path)


NODES = ('<node id="1" lat="14.55" lon="121.02"/>'
         '<node id="2" lat="14.56" lon="121.03"/>')
MALFORMED = {
    # truncated: no closing tags
    "truncated": NODES + '<way id="9"><nd ref="1"/><nd ref="2"/>',
    # no drivable way
    "no_roads": NODES + '<way id="9"><nd ref="1"/><nd ref="2"/>'
                        '<tag k="highway" v="footway"/></way></osm>',
    # a coordinate that is not a number
    "bad_lat": '<node id="1" lat="north" lon="121.02"/>'
               '<node id="2" lat="14.56" lon="121.03"/>'
               '<way id="9"><nd ref="1"/><nd ref="2"/>'
               '<tag k="highway" v="primary"/></way></osm>',
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_osm_malformed_extract_falls_to_elementtree(tmp_path, monkeypatch,
                                                    case):
    """The scanner reports an anomaly (None); the ElementTree path then
    owns the error, the same message as the JAX package's."""
    path = _extract(tmp_path / "bad.osm.gz", MALFORMED[case])
    with gzip.open(path, "rb") as f:
        buf = f.read()
    from routest_tpu_torch.data.road_graph import _CLASS_SPEED_MPS

    assert native.parse_osm(buf, _CLASS_SPEED_MPS) is None
    assert jnative.parse_osm(buf, _CLASS_SPEED_MPS) is None
    with pytest.raises(ValueError) as got:
        osm.load_osm(path)
    with pytest.raises(ValueError) as want:
        josm.load_osm(path)
    assert str(got.value) == str(want.value)


def test_osm_over_the_slurp_cap_takes_elementtree(monkeypatch):
    monkeypatch.setenv("ROUTEST_NATIVE_OSM_MAX_BYTES", "1024")
    monkeypatch.setattr(native, "parse_osm", lambda *a: pytest.fail(
        "the scanner ran past ROUTEST_NATIVE_OSM_MAX_BYTES"))
    _same(osm.load_osm(METRO), josm.load_osm(METRO))


# ── the loader ────────────────────────────────────────────────────────

def test_a_group_writable_cache_directory_is_refused(fresh, monkeypatch,
                                                     tmp_path):
    """A planted per-user cache directory that others can write is not
    trusted: no library, and featurization takes numpy."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    planted = tmp_path / f"routest_tpu_torch_native_{os.getuid()}"
    planted.mkdir()
    planted.chmod(0o770)
    assert native._cache_dir() is None
    assert native.load() is None and not native.available()
    data = _salted(256, 8)
    np.testing.assert_array_equal(batch_from_mapping(data), jbatch(data))
    assert list(planted.iterdir()) == []


def test_a_group_writable_override_directory_is_refused(fresh, monkeypatch,
                                                        tmp_path):
    """``ROUTEST_NATIVE_CACHE`` is held to the per-user cache's policy: a
    directory others can write gives no library and numpy."""
    planted = tmp_path / "override"
    planted.mkdir()
    planted.chmod(0o775)
    monkeypatch.setenv("ROUTEST_NATIVE_CACHE", str(planted))
    assert native._cache_dir() is None
    assert native.load() is None and not native.available()
    data = _salted(256, 10)
    np.testing.assert_array_equal(batch_from_mapping(data), jbatch(data))
    assert list(planted.iterdir()) == []


@pytest.mark.parametrize("plant", ["private", "group_writable", "symlink"])
def test_a_planted_library_in_the_override_is_refused(fresh, monkeypatch,
                                                      tmp_path, plant):
    """A working library planted under the name a build would give is
    loaded only when it is a private file of ours: a group-writable
    file or a symlink is refused before ``ctypes`` sees it, and nothing
    is rebuilt over it."""
    built = native.load()._name           # the per-user cache's build
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    cache = tmp_path / "override"
    cache.mkdir(mode=0o700)
    with open(native._SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = cache / f"fastfeat-{tag}.so"
    if plant == "symlink":
        lib.symlink_to(built)
    else:
        shutil.copyfile(built, lib)
        lib.chmod(0o700 if plant == "private" else 0o775)
    monkeypatch.setenv("ROUTEST_NATIVE_CACHE", str(cache))
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: pytest.fail("rebuilt"))
    assert native.available() == (plant == "private")


def test_routest_native_0_forces_numpy(fresh, monkeypatch, tmp_path):
    monkeypatch.setenv("ROUTEST_NATIVE", "0")
    monkeypatch.setattr(native, "_build", lambda: pytest.fail("built"))
    assert native.load() is None and not native.available()
    data = _salted(256, 9)
    np.testing.assert_array_equal(batch_from_mapping(data), jbatch(data))
    path = str(tmp_path / "d.csv")
    csv_io.save_csv(path, generate_dataset(50, seed=9))
    _same(csv_io.load_csv(path), jcsv.load_csv(path))


def test_the_cache_prefix_is_the_ports_own(fresh, monkeypatch, tmp_path):
    """The two packages never load each other's build: separate cache
    directories, ``RTLD_LOCAL`` loads, and the port binds ABI 2."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert os.path.basename(native._cache_dir()) == \
        f"routest_tpu_torch_native_{os.getuid()}"
    assert native._cache_dir() != jnative._cache_dir()
    monkeypatch.setenv("ROUTEST_NATIVE_CACHE", str(tmp_path / "ops"))
    assert native._cache_dir() == str(tmp_path / "ops")
    monkeypatch.undo()
    assert native.load().ff_abi_version() == 2


def test_fastfeat_cpp_is_the_jax_packages_byte_for_byte():
    def sha(module):
        with open(os.path.join(os.path.dirname(module.__file__),
                               "fastfeat.cpp"), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(native) == sha(jnative)


def test_the_request_path_goes_through_native(monkeypatch):
    """The serving path's encoder (``encode_requests`` →
    ``batch_from_mapping``) reaches the C encoder and gives the JAX
    package's bytes."""
    from routest_tpu.data.features import encode_requests as jencode

    args = (["Sunny", "Fog", "Stormy"], ["Low", "High", "Gridlock"],
            [0, 3, 6], [0, 12, 23], [1.0, 12.5, 300.0], [18, 40, 71])
    calls = []
    encode = native.encode_batch
    monkeypatch.setattr(native, "encode_batch",
                        lambda *a: calls.append(1) or encode(*a))
    rows = features.encode_requests(*args)
    assert calls == [1] and rows.dtype == np.float32
    np.testing.assert_array_equal(rows, jencode(*args))
