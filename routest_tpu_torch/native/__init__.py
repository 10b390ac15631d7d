"""ctypes bindings for the native data-plane library (``fastfeat.cpp``).

The counterpart of ``routest_tpu/native``: the same C++ source, byte for
byte (a test holds the two files' SHA-256 equal), and the same bindings.
``load()`` compiles the shared library with ``g++`` at first use into a
content-addressed per-user cache (``utils/paths.secure_user_cache_dir``
under the prefix ``routest_tpu_torch_native``, so the two packages never
load each other's build; ``ROUTEST_NATIVE_CACHE`` names another
directory, an operator's explicit choice, held to the same checks) and
binds the C ABI (``ff_abi_version() == 2``). ``ROUTEST_NATIVE=0``
forces numpy.

This is host code with exact numpy and ElementTree twins, as in the JAX
package: ``load()`` returns None when no toolchain is available or the
cache directory or a library in it is not trustworthy, and callers take those twins. It
launches nothing on the card, so that fallback hides no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastfeat.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> Optional[str]:
    """Per-user 0700 cache dir. The .so path must not be forgeable by
    another local user (a planted library would be dlopen'd into this
    process), so anything not owned by us / group- or world-writable is
    rejected (shared policy: ``utils/paths.untrusted_reason``).
    ROUTEST_NATIVE_CACHE overrides (explicit operator choice), under
    the same policy."""
    from routest_tpu_torch.utils.paths import (secure_user_cache_dir,
                                               untrusted_reason)

    base = os.environ.get("ROUTEST_NATIVE_CACHE")
    if base:
        try:
            os.makedirs(base, mode=0o700, exist_ok=True)
            if untrusted_reason(base, want_dir=True) is None:
                return base
        except OSError:
            pass
        return None  # unusable or untrusted override: numpy, not a crash
    return secure_user_cache_dir("routest_tpu_torch_native")


def _trusted_library(path: str) -> bool:
    """``path`` is a regular file of ours that nobody else can write
    (``utils/paths.untrusted_reason``)."""
    from routest_tpu_torch.utils.paths import untrusted_reason

    try:
        return untrusted_reason(path, want_dir=False) is None
    except OSError:
        return False


def _build() -> Optional[str]:
    cache = _cache_dir()
    if cache is None:
        return None
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(cache, f"fastfeat-{tag}.so")
    if os.path.lexists(out):
        return out if _trusted_library(out) else None
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.chmod(tmp, 0o700)  # whatever the umask gave g++'s output
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
        return out
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it if needed; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ROUTEST_NATIVE") == "0":
            return None
        path = _build()
        # checked again just before the load
        if path is None or not _trusted_library(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.ff_abi_version.restype = ctypes.c_int
        lib.ff_encode_batch.argtypes = [
            i32p, i32p, i32p, i32p, f32p, f32p, ctypes.c_int64, f32p]
        lib.ff_count_rows.argtypes = [ctypes.c_char_p]
        lib.ff_count_rows.restype = ctypes.c_int64
        lib.ff_parse_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64,
            i32p, i32p, i32p, i32p, f32p, f32p, f32p,
            ctypes.POINTER(ctypes.c_int64)]
        lib.ff_parse_csv.restype = ctypes.c_int64
        lib.ff_osm_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
        lib.ff_osm_parse.restype = ctypes.POINTER(_FfOsmResult)
        lib.ff_osm_free.argtypes = [ctypes.POINTER(_FfOsmResult)]
        if lib.ff_abi_version() != 2:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def encode_batch(weather_idx: np.ndarray, traffic_idx: np.ndarray,
                 weekday: np.ndarray, hour: np.ndarray,
                 distance_km: np.ndarray, driver_age: np.ndarray) -> np.ndarray:
    """Native 12-feature encode; caller guarantees ``available()``."""
    lib = load()
    assert lib is not None, "native library unavailable"
    n = len(weather_idx)
    out = np.empty((n, 12), np.float32)
    lib.ff_encode_batch(
        np.ascontiguousarray(weather_idx, np.int32),
        np.ascontiguousarray(traffic_idx, np.int32),
        np.ascontiguousarray(weekday, np.int32),
        np.ascontiguousarray(hour, np.int32),
        np.ascontiguousarray(distance_km, np.float32),
        np.ascontiguousarray(driver_age, np.float32),
        n, out)
    return out


class _FfOsmResult(ctypes.Structure):
    _fields_ = [
        ("code", ctypes.c_int32),
        ("n_nodes", ctypes.c_int32),
        ("n_edges", ctypes.c_int64),
        ("lat", ctypes.POINTER(ctypes.c_double)),
        ("lon", ctypes.POINTER(ctypes.c_double)),
        ("senders", ctypes.POINTER(ctypes.c_int32)),
        ("receivers", ctypes.POINTER(ctypes.c_int32)),
        ("cls", ctypes.POINTER(ctypes.c_int32)),
        ("speed", ctypes.POINTER(ctypes.c_float)),
    ]


def parse_osm(buf: bytes, class_speed_mps) -> Optional[dict]:
    """Native OSM XML parse → partial road-graph dict (topology, classes,
    speeds; lengths are computed by the caller from coordinates, same as
    the Python path). Returns None when the parser reports ANY anomaly —
    the caller falls back to the ElementTree path, which owns both the
    slow-path semantics and the error messages. Caller guarantees
    ``available()``."""
    lib = load()
    assert lib is not None, "native library unavailable"
    speeds = np.ascontiguousarray(class_speed_mps, np.float32)
    assert len(speeds) == 3
    ptr = lib.ff_osm_parse(buf, len(buf), speeds)
    if not ptr:
        return None
    try:
        r = ptr.contents
        if r.code != 0 or r.n_edges == 0:
            return None
        n, e = int(r.n_nodes), int(r.n_edges)
        lat = np.ctypeslib.as_array(r.lat, (n,)).copy()
        lon = np.ctypeslib.as_array(r.lon, (n,)).copy()
        out = {
            "node_coords": np.stack([lat, lon], axis=1).astype(np.float32),
            "senders": np.ctypeslib.as_array(r.senders, (e,)).copy(),
            "receivers": np.ctypeslib.as_array(r.receivers, (e,)).copy(),
            "road_class": np.ctypeslib.as_array(r.cls, (e,)).copy(),
            "speed_limit": np.ctypeslib.as_array(r.speed, (e,)).copy(),
        }
        return out
    finally:
        lib.ff_osm_free(ptr)


def _pack_vocab(vocab) -> bytes:
    return b"".join(v.encode() + b"\0" for v in vocab)


def parse_csv(path: str, weather_vocab, traffic_vocab):
    """Native CSV ingest → dataset-dict columns. Caller guarantees
    ``available()``. Raises ValueError with the offending line on
    malformed rows (same contract as the Python fallback)."""
    lib = load()
    assert lib is not None, "native library unavailable"
    cap = lib.ff_count_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    cols = {
        "weather_idx": np.empty(cap, np.int32),
        "traffic_idx": np.empty(cap, np.int32),
        "weekday": np.empty(cap, np.int32),
        "hour": np.empty(cap, np.int32),
        "distance_km": np.empty(cap, np.float32),
        "driver_age": np.empty(cap, np.float32),
        "eta_minutes": np.empty(cap, np.float32),
    }
    err_line = ctypes.c_int64(0)
    n = lib.ff_parse_csv(
        path.encode(),
        _pack_vocab(weather_vocab), len(weather_vocab),
        _pack_vocab(traffic_vocab), len(traffic_vocab),
        cap,
        cols["weather_idx"], cols["traffic_idx"], cols["weekday"],
        cols["hour"], cols["distance_km"], cols["driver_age"],
        cols["eta_minutes"], ctypes.byref(err_line))
    if n == -1:
        raise FileNotFoundError(path)
    if n == -2:
        raise ValueError(f"{path}:{err_line.value}: expected 7 fields")
    if n == -4:
        raise ValueError(f"{path}:{err_line.value}: line exceeds 4094 bytes")
    if n == -3:
        raise ValueError(f"{path}:{err_line.value}: non-numeric field")
    return {k: v[:n] for k, v in cols.items()}
