"""Length-prefixed columnar binary wire format for the serving hot path.

A copy of ``routest_tpu/serve/wirecodec.py`` (numpy only): frames are
byte-identical between the two packages. Per-row Python serialization
is the JSON path's fixed cost on large batches; this format is a tiny
self-describing frame of contiguous typed blocks that a client encodes
with numpy and a replica decodes with ``np.frombuffer`` **views** —
zero per-row Python either direction, and zero copies on decode (the
arrays alias the request buffer; the only copy on the whole path is the
batcher's write into its staging slab).

Negotiated by content-type (``application/x-rtpu-wire``) on
``/api/predict_eta_batch`` and ``/api/matrix``; also the payload of the
persistent gateway→replica wire channel (``serve/wirechannel.py``).
The JSON path is untouched and stays bit-identical — the wire format is
an *additional* representation of the same answers.

Frame layout (all integers little-endian)::

    magic   4B   b"RTW1"
    kind    u8   frame kind (request/response/error, constants below)
    ncols   u16  column count
    then per column:
      name_len  u16
      name      UTF-8 bytes
      dtype     u8   0=f32  1=f64  2=i64  3=u8 (raw bytes, e.g. JSON meta)
      count     u64  element count
      payload   count * itemsize bytes

Columns are 1-D blocks; shape semantics (e.g. the (N, 12) feature
matrix) belong to the typed helpers, not the container. Every decode
is *loud*: truncation, bad magic, unknown dtype, trailing bytes, or a
frame over the ``RTPU_WIRE_MAX_FRAME_MB`` bound each raise
:class:`WireError` — a corrupt frame can never yield a silent partial
batch. Full contract: docs/API.md "Binary wire format".
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

MAGIC = b"RTW1"
WIRE_CONTENT_TYPE = "application/x-rtpu-wire"

# Frame kinds. Requests and responses are distinct so a frame is
# self-describing on a multiplexed channel (and a response replayed as
# a request fails loudly instead of decoding into garbage).
K_ETA_REQUEST = 1
K_ETA_RESPONSE = 2
K_MATRIX_REQUEST = 3
K_MATRIX_RESPONSE = 4
K_ERROR = 5

_HEADER = struct.Struct("<BH")      # kind, ncols (after the 4B magic)
_COL_NAME = struct.Struct("<H")     # name_len
_COL_HEAD = struct.Struct("<BQ")    # dtype code, element count

_DTYPE_BY_CODE = {
    0: np.dtype("<f4"),
    1: np.dtype("<f8"),
    2: np.dtype("<i8"),
    3: np.dtype("u1"),
}
_CODE_BY_DTYPE = {dt: code for code, dt in _DTYPE_BY_CODE.items()}

# int64 sentinel for "no completion time" (a NaN-minutes row): the
# int64 value numpy assigns NaT, so decode-side datetime64 views see
# NaT with no per-row branching.
COMPLETION_NAT = np.int64(np.iinfo(np.int64).min)

N_FEATURES = 12  # the ETA feature contract (data/features.py)


class WireError(ValueError):
    """Malformed, truncated, oversized, or type-invalid wire frame."""


Columns = Dict[str, Union[np.ndarray, memoryview]]


class Frame:
    """A decoded frame: ``columns`` are zero-copy views into the source
    buffer (``np.frombuffer`` for numeric blocks, ``memoryview`` for u8
    blocks); ``payload(name)`` returns the raw byte region of a column
    as an itemsize-1 memoryview — what the fastlane's ``blob=`` path
    hashes per-row cache keys from without re-serializing the array."""

    __slots__ = ("kind", "columns", "_spans", "_buf")

    def __init__(self, kind: int, columns: Columns,
                 spans: Dict[str, Tuple[int, int]], buf) -> None:
        self.kind = kind
        self.columns = columns
        self._spans = spans
        self._buf = buf

    def payload(self, name: str) -> memoryview:
        off, nbytes = self._spans[name]
        return memoryview(self._buf)[off:off + nbytes].cast("B")


def encode_frame(kind: int, columns: Mapping[str, object]) -> bytes:
    """Columns (ordered mapping of 1-D arrays / raw bytes) → frame
    bytes. Column order is preserved, so identical inputs produce
    byte-identical frames (the loadgen determinism contract rides on
    this)."""
    parts = [MAGIC, _HEADER.pack(kind, len(columns))]
    for name, block in columns.items():
        nb = name.encode("utf-8")
        if isinstance(block, (bytes, bytearray, memoryview)):
            payload = bytes(block)
            code, count = 3, len(payload)
        else:
            arr = np.asarray(block)
            if arr.ndim != 1:
                raise WireError(f"column {name!r} must be 1-D on the wire "
                                f"(got shape {arr.shape})")
            dt = arr.dtype.newbyteorder("<")
            if dt not in _CODE_BY_DTYPE:
                raise WireError(f"column {name!r}: unsupported dtype "
                                f"{arr.dtype}")
            code, count = _CODE_BY_DTYPE[dt], arr.size
            payload = np.ascontiguousarray(arr, dt).tobytes()
        parts.append(_COL_NAME.pack(len(nb)))
        parts.append(nb)
        parts.append(_COL_HEAD.pack(code, count))
        parts.append(payload)
    return b"".join(parts)


def decode_frame(buf, max_bytes: Optional[int] = None) -> Frame:
    """Frame bytes → :class:`Frame` of zero-copy views. Raises
    :class:`WireError` on any structural defect — never returns a
    partial batch."""
    total = len(buf)
    if max_bytes is not None and total > max_bytes:
        raise WireError(f"frame of {total} bytes exceeds the "
                        f"{max_bytes}-byte bound (RTPU_WIRE_MAX_FRAME_MB)")
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if total < 4 + _HEADER.size or bytes(mv[:4]) != MAGIC:
        raise WireError("not a wire frame (bad magic)")
    kind, ncols = _HEADER.unpack_from(mv, 4)
    off = 4 + _HEADER.size
    columns: Columns = {}
    spans: Dict[str, Tuple[int, int]] = {}
    for _ in range(ncols):
        if off + _COL_NAME.size > total:
            raise WireError("truncated frame (column name header)")
        (nlen,) = _COL_NAME.unpack_from(mv, off)
        off += _COL_NAME.size
        if off + nlen > total:
            raise WireError("truncated frame (column name)")
        try:
            name = bytes(mv[off:off + nlen]).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WireError(f"corrupt column name: {e}") from e
        off += nlen
        if off + _COL_HEAD.size > total:
            raise WireError("truncated frame (column header)")
        code, count = _COL_HEAD.unpack_from(mv, off)
        off += _COL_HEAD.size
        dt = _DTYPE_BY_CODE.get(code)
        if dt is None:
            raise WireError(f"column {name!r}: unknown dtype code {code}")
        nbytes = count * dt.itemsize
        if off + nbytes > total:
            raise WireError(f"truncated frame (column {name!r} payload: "
                            f"declared {nbytes} bytes, "
                            f"{total - off} remain)")
        if name in columns:
            raise WireError(f"duplicate column {name!r}")
        if code == 3:
            columns[name] = mv[off:off + nbytes]
        else:
            columns[name] = np.frombuffer(mv, dtype=dt, count=count,
                                          offset=off)
        spans[name] = (off, nbytes)
        off += nbytes
    if off != total:
        raise WireError(f"{total - off} trailing bytes after the last "
                        "column — refusing a frame that does not parse "
                        "exactly")
    return Frame(kind, columns, spans, buf)


def _require(frame: Frame, name: str, what: str) -> object:
    col = frame.columns.get(name)
    if col is None:
        raise WireError(f"{what} frame missing column {name!r}")
    return col


def _meta(frame: Frame, what: str) -> dict:
    raw = frame.columns.get("meta")
    if raw is None:
        return {}
    try:
        meta = json.loads(bytes(raw).decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"{what} frame meta is not JSON: {e}") from e
    if not isinstance(meta, dict):
        raise WireError(f"{what} frame meta must be a JSON object")
    return meta


# ── ETA batch ────────────────────────────────────────────────────────


def encode_eta_request(features: np.ndarray,
                       pickup_ms: np.ndarray) -> bytes:
    """(N, 12) float32 pre-encoded features + (N,) int64 pickup epoch
    milliseconds → request frame. Clients featurize with the SAME
    ``data/features.encode_requests`` the replica's JSON path uses, so
    both content-types feed the model bit-identical rows."""
    features = np.ascontiguousarray(features, np.float32)
    if features.ndim != 2 or features.shape[1] != N_FEATURES:
        raise WireError(f"features must be (N, {N_FEATURES}) float32, "
                        f"got shape {features.shape}")
    pickup_ms = np.ascontiguousarray(pickup_ms, np.int64)
    if pickup_ms.shape != (features.shape[0],):
        raise WireError("pickup_ms must be one int64 per feature row")
    return encode_frame(K_ETA_REQUEST, {
        "features": features.reshape(-1),
        "pickup_ms": pickup_ms,
    })


def decode_eta_request(buf, max_bytes: Optional[int] = None,
                       max_rows: Optional[int] = None) -> Frame:
    """→ Frame whose ``columns["features"]`` is reshaped to (N, 12)
    (still a view). Row-count bound is checked HERE, before any
    per-row work, mirroring the JSON path's O(1) cap check."""
    frame = decode_frame(buf, max_bytes=max_bytes)
    if frame.kind != K_ETA_REQUEST:
        raise WireError(f"expected ETA request frame, got kind {frame.kind}")
    feats = _require(frame, "features", "ETA request")
    pickup = _require(frame, "pickup_ms", "ETA request")
    if feats.size % N_FEATURES:
        raise WireError(f"features block of {feats.size} floats is not "
                        f"a whole number of {N_FEATURES}-feature rows")
    rows = feats.size // N_FEATURES
    if max_rows is not None and rows > max_rows:
        raise WireError(f"batch too large: {rows} rows (max {max_rows})")
    if pickup.size != rows:
        raise WireError(f"pickup_ms has {pickup.size} entries for "
                        f"{rows} feature rows")
    frame.columns["features"] = feats.reshape(rows, N_FEATURES)
    return frame


def encode_eta_response(minutes: np.ndarray, completion_ms: np.ndarray,
                        bands: Mapping[str, np.ndarray]) -> bytes:
    """Full-precision float64 minutes + int64 completion epoch-ms
    (``COMPLETION_NAT`` for NaN rows) + quantile band columns
    (``band:<label>``). Band order is sorted for byte-stability."""
    cols = {
        "minutes": np.ascontiguousarray(minutes, np.float64),
        "completion_ms": np.ascontiguousarray(completion_ms, np.int64),
    }
    for label in sorted(bands):
        cols[f"band:{label}"] = np.ascontiguousarray(bands[label],
                                                     np.float64)
    return encode_frame(K_ETA_RESPONSE, cols)


def decode_eta_response(buf, max_bytes: Optional[int] = None) -> dict:
    """→ ``{"minutes", "completion_ms", "bands": {label: array}}``
    (zero-copy views)."""
    frame = decode_frame(buf, max_bytes=max_bytes)
    if frame.kind == K_ERROR:
        status, message = decode_error_frame_obj(frame)
        raise WireError(f"upstream wire error {status}: {message}")
    if frame.kind != K_ETA_RESPONSE:
        raise WireError(f"expected ETA response frame, got kind "
                        f"{frame.kind}")
    minutes = _require(frame, "minutes", "ETA response")
    completion = _require(frame, "completion_ms", "ETA response")
    if completion.size != minutes.size:
        raise WireError("completion_ms/minutes length mismatch")
    bands = {}
    for name, col in frame.columns.items():
        if name.startswith("band:"):
            if col.size != minutes.size:
                raise WireError(f"band column {name!r} length mismatch")
            bands[name[len("band:"):]] = col
    return {"minutes": minutes, "completion_ms": completion,
            "bands": bands}


# ── travel matrix ────────────────────────────────────────────────────


def encode_matrix_request(points_latlon: np.ndarray,
                          options: Optional[dict] = None) -> bytes:
    """(N, 2) lat/lon float64 columns + JSON meta for the sparse
    options (sources/destinations/vehicle_type/road_graph/pickup_time
    — O(1) fields, not per-row data)."""
    pts = np.ascontiguousarray(points_latlon, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise WireError(f"points must be (N, 2) lat/lon, got {pts.shape}")
    cols = {"lat": pts[:, 0].copy(), "lon": pts[:, 1].copy()}
    if options:
        cols["meta"] = json.dumps(options, sort_keys=True,
                                  separators=(",", ":")).encode("utf-8")
    return encode_frame(K_MATRIX_REQUEST, cols)


def decode_matrix_request(buf, max_bytes: Optional[int] = None) -> dict:
    """→ the exact dict :func:`optimize.engine.travel_matrix` takes, so
    the wire path and JSON path share one compute implementation."""
    frame = decode_frame(buf, max_bytes=max_bytes)
    if frame.kind != K_MATRIX_REQUEST:
        raise WireError(f"expected matrix request frame, got kind "
                        f"{frame.kind}")
    lat = _require(frame, "lat", "matrix request")
    lon = _require(frame, "lon", "matrix request")
    if lat.size != lon.size:
        raise WireError("lat/lon length mismatch")
    body = dict(_meta(frame, "matrix request"))
    body["points"] = [{"lat": float(a), "lon": float(o)}
                      for a, o in zip(lat, lon)]
    return body


def encode_matrix_response(result: dict) -> bytes:
    """``travel_matrix``'s result dict → response frame: durations_s /
    distances_m flattened to float64 (``None`` → NaN), everything else
    in JSON meta with the (S, D) shape. Values are already rounded by
    ``travel_matrix``, so float64 carries them exactly and the JSON
    reconstruction is bitwise."""
    dur = result["durations_s"]
    dist = result["distances_m"]
    shape = [len(dur), len(dur[0]) if dur else 0]

    def _flat(rows):
        out = np.empty(shape[0] * shape[1], np.float64)
        k = 0
        for row in rows:
            for v in row:
                out[k] = np.nan if v is None else v
                k += 1
        return out

    meta = {k: v for k, v in result.items()
            if k not in ("durations_s", "distances_m")}
    meta["shape"] = shape
    return encode_frame(K_MATRIX_RESPONSE, {
        "durations_s": _flat(dur),
        "distances_m": _flat(dist),
        "meta": json.dumps(meta, sort_keys=True,
                           separators=(",", ":")).encode("utf-8"),
    })


def decode_matrix_response(buf, max_bytes: Optional[int] = None) -> dict:
    """→ the exact JSON-path result dict (NaN → None), for parity
    checks and wire-speaking clients that want the familiar shape."""
    frame = decode_frame(buf, max_bytes=max_bytes)
    if frame.kind == K_ERROR:
        status, message = decode_error_frame_obj(frame)
        raise WireError(f"upstream wire error {status}: {message}")
    if frame.kind != K_MATRIX_RESPONSE:
        raise WireError(f"expected matrix response frame, got kind "
                        f"{frame.kind}")
    meta = _meta(frame, "matrix response")
    shape = meta.pop("shape", None)
    if (not isinstance(shape, list) or len(shape) != 2
            or any(not isinstance(s, int) or s < 0 for s in shape)):
        raise WireError("matrix response meta missing a valid shape")
    s, d = shape
    dur = _require(frame, "durations_s", "matrix response")
    dist = _require(frame, "distances_m", "matrix response")
    if dur.size != s * d or dist.size != s * d:
        raise WireError(f"matrix payload does not match shape {shape}")

    def _rows(flat):
        return [[None if not np.isfinite(v) else float(v)
                 for v in flat[i * d:(i + 1) * d]] for i in range(s)]

    out = dict(meta)
    out["durations_s"] = _rows(dur)
    out["distances_m"] = _rows(dist)
    return out


# ── error frames ─────────────────────────────────────────────────────


def encode_error_frame(status: int, message: str) -> bytes:
    """Errors on the wire path are frames too (same content-type both
    ways); the HTTP status is ALSO set on the response so non-wire
    middleboxes and the gateway's breaker accounting see it."""
    return encode_frame(K_ERROR, {
        "meta": json.dumps({"status": int(status), "error": str(message)},
                           sort_keys=True,
                           separators=(",", ":")).encode("utf-8"),
    })


def decode_error_frame_obj(frame: Frame) -> Tuple[int, str]:
    meta = _meta(frame, "error")
    return int(meta.get("status", 500)), str(meta.get("error", ""))


def decode_error_frame(buf, max_bytes: Optional[int] = None
                       ) -> Tuple[int, str]:
    frame = decode_frame(buf, max_bytes=max_bytes)
    if frame.kind != K_ERROR:
        raise WireError(f"expected error frame, got kind {frame.kind}")
    return decode_error_frame_obj(frame)
