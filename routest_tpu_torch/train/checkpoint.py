"""Artifact IO: the ``RTPU1`` serving artifacts, read and written
without flax, and the port's training checkpoints.

The artifact the JAX package writes (``routest_tpu/train/checkpoint.py``
``save_model``) is ``MAGIC`` + one JSON header line + the params pytree
serialized by flax's msgpack. flax writes each array as msgpack ext
type 1 whose payload is itself msgpack ``(shape, dtype_name, C-order
bytes)``, lists as msgpack arrays, and dict keys in sorted order (its
pytree copy rebuilds dicts that way). The machine with the card has
neither flax nor the ``msgpack`` package, so this module carries a small
msgpack decoder (:func:`_unpackb`) and encoder (:func:`_packb`) of its
own: the reader rebuilds the arrays bit for bit, and the writers
(:func:`save_model`, :func:`save_gnn`, :func:`save_transformer`) produce
the JAX writers' bytes for the same params and header.

Training checkpoints (:func:`save_checkpoint`) are the port's own
format, since Orbax is not on the card's machine: one ``step_%08d.pt``
file per checkpoint, written by ``torch.save`` to a temp file and
renamed, read back with ``torch.load(weights_only=True)``. A JAX Orbax
checkpoint directory is not read.

The ``torch.export`` scoring artifact (:func:`export_serving_fn`) is the
counterpart of the JAX package's StableHLO export: ``TORCH_EXPORT_MAGIC``
+ one JSON header line + the bytes of ``torch.export.save`` of the
plain ``EtaMLP`` forward with the weights inside the program and a
symbolic batch dimension. The JAX export (``RTPUX1``) is refused by
name: it needs the JAX package to run.

Error texts for bad magic, format and version are the JAX package's,
word for word.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = b"RTPU1\n"
ARTIFACT_VERSION = 2
QUANTILE_ARTIFACT_VERSION = 3

Params = Dict

# flax/serialization.py ``_MsgpackExtType``.
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_ext(data: bytes) -> np.ndarray:
    """flax's ext payload → a numpy array with the stored bytes. bfloat16
    leaves (numpy has no such dtype) widen exactly to float32."""
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape, order="C")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(
        shape, order="C")


class _Reader:
    """Cursor over one msgpack buffer (the subset of the spec an
    ``RTPU1`` artifact can contain is all of it but timestamps)."""

    __slots__ = ("buf", "pos", "raw")

    def __init__(self, buf: bytes, raw: bool) -> None:
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = bytes(self.buf[self.pos:end])
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        data = self._take(n)
        return data if self.raw else data.decode("utf-8")

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_ext(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_ext(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if 0xC4 <= b <= 0xC6:                       # bin 8/16/32
            return self._take(self._unpack(">" + "BHI"[b - 0xC4]))
        if 0xC7 <= b <= 0xC9:                       # ext 8/16/32
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self._unpack(">b"), n)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xCF:                       # uint 8/16/32/64
            return self._unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:                       # int 8/16/32/64
            return self._unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:                       # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                       # str 8/16/32
            return self._str(self._unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object (``msgpack.unpackb`` with flax's ext
    hook). ``raw=True`` keeps str payloads as bytes, as flax's inner
    ndarray decode does."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack data")
    return out


# (type byte, struct format, bound) of each integer form, smallest first.
_UINT_FORMS = ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64))
_INT_FORMS = ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63))


def _pack_into(obj: Any, out: bytearray) -> None:
    """msgpack-python's encoding (``use_bin_type=True``, smallest integer
    form, floats as float64) of the types an artifact holds."""
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif obj >= -32 and obj < 0:
            out.append(obj & 0xFF)
        else:
            forms = _UINT_FORMS if obj >= 0 else _INT_FORMS
            for tag, fmt, limit in forms:
                if -limit <= obj < limit:
                    out += bytes([tag]) + struct.pack(fmt, obj)
                    break
            else:
                raise ValueError(f"integer {obj} does not fit msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, dict):
        # flax's pytree copy rebuilds every dict in sorted key order
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key in sorted(obj):
            _pack_into(key, out)
            _pack_into(obj[key], out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_ext(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_ext(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_limit: int,
              tags) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-,
    16- or 32-bit form (``None`` where the type has no such form)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            out += bytes([tag]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_to_ext(arr: np.ndarray) -> bytes:
    """flax's ndarray ext payload: msgpack ``(shape, dtype name, C-order
    bytes)``."""
    return _packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _packb(obj: Any) -> bytes:
    """Encode one object as flax's ``msgpack_serialize`` does."""
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


def _write_artifact(path: str, magic: bytes, header: dict,
                    blob: bytes) -> None:
    """Magic prefix + one-line JSON header + binary blob, written to a
    temp file and renamed: hot-reload watchers (the ETA service's and
    the road router's) stat these paths on live traffic, so a reader
    never sees a half-written file. The temp name carries the pid and
    the thread id, so two writers in one process never share it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(magic)
            f.write(json.dumps(header).encode() + b"\n")
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"`` (numpy's name, as the JAX
    headers record it)."""
    return str(dtype).rsplit(".", 1)[-1]


def _read_artifact(path: str, magic: bytes, fmt: str, versions,
                   kind: str, retrain_hint: str):
    """Magic prefix + one-line JSON header + binary blob, with
    format/version validation → (header, blob). Same error contract as
    the JAX package's reader."""
    with open(path, "rb") as f:
        if f.read(len(magic)) != magic:
            raise ValueError(f"{path}: not a {kind}")
        header = json.loads(f.readline().decode())
        blob = f.read()
    if header.get("format") != fmt:
        raise ValueError(f"{path}: unknown artifact format "
                         f"{header.get('format')}")
    if header.get("version") not in versions:
        expected = "/".join(f"v{v}" for v in versions)
        raise ValueError(
            f"{path}: artifact version {header.get('version')} is "
            f"incompatible (expects {expected}); {retrain_hint}")
    return header, blob


def read_params(path: str) -> Tuple[dict, Params]:
    """→ (header, params): the artifact's header dict and its params
    pytree as host numpy arrays (``params["layers"]`` a list of
    ``{"w", "b"}``, ``params["norm"]`` ``{"mean", "std"}``)."""
    header, blob = _read_artifact(
        path, MAGIC, "routest_tpu.eta_mlp",
        (ARTIFACT_VERSION, QUANTILE_ARTIFACT_VERSION),
        kind="routest_tpu model artifact",
        retrain_hint="retrain via scripts/train_eta.py")
    if header.get("version") == QUANTILE_ARTIFACT_VERSION \
            and not header.get("quantiles"):
        raise ValueError(f"{path}: v{QUANTILE_ARTIFACT_VERSION} artifact "
                         f"missing its quantiles header")
    return header, _unpackb(blob)


def load_model(path: str):
    """→ (EtaMLP module on the CPU, params numpy pytree). The module is
    built from the params by the weight carry-over
    (``EtaMLP.from_numpy``) with the policy the header records."""
    import dataclasses

    import torch

    from routest_tpu_torch.core.dtypes import DEFAULT_POLICY
    from routest_tpu_torch.models.eta_mlp import EtaMLP

    header, params = read_params(path)
    compute = getattr(torch, header.get("compute_dtype", "bfloat16"))
    policy = dataclasses.replace(DEFAULT_POLICY, compute_dtype=compute)
    model = EtaMLP.from_numpy(params, hidden=tuple(header["hidden"]),
                              quantiles=tuple(header.get("quantiles", ())),
                              policy=policy)
    return model, params


def save_model(path: str, model) -> None:
    """Serving artifact of an ``EtaMLP`` module: the JAX ``save_model``'s
    bytes for the same params (header v2 for point models, v3 with
    ``quantiles``; ``compute_dtype`` recorded)."""
    header = {
        "format": "routest_tpu.eta_mlp",
        "version": ARTIFACT_VERSION,
        "hidden": list(model.hidden),
        "n_features": model.n_features,
        "compute_dtype": _dtype_name(model.policy.compute_dtype),
    }
    if model.quantiles:
        header["version"] = QUANTILE_ARTIFACT_VERSION
        header["quantiles"] = list(model.quantiles)
    _write_artifact(path, MAGIC, header, _packb(model.to_numpy()))


TORCH_EXPORT_MAGIC = b"RTPUT1\n"
TORCH_EXPORT_VERSION = 1
TORCH_EXPORT_FORMAT = "routest_tpu_torch.eta_torch_export"
# The JAX package's StableHLO export: recognised only to refuse it.
JAX_EXPORT_MAGIC = b"RTPUX1\n"
# The largest batch the exported program accepts (the symbolic batch
# dimension's bound; serving buckets stay far below it).
_EXPORT_MAX_BATCH = 1 << 20


def export_serving_fn(path: str, model, device="cpu"):
    """``torch.export`` the serving forward of an ``EtaMLP`` module — the
    plain forward, ``forward`` for a point model and ``apply_quantiles``
    for a quantile model — with the weights as constants of the program
    and a symbolic batch dimension (1 … 2**20 rows), so one file serves
    every batch bucket. Traced on ``device`` at the module's policy; the
    example batch has 2 rows, since ``torch.export`` specializes sizes
    0 and 1. Layout: ``TORCH_EXPORT_MAGIC`` + JSON header (format,
    version, ``n_features``, ``quantiles``, ``hidden``, the torch
    version) + the ``torch.export.save`` bytes. Returns the
    ``ExportedProgram`` that was saved."""
    import io

    import torch
    from torch.export import Dim, export, save

    forward = _serving_forward(model).to(device).eval()
    example = torch.zeros((2, model.n_features), dtype=torch.float32,
                          device=device)
    batch = Dim("batch", min=1, max=_EXPORT_MAX_BATCH)
    with torch.no_grad():
        program = export(forward, (example,),
                         dynamic_shapes={"x": {0: batch}})
    buf = io.BytesIO()
    save(program, buf)
    _write_artifact(path, TORCH_EXPORT_MAGIC, {
        "format": TORCH_EXPORT_FORMAT,
        "version": TORCH_EXPORT_VERSION,
        "n_features": model.n_features,
        "quantiles": list(model.quantiles),
        "hidden": list(model.hidden),  # informational; not needed to run
        "compute_dtype": _dtype_name(model.policy.compute_dtype),
        "torch": torch.__version__,
    }, buf.getvalue())
    return program


def _torch_minor(version: str) -> str:
    return ".".join(version.split("+")[0].split(".")[:2])


def _serving_forward(model):
    """The point forward or the quantile forward of an ``EtaMLP``, as
    the one ``forward`` of a module that ``torch.export`` traces."""
    import torch

    class Forward(torch.nn.Module):
        def __init__(self, m) -> None:
            super().__init__()
            self.m = m

        def forward(self, x):
            return self.m.apply_quantiles(x) if self.m.quantiles \
                else self.m(x)

    return Forward(model)


class ExportedServingModel:
    """A loaded ``torch.export`` artifact, shaped like a model for the
    serving layer: ``n_features`` / ``quantiles`` / ``hidden`` + a call
    on a (B, n_features) float32 tensor on the device it was loaded
    onto."""

    def __init__(self, program, header: dict) -> None:
        self._call = program.module()
        self.header = header
        self.n_features = int(header["n_features"])
        self.quantiles = tuple(header.get("quantiles", ()))
        self.hidden = tuple(header.get("hidden", ()))

    def __call__(self, x):
        return self._call(x)


def load_exported_serving_fn(path: str, device="cpu") -> ExportedServingModel:
    """Load an :func:`export_serving_fn` artifact onto ``device``.
    Raises ValueError for wrong magic, format or version, for a JAX
    StableHLO export (it needs the JAX package), for an artifact written
    by another torch minor version (``.pt2`` bytes are not portable
    between them), and for a quantile export without the 0.5 median."""
    import io

    import torch
    from torch.export import load

    with open(path, "rb") as f:
        head = f.read(len(JAX_EXPORT_MAGIC))
    if head == JAX_EXPORT_MAGIC:
        raise ValueError(
            f"{path}: a JAX StableHLO export (RTPUX1) needs the JAX "
            f"package (routest_tpu) to run; export a torch.export "
            f"artifact with python -m routest_tpu_torch.train.export")
    header, blob = _read_artifact(
        path, TORCH_EXPORT_MAGIC, TORCH_EXPORT_FORMAT,
        (TORCH_EXPORT_VERSION,), kind="routest_tpu_torch torch.export "
        "artifact", retrain_hint="re-export via python -m "
        "routest_tpu_torch.train.export")
    written = str(header.get("torch", ""))
    if _torch_minor(written) != _torch_minor(torch.__version__):
        raise ValueError(
            f"{path}: exported by torch {written}, running torch "
            f"{torch.__version__}; re-export via python -m "
            f"routest_tpu_torch.train.export")
    # Same contract as EtaMLP's constructor: a quantile head must carry
    # the median, or every per-request ``q.index(0.5)`` would raise.
    quantiles = header.get("quantiles") or []
    if quantiles and 0.5 not in quantiles:
        raise ValueError(
            f"{path}: quantile export lacks the 0.5 median "
            f"(quantiles={quantiles}); serving requires it")
    program = load(io.BytesIO(blob))
    device = torch.device(device)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ExportedServingModel(program, header)


def default_model_path(cfg=None) -> str:
    """Resolution order: explicit ModelConfig.model_path (set from
    ETA_MODEL_PATH by ``load_config``), then the env var directly, then
    the in-repo artifact location."""
    if cfg is not None and getattr(cfg, "model_path", None):
        return cfg.model_path
    return os.getenv("ETA_MODEL_PATH") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "artifacts",
        "eta_mlp.msgpack",
    )


# ── Road-GNN and route-transformer serving artifacts ──────────────────────
#
# Same MAGIC + header + msgpack layout as the ETA artifact, other format
# tags. The header carries a fingerprint of the training graph (nodes
# and edges): the router serves a learned leg pricer only over the graph
# it was trained on, and falls back to free-flow physics otherwise.

GNN_ARTIFACT_VERSION = 1
TRANSFORMER_ARTIFACT_VERSION = 1


def graph_fingerprint(node_coords: np.ndarray, senders: np.ndarray,
                      receivers: np.ndarray, length_m: np.ndarray) -> dict:
    """Nodes AND edges, as the JAX package's ``graph_fingerprint``: the
    GNN's aggregation depends on the topology it was trained over."""
    import zlib

    def crc(a, dtype):
        return int(zlib.crc32(np.ascontiguousarray(
            np.asarray(a, dtype)).tobytes()))

    return {
        "n_nodes": int(np.asarray(node_coords).shape[0]),
        "coords_crc32": crc(node_coords, np.float32),
        "n_edges": int(len(senders)),
        "edges_crc32": crc(senders, np.int32) ^ crc(receivers, np.int32)
        ^ crc(length_m, np.float32),
    }


def save_gnn(path: str, model, graph: dict) -> None:
    """Road-GNN artifact of a ``RoadGNN`` module, fingerprinted by the
    graph it trained over: the JAX ``save_gnn``'s bytes."""
    _write_artifact(path, MAGIC, {
        "format": "routest_tpu.road_gnn",
        "version": GNN_ARTIFACT_VERSION,
        "hidden": int(model.hidden),
        "n_rounds": int(model.n_rounds),
        "n_nodes": int(model.n_nodes),
        "compute_dtype": _dtype_name(model.policy.compute_dtype),
        "graph": graph_fingerprint(
            graph["node_coords"], graph["senders"], graph["receivers"],
            graph["length_m"]),
    }, _packb(model.to_numpy()))


def save_transformer(path: str, model, graph: dict, seq_len: int) -> None:
    """Route-transformer artifact: the graph fingerprint, as for the
    GNN, and the trained ``seq_len`` (serving chunks longer tours into
    windows of it). The JAX ``save_transformer``'s bytes."""
    _write_artifact(path, MAGIC, {
        "format": "routest_tpu.route_transformer",
        "version": TRANSFORMER_ARTIFACT_VERSION,
        "d_model": int(model.d_model),
        "n_heads": int(model.n_heads),
        "n_layers": int(model.n_layers),
        "d_mlp": int(model.d_mlp),
        "seq_len": int(seq_len),
        "graph": graph_fingerprint(
            graph["node_coords"], graph["senders"], graph["receivers"],
            graph["length_m"]),
    }, _packb(model.to_numpy()))


def load_gnn(path: str):
    """→ (``RoadGNN`` module on the CPU, params numpy pytree, graph
    fingerprint dict). Same format/version/feature-count errors as the
    JAX ``load_gnn``."""
    import dataclasses

    import torch

    from routest_tpu_torch.core.dtypes import DEFAULT_POLICY
    from routest_tpu_torch.models.gnn import N_EDGE_FEATURES, RoadGNN

    header, blob = _read_artifact(
        path, MAGIC, "routest_tpu.road_gnn", (GNN_ARTIFACT_VERSION,),
        kind="routest_tpu model artifact",
        retrain_hint="retrain via scripts/train_gnn.py")
    params = _unpackb(blob)
    # Feature-ABI gate: the message MLP's input width pins the trained
    # edge-feature count.
    f_in = int(params["msg"][0]["w"].shape[0]) - 2 * int(header["hidden"])
    if f_in != N_EDGE_FEATURES:
        raise ValueError(
            f"{path}: trained with {f_in} edge features, this build uses "
            f"{N_EDGE_FEATURES}; retrain via scripts/train_gnn.py")
    compute = getattr(torch, header.get("compute_dtype", "bfloat16"))
    policy = dataclasses.replace(DEFAULT_POLICY, compute_dtype=compute)
    model = RoadGNN.from_numpy(params, n_nodes=header["n_nodes"],
                               hidden=header["hidden"],
                               n_rounds=header["n_rounds"], policy=policy)
    return model, params, header.get("graph") or {}


def load_transformer(path: str):
    """→ (``RouteTransformer`` module on the CPU, params numpy pytree,
    meta) where meta carries the graph fingerprint and the trained
    ``seq_len``."""
    from routest_tpu_torch.models.gnn import N_EDGE_FEATURES
    from routest_tpu_torch.models.route_transformer import RouteTransformer

    header, blob = _read_artifact(
        path, MAGIC, "routest_tpu.route_transformer",
        (TRANSFORMER_ARTIFACT_VERSION,),
        kind="routest_tpu model artifact",
        retrain_hint="retrain via scripts/train_transformer.py")
    params = _unpackb(blob)
    # Same feature-ABI gate as load_gnn: the embed matrix pins the
    # trained edge-feature count.
    f_in = int(params["embed"]["w"].shape[0])
    if f_in != N_EDGE_FEATURES:
        raise ValueError(
            f"{path}: trained with {f_in} edge features, this build uses "
            f"{N_EDGE_FEATURES}; retrain via scripts/train_transformer.py")
    model = RouteTransformer.from_numpy(
        params, d_model=header["d_model"], n_heads=header["n_heads"],
        n_layers=header["n_layers"], d_mlp=header["d_mlp"])
    return model, params, {"graph": header.get("graph") or {},
                           "seq_len": int(header.get("seq_len", 24))}


def _artifact(name: str) -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "artifacts", name)


def default_gnn_path() -> str:
    """``ROAD_GNN_PATH`` env override, then the in-repo artifact."""
    return os.getenv("ROAD_GNN_PATH") or _artifact("road_gnn.msgpack")


def default_transformer_path() -> str:
    """``ROUTE_TRANSFORMER_PATH`` env override, then the in-repo
    artifact."""
    return (os.getenv("ROUTE_TRANSFORMER_PATH")
            or _artifact("route_transformer.msgpack"))


# ── training checkpoints ──────────────────────────────────────────────────

_CKPT_SUFFIX = ".pt"


def save_checkpoint(ckpt_dir: str, step: int, state: dict) -> str:
    """Write ``state`` (params, optimizer state, step, epoch: tensors,
    ints and containers of them) as ``step_%08d.pt``, temp-then-rename,
    so a crash mid-save leaves no file under a complete name."""
    import torch

    path = os.path.join(os.path.abspath(ckpt_dir),
                        f"step_{step:08d}{_CKPT_SUFFIX}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """Newest complete checkpoint as ``(step, path)``: only files named
    ``step_<digits>.pt`` count, so temp files and Orbax directories
    (``step_N``, ``step_N.orbax-checkpoint-tmp-*``) are skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    best: Optional[Tuple[int, str]] = None
    for name in os.listdir(ckpt_dir):
        if not (name.startswith("step_") and name.endswith(_CKPT_SUFFIX)):
            continue
        digits = name[len("step_"):-len(_CKPT_SUFFIX)]
        full = os.path.join(ckpt_dir, name)
        if not digits.isdigit() or not os.path.isfile(full):
            continue
        if best is None or int(digits) > best[0]:
            best = (int(digits), full)
    return best


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    found = latest_checkpoint_step(ckpt_dir)
    return found[1] if found else None


def restore_checkpoint(path: str) -> dict:
    """A checkpoint's state dict, tensors on the CPU."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)
