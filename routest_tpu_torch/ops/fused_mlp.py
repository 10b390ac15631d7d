"""Fused ETA-MLP inference: one CUDA kernel for the whole forward.

Replaces the TPU kernel ``routest_tpu/ops/fused_mlp.py::fused_eta_forward``
(the Pallas ``pallas_call`` at :366, body ``_kernel`` :214). One launch
takes the raw (B, 12) ABI rows and returns (B,) point ETA minutes or
(B, n_q) non-crossing quantile minutes: feature expansion (weather and
traffic copied, weekday/hour one-hots, distance clamped at 0, log1p
distance, age; the training normalizer folded into layer 0 at pack
time), the matmul chain with f32 accumulation and tanh-GELU between
layers, and the epilogue, with no intermediate touching device memory.

**Variants** (``RTPU_KERNEL_DTYPE``, as in the JAX package): ``bf16``
(default) and ``int8`` run on the tensor cores (``mma.sync``, with weight
slabs streamed through shared memory by TMA bulk copies; int8 weights
are quantized per output column at pack time and dequantized on chip to
bf16 before the product); ``f32`` is the parity/debug variant and runs
on the CUDA cores. What bounds each, and what the design does about it,
is in the header of ``csrc/fused_eta.cu``.

**Layout.** The TPU kernel pads everything to 128 lanes; this one keeps
the JAX lane order for expanded rows 0–66 (``_CAT`` 0–7, ``_WD`` 8–39,
``_HR`` 40–63, ``_DIST`` 64, ``_LOGD`` 65, ``_AGE`` 66) — so the packed
layer 0 compares row by row with the JAX packing — pads layer-0 K to
:data:`K0` = 80 and every other width to a multiple of :data:`PAD` = 16
(the tensor cores' tile). Padding rows and columns are zero (int8 scale
1), so they are exact no-ops through GELU.

**Numerics.** As in ``_kernel`` :265-277: int8 weights dequantize to
``bf16_rn(float(q) * s)``; operands in the compute dtype (bf16 for bf16
and int8, f32 for f32), products accumulated in f32, bias added and GELU
applied in f32, then rounded to the compute dtype. The epilogue is f32
with a stable softplus and a sequential cumulative sum over the
quantiles.

Beside the kernel, :func:`fused_eta_forward_plain` computes the same
function on the same packing in plain PyTorch. The wrapper
:func:`fused_eta_forward` takes it only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from routest_tpu_torch.data.features import N_FEATURES

# Expanded-row lanes, in the JAX kernel's order (routest_tpu/ops/
# fused_mlp.py:103-109); rows 67..K0-1 of packed layer 0 are zero.
_CAT = (0, 8)        # weather(4) + traffic(4), copied straight from x
_WD = (8, 40)        # weekday one-hot, lane 8+w
_HR = (40, 64)       # hour one-hot, lane 40+h
_DIST = 64           # raw distance_km (normalizer folded into weights)
_LOGD = 65           # log1p(distance_km)
_AGE = 66            # raw driver_age (normalizer folded into weights)
K0 = 80              # layer-0 K: lane 66 rounded up to a multiple of 16
PAD = 16             # every other K and N: a multiple of the mma tile

# EtaMLP._expand's row order in the trained layer-0 weight matrix.
_ROW_CAT = (0, 8)
_ROW_WD = (8, 15)
_ROW_HR = (15, 39)
_ROW_DIST, _ROW_LOGD, _ROW_AGE = 39, 40, 41

# Kernel limits and shared-memory layout, mirrored from csrc/fused_eta.cu.
_MAX_LAYERS = 8
_MAX_Q = 16
_SLAB_ROWS = 64      # tensor-core kernel: K rows of one weight slab
_STAGES = 3          # slabs in the cp.async ring
_PASS_COLS = 256     # output columns one pass accumulates
_LDW = _PASS_COLS + 8   # widest slab row: bf16 elements
_LDQ = _PASS_COLS + 16  # widest slab row: int8 bytes
_TILE_F32 = 32       # CUDA-core kernel: rows per block
_TILES = (16, 32)    # tensor-core kernel: rows per block it is built for
_MAX_SMEM = 232_448  # H100: dynamic shared memory one block may use

# C entry's variant codes.
_VARIANT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# "w", "b" (and for int8 "scale"): tuples of tensors; "n_heads": int;
# on the card, "launch": the kernel's arguments (:class:`_Launch`). A
# packing is immutable: its tensors are not edited in place and its
# entries not replaced — on the card the tensor-core kernel reads the
# copy of the weights made when it was packed (the slab stream).
Packed = Dict[str, object]

_DTYPE_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f32": "float32", "fp32": "float32", "float32": "float32",
    "int8": "int8",
}


def resolve_kernel_dtype(model=None, dtype=None) -> str:
    """Canonical kernel compute-dtype name: explicit ``dtype`` arg, then
    ``RTPU_KERNEL_DTYPE``, then the model policy's compute dtype. An
    unknown name raises."""
    raw = dtype or os.environ.get("RTPU_KERNEL_DTYPE")
    if not raw:
        if model is not None:
            raw = str(model.policy.compute_dtype).replace("torch.", "")
        else:
            raw = "bfloat16"
    name = _DTYPE_ALIASES.get(str(raw).strip().lower())
    if name is None:
        raise ValueError(
            f"RTPU_KERNEL_DTYPE={raw!r} is not a kernel variant "
            f"(choose from bf16 / f32 / int8)")
    return name


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_eta_params(model, params, dtype: str = None,
                    device="cpu") -> Packed:
    """EtaMLP params (numpy pytree) → the kernel's weights on ``device``.

    Layer 0 is re-rowed to the expanded lane layout with the normalizer
    folded in: ``(d - mean)/std`` feeding a linear layer is the same as
    scaling the weight row by ``1/std`` and shifting the bias by
    ``-mean/std · row``. The arithmetic is the JAX ``pack_eta_params``'s
    (same numpy ops, same order), so rows 0–66 and the real columns
    equal it bit for bit — int8 values and scales included: the extra
    zero rows and columns of either padding change no column maximum.

    Weights are stored (K, N) row-major, in the compute dtype or, for
    int8, quantized per output column (``s = max|col|/127``, 1 for an
    all-zero column) with the f32 scales under ``"scale"``; biases are
    always f32 — they add into the f32 accumulator. ``"n_heads"`` keeps
    the last layer's width before padding. On a CUDA device the kernel's
    arguments are built here, once, under ``"launch"``; a packing the
    kernel cannot take raises there.
    """
    variant = resolve_kernel_dtype(model, dtype)
    compute = torch.float32 if variant == "float32" else torch.bfloat16
    norm = params["norm"]
    mean = np.asarray(norm["mean"], np.float32)
    std = np.asarray(norm["std"], np.float32)
    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    scales: List[torch.Tensor] = []
    for i, layer in enumerate(params["layers"]):
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        d_in, d_out = w.shape
        n = _round_up(d_out, PAD)
        bp = np.zeros(n, np.float32)
        if i == 0:
            wp = np.zeros((K0, n), np.float32)
            wp[_CAT[0]:_CAT[1], :d_out] = w[_ROW_CAT[0]:_ROW_CAT[1]]
            wp[_WD[0]:_WD[0] + (_ROW_WD[1] - _ROW_WD[0]), :d_out] = \
                w[_ROW_WD[0]:_ROW_WD[1]]
            wp[_HR[0]:_HR[0] + (_ROW_HR[1] - _ROW_HR[0]), :d_out] = \
                w[_ROW_HR[0]:_ROW_HR[1]]
            wp[_DIST, :d_out] = w[_ROW_DIST] / std[10]
            wp[_LOGD, :d_out] = w[_ROW_LOGD]
            wp[_AGE, :d_out] = w[_ROW_AGE] / std[11]
            bp[:d_out] = (b - (mean[10] / std[10]) * w[_ROW_DIST]
                          - (mean[11] / std[11]) * w[_ROW_AGE])
        else:
            wp = np.zeros((_round_up(d_in, PAD), n), np.float32)
            wp[:d_in, :d_out] = w
            bp[:d_out] = b
        if variant == "int8":
            s = np.abs(wp).max(axis=0) / 127.0
            s[s < 1e-12] = 1.0  # all-zero (padding) columns: exact zeros
            ws.append(torch.from_numpy(np.rint(wp / s).astype(np.int8))
                      .to(device))
            scales.append(torch.from_numpy(s).to(device))
        else:
            ws.append(torch.from_numpy(wp).to(device=device, dtype=compute))
        bs.append(torch.from_numpy(bp).to(device))
    packed: Packed = {"w": tuple(ws), "b": tuple(bs),
                      "n_heads": int(params["layers"][-1]["w"].shape[1])}
    if variant == "int8":
        packed["scale"] = tuple(scales)
    if torch.device(device).type == "cuda":
        packed["launch"] = _launch_args(packed)
    return packed


def softplus(x: torch.Tensor) -> torch.Tensor:
    """The kernel's stable softplus: ``max(x,0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _expand(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 12) f32 ABI rows → (B, K0) f32 expanded rows + distance (B,).

    Weekday/hour truncate toward zero as ``astype(int32)`` does, after a
    clamp that keeps huge inputs defined; a value outside [0, 7) / [0,
    24) sets no lane. Distance clamps at 0 (``x > 0 ? x : 0``)."""
    b = x.shape[0]
    xf = torch.zeros((b, K0), dtype=torch.float32, device=x.device)
    xf[:, _CAT[0]:_CAT[1]] = x[:, 0:8]
    wd = torch.clamp(x[:, 8], -1.0, 8.0).to(torch.int32)
    hr = torch.clamp(x[:, 9], -1.0, 25.0).to(torch.int32)
    xf[:, _WD[0]:_WD[0] + 7] = (
        wd[:, None] == torch.arange(7, device=x.device)).float()
    xf[:, _HR[0]:_HR[0] + 24] = (
        hr[:, None] == torch.arange(24, device=x.device)).float()
    dist = torch.where(x[:, 10] > 0, x[:, 10], torch.zeros_like(x[:, 10]))
    xf[:, _DIST] = dist
    xf[:, _LOGD] = torch.log1p(dist)
    xf[:, _AGE] = x[:, 11]
    return xf, dist


def _epilogue(out: torch.Tensor, dist: torch.Tensor, n_q: int) -> torch.Tensor:
    if n_q == 0:
        return softplus(out[:, 0]) * dist + softplus(out[:, 1])
    pace = torch.cumsum(softplus(out[:, :n_q]), dim=1)
    overhead = torch.cumsum(softplus(out[:, n_q:2 * n_q]), dim=1)
    return pace * dist[:, None] + overhead


def fused_eta_forward_plain(packed: Packed, x: torch.Tensor, *,
                            n_q: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the same packing.

    int8 weights dequantize as ``_kernel`` :271 does, ``bf16_rn(float(q)
    · s)``, and then follow the bf16 path. bf16 operands are cast up to
    f32 before ``torch.matmul``: products of bf16 values are exact in
    f32, so this is the kernel's (and the Pallas kernel's
    ``preferred_element_type=f32``) accumulation — a bf16×bf16
    ``torch.matmul`` would return bf16 and round the sum."""
    ws, bs = packed["w"], packed["b"]
    if "scale" in packed:
        ws = [(w.float() * s).to(torch.bfloat16)
              for w, s in zip(ws, packed["scale"])]
    compute = ws[0].dtype
    xfull, dist = _expand(x.float())
    h = xfull.to(compute)
    out = xfull
    for i, (w, b) in enumerate(zip(ws, bs)):
        out = torch.matmul(h.float(), w.float()) + b
        if i < len(ws) - 1:
            h = F.gelu(out, approximate="tanh").to(compute)
    return _epilogue(out, dist, n_q)


def _smem_bytes(dims: List[int], dtype: torch.dtype, tile: int) -> int:
    """Dynamic shared memory the kernel takes for ``dims`` (the C
    launcher's ``tc_smem_bytes`` / ``f32_smem_bytes``)."""
    if dtype == torch.float32:
        return 4 * _TILE_F32 * (2 * _round_up(max(dims[:-1]), 4) + dims[-1]
                                + 1)
    quant = dtype == torch.int8
    slot = _SLAB_ROWS * (_LDQ if quant else 2 * _LDW) + \
        (2 if quant else 1) * _PASS_COLS * 4
    return (2 * tile * (max(dims[:-1]) + 8) * 2 + _STAGES * slot
            + 4 * tile * (dims[-1] + 1) + 8 * _STAGES)


def _check_packing(packed: Packed) -> Tuple[List[int], torch.dtype]:
    """Check what the kernel takes of a packing → ([K0, N_0, …, N_last],
    stored weight dtype); raises on anything it does not."""
    ws, bs = packed["w"], packed["b"]
    scales = packed.get("scale")
    if not 1 <= len(ws) <= _MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"the kernel takes 1..{_MAX_LAYERS} layers, "
                         f"got {len(ws)} weights / {len(bs)} biases")
    stored = ws[0].dtype
    if stored not in _VARIANT_CODE:
        raise NotImplementedError(
            f"no kernel variant for {stored} weights (bf16 / f32 / int8)")
    if stored == torch.int8:
        if scales is None or len(scales) != len(ws):
            raise ValueError("int8 weights need one f32 scale vector per "
                             "layer under 'scale'")
    elif scales is not None:
        raise ValueError(f"{stored} weights take no scales")
    dims = [K0]
    for i, (w, b) in enumerate(zip(ws, bs)):
        s = scales[i] if scales is not None else None
        if w.dtype != stored or b.dtype != torch.float32:
            raise ValueError("weights must share one stored dtype and "
                             "biases must be float32")
        tensors = (w, b) if s is None else (w, b, s)
        if any(t.device != ws[0].device for t in tensors):
            raise ValueError("weights, biases and scales must be on one "
                             "device")
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in tensors):
            raise ValueError("weights, biases and scales must be contiguous "
                             "and 16-byte aligned (the kernel copies them "
                             "in 16-byte pieces)")
        if w.dim() != 2 or w.shape[0] != dims[-1] or \
                tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not chain from width "
                             f"{dims[-1]}")
        if s is not None and (s.dtype != torch.float32
                              or tuple(s.shape) != (w.shape[1],)):
            raise ValueError(f"layer {i}: scale {s.dtype} "
                             f"{tuple(s.shape)} is not float32 "
                             f"({w.shape[1]},)")
        dims.append(int(w.shape[1]))
    if stored != torch.float32 and any(d % PAD for d in dims):
        raise ValueError(f"widths {dims} are not multiples of {PAD}: pack "
                         f"with pack_eta_params")
    smem = _smem_bytes(dims, stored, _TILES[0])
    if smem > _MAX_SMEM:
        raise ValueError(f"widths {dims} need {smem} B of shared memory; "
                         f"the kernel has {_MAX_SMEM}")
    return dims, stored


def _check_heads(packed: Packed, dims: List[int], n_q: int) -> None:
    if not 0 <= n_q <= _MAX_Q:
        raise ValueError(f"n_q must lie in [0, {_MAX_Q}], got {n_q}")
    heads = packed.get("n_heads", dims[-1])
    if heads != 2 * max(1, n_q) or heads > dims[-1]:
        raise ValueError(f"last layer has {heads} heads, n_q={n_q} "
                         f"needs {2 * max(1, n_q)}")


def _check_x(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != N_FEATURES:
        raise ValueError(f"x must be float32 (B, {N_FEATURES}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _launch_dims(packed: Packed, x: torch.Tensor, n_q: int) -> List[int]:
    """Check what the kernel takes → [K0, N_0, …, N_last]; raises on
    anything it does not."""
    _check_x(x)
    dims, _ = _check_packing(packed)
    _check_heads(packed, dims, n_q)
    return dims


def _slab_stream(packed: Packed) -> torch.Tensor:
    """The tensor-core kernel's weight stream (the layout note above
    ``record_bytes`` in ``csrc/fused_eta.cu``): for each layer, each pass
    of up to ``_PASS_COLS`` columns and each K-slab of up to
    ``_SLAB_ROWS`` rows, one record — the slab's weight rows padded by 8
    bf16 / 16 int8 elements, then for int8 the pass's scales, then on
    the pass's last slab its bias — as one flat uint8 tensor, so one TMA
    copy moves a whole slab."""
    scales = packed.get("scale")
    pad = 16 if scales is not None else 8
    parts = []
    for i, (w, b) in enumerate(zip(packed["w"], packed["b"])):
        k, n = w.shape
        for c0 in range(0, n, _PASS_COLS):
            cols = min(_PASS_COLS, n - c0)
            for k0 in range(0, k, _SLAB_ROWS):
                rows = w[k0:k0 + _SLAB_ROWS, c0:c0 + cols]
                parts.append(F.pad(rows, (0, pad)).reshape(-1)
                             .view(torch.uint8))
                if scales is not None:
                    parts.append(scales[i][c0:c0 + cols].view(torch.uint8))
                if k0 + _SLAB_ROWS >= k:
                    parts.append(b[c0:c0 + cols].view(torch.uint8))
    return torch.cat(parts)


class _Launch(NamedTuple):
    """The C entry's per-packing arguments (``packed["launch"]``), built
    once by :func:`pack_eta_params` on the card. The f32 kernel reads the
    packed weights and biases through the pointer arrays ``c_w``/``c_b``;
    the tensor-core kernel reads everything from ``slabs``
    (:func:`_slab_stream`)."""

    dims: List[int]
    dtype: torch.dtype
    device: torch.device
    sms: Optional[int]
    code: int
    c_dims: ctypes.Array
    c_w: Optional[ctypes.Array]
    c_b: Optional[ctypes.Array]
    slabs: Optional[torch.Tensor]
    slabs_ptr: Optional[int]


def _launch_args(packed: Packed) -> _Launch:
    """Check ``packed`` (:func:`_check_packing`) → its :class:`_Launch`."""
    dims, dtype = _check_packing(packed)
    ws, bs = packed["w"], packed["b"]
    device = ws[0].device
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    if dtype == torch.float32:
        ptrs = ctypes.c_uint64 * len(ws)
        return _Launch(dims, dtype, device, sms, _VARIANT_CODE[dtype], c_dims,
                       ptrs(*[t.data_ptr() for t in ws]),
                       ptrs(*[t.data_ptr() for t in bs]), None, None)
    slabs = _slab_stream(packed)
    return _Launch(dims, dtype, device, sms, _VARIANT_CODE[dtype], c_dims,
                   None, None, slabs, slabs.data_ptr())


def tile_rows(batch: int, dims: List[int], dtype: torch.dtype,
              sms: int) -> int:
    """Rows per block of the tensor-core kernel (the f32 kernel always
    takes 32), as measured on the H100 (``PERF.md``): 16 while every
    block still has an SM of its own — a block's latency is the kernel's
    time, and a 16-row block takes ~0.8× a 32-row one — else 32, which
    halves the blocks behind each SM; 16 wherever 32 rows do not fit in
    shared memory."""
    small, large = _TILES
    if batch <= small * sms or _smem_bytes(dims, dtype, large) > _MAX_SMEM:
        return small
    return large


def fused_eta_forward(packed: Packed, x: torch.Tensor, *, n_q: int = 0,
                      tile: Optional[int] = None) -> torch.Tensor:
    """(B, 12) ABI features → (B,) ETA minutes, or (B, n_q) per-quantile
    minutes for a quantile model.

    A CPU tensor goes through :func:`fused_eta_forward_plain`; a CUDA
    tensor through the kernel (``csrc/fused_eta.cu``), launched on the
    current stream without synchronising; the packing must come from
    :func:`pack_eta_params` on the card. ``tile`` overrides the
    tensor-core kernel's rows per block (16 or 32; default
    :func:`tile_rows`), for measuring and checking each one. An empty
    batch returns without a launch.
    ``fused_eta_forward.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_eta_forward_plain(packed, x, n_q=n_q)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_eta_forward for device {x.device}")
    args = packed.get("launch")
    if args is None:
        raise ValueError(f"x is on {x.device}; the packing was not made on "
                         f"the card (pack_eta_params(..., device='cuda'))")
    _check_x(x)
    if x.device != args.device:
        raise ValueError(f"x is on {x.device}, the packing on {args.device}")
    _check_heads(packed, args.dims, n_q)
    index = x.device.index
    if index != torch.cuda.current_device():   # the launcher's device
        with torch.cuda.device(index):
            return fused_eta_forward(packed, x, n_q=n_q, tile=tile)
    b_rows = x.shape[0]
    out = torch.empty((b_rows, n_q) if n_q else (b_rows,),
                      dtype=torch.float32, device=x.device)
    if b_rows == 0:
        return out
    if tile is None:
        tile = tile_rows(b_rows, args.dims, args.dtype, args.sms)
    elif tile not in _TILES:
        raise ValueError(f"tile must be one of {_TILES}, got {tile}")
    elif _smem_bytes(args.dims, args.dtype, tile) > _MAX_SMEM:
        raise ValueError(f"widths {args.dims} do not fit a {tile}-row tile")
    from routest_tpu_torch.ops.build import load_library

    lib = load_library()
    # the raw current stream: torch.cuda.current_stream() would build a
    # Stream object on every call
    rc = lib.rtpu_fused_eta_forward(
        x.data_ptr(), out.data_ptr(), b_rows, args.c_w, args.c_b,
        args.slabs_ptr, args.c_dims, len(args.dims) - 1, n_q, args.code, tile,
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(
            f"fused_eta_forward launch failed: CUDA error {rc} "
            f"({lib.rtpu_cuda_error_string(rc).decode()})")
    fused_eta_forward.launches += 1
    return out


fused_eta_forward.launches = 0
