"""Fused ETA-MLP inference: one CUDA kernel for the whole forward.

Replaces the TPU kernel ``routest_tpu/ops/fused_mlp.py::fused_eta_forward``
(the Pallas ``pallas_call`` at :366, body ``_kernel`` :214). One launch
takes the raw (B, 12) ABI rows and returns (B,) point ETA minutes or
(B, n_q) non-crossing quantile minutes: feature expansion (weather and
traffic copied, weekday/hour one-hots, distance clamped at 0, log1p
distance, age; the training normalizer folded into layer 0 at pack
time), the matmul chain with f32 accumulation and tanh-GELU between
layers, and the epilogue, with no intermediate touching device memory.

**What bounds it on the H100.** For the shipped artifact
(42→256→256→128→6, bf16) a row costs ~239 kFLOP and moves 60 bytes, so
at serving batches the work is far above the card's bytes-per-FLOP line
and the bound is the tensor cores' rate (~1 µs for 4096 rows). This
first kernel is written for being right, not for that bound: it runs
the GEMMs on the CUDA cores in f32 FMAs, so it is bounded by the
FMA rate and the shared-memory reads that feed it. What the design does
about that: one block per 32-row tile keeps each tile's activations in
shared memory (two ping-pong buffers in the compute dtype, never device
memory); each thread owns one output column for an 8-row chunk, so
each weight element it reads from L2 (the whole packed trunk is 239 KB
in bf16 and stays in the 50 MB L2) feeds 8 FMAs, and activations are
read 4 K-steps at a time as one vector load that every lane of the warp
broadcasts. ``wgmma``/TMA tiling toward the tensor-core bound is later
work (ROADMAP Queue B).

**Layout.** The TPU kernel pads everything to 128 lanes; this one keeps
the JAX lane order for expanded rows 0–66 (``_CAT`` 0–7, ``_WD`` 8–39,
``_HR`` 40–63, ``_DIST`` 64, ``_LOGD`` 65, ``_AGE`` 66) — so the packed
layer 0 compares row by row with the JAX packing — pads layer-0 K only
to :data:`K0` = 80, and leaves every hidden width unpadded.

**Numerics.** As in ``_kernel`` :274-277: operands in the compute dtype
(bf16 or f32), products accumulated in f32, bias added and GELU applied
in f32, then rounded to the compute dtype. The epilogue is f32 with a
stable softplus and a sequential cumulative sum over the quantiles.

Beside the kernel, :func:`fused_eta_forward_plain` computes the same
function on the same packing in plain PyTorch. The wrapper
:func:`fused_eta_forward` takes it only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

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

# EtaMLP._expand's row order in the trained layer-0 weight matrix.
_ROW_CAT = (0, 8)
_ROW_WD = (8, 15)
_ROW_HR = (15, 39)
_ROW_DIST, _ROW_LOGD, _ROW_AGE = 39, 40, 41

# Kernel limits, mirrored from csrc/fused_eta.cu.
_TILE_ROWS = 32
_MAX_LAYERS = 8
_MAX_Q = 16
_MAX_SMEM = 232_448   # H100: dynamic shared memory one block may use

Packed = Dict[str, List[torch.Tensor]]

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


def pack_eta_params(model, params, dtype: str = None,
                    device="cpu") -> Packed:
    """EtaMLP params (numpy pytree) → the kernel's weights on ``device``.

    Layer 0 is re-rowed to the expanded lane layout with the normalizer
    folded in: ``(d - mean)/std`` feeding a linear layer is the same as
    scaling the weight row by ``1/std`` and shifting the bias by
    ``-mean/std · row``. The arithmetic is the JAX ``pack_eta_params``'s
    (same numpy ops, same order), so rows 0–66 and the real columns
    equal it bit for bit. Weights are stored (K, N) row-major in the
    compute dtype; biases are always f32 — they add into the f32
    accumulator.
    """
    variant = resolve_kernel_dtype(model, dtype)
    if variant == "int8":
        raise NotImplementedError(
            "the int8 kernel variant is not ported yet "
            "(RTPU_KERNEL_DTYPE=bf16 or f32)")
    compute = torch.bfloat16 if variant == "bfloat16" else torch.float32
    norm = params["norm"]
    mean = np.asarray(norm["mean"], np.float32)
    std = np.asarray(norm["std"], np.float32)
    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    for i, layer in enumerate(params["layers"]):
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        d_out = w.shape[1]
        if i == 0:
            wp = np.zeros((K0, d_out), np.float32)
            wp[_CAT[0]:_CAT[1]] = w[_ROW_CAT[0]:_ROW_CAT[1]]
            wp[_WD[0]:_WD[0] + (_ROW_WD[1] - _ROW_WD[0])] = \
                w[_ROW_WD[0]:_ROW_WD[1]]
            wp[_HR[0]:_HR[0] + (_ROW_HR[1] - _ROW_HR[0])] = \
                w[_ROW_HR[0]:_ROW_HR[1]]
            wp[_DIST] = w[_ROW_DIST] / std[10]
            wp[_LOGD] = w[_ROW_LOGD]
            wp[_AGE] = w[_ROW_AGE] / std[11]
            bp = (b - (mean[10] / std[10]) * w[_ROW_DIST]
                  - (mean[11] / std[11]) * w[_ROW_AGE])
        else:
            wp, bp = w, b
        ws.append(torch.tensor(wp, dtype=torch.float32).to(
            device=device, dtype=compute))
        bs.append(torch.tensor(bp, dtype=torch.float32, device=device))
    return {"w": ws, "b": bs}


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

    bf16 operands are cast up to f32 before ``torch.matmul``: products
    of bf16 values are exact in f32, so this is the kernel's (and the
    Pallas kernel's ``preferred_element_type=f32``) accumulation — a
    bf16×bf16 ``torch.matmul`` would return bf16 and round the sum."""
    ws, bs = packed["w"], packed["b"]
    compute = ws[0].dtype
    xfull, dist = _expand(x.float())
    h = xfull.to(compute)
    out = xfull
    for i, (w, b) in enumerate(zip(ws, bs)):
        out = torch.matmul(h.float(), w.float()) + b
        if i < len(ws) - 1:
            h = F.gelu(out, approximate="tanh").to(compute)
    return _epilogue(out, dist, n_q)


def _launch_dims(packed: Packed, x: torch.Tensor, n_q: int) -> List[int]:
    """Check what the kernel takes → [K0, N_0, …, N_last]; raises on
    anything it does not."""
    ws, bs = packed["w"], packed["b"]
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != N_FEATURES:
        raise ValueError(f"x must be float32 (B, {N_FEATURES}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 1 <= len(ws) <= _MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"the kernel takes 1..{_MAX_LAYERS} layers, "
                         f"got {len(ws)} weights / {len(bs)} biases")
    if not 0 <= n_q <= _MAX_Q:
        raise ValueError(f"n_q must lie in [0, {_MAX_Q}], got {n_q}")
    compute = ws[0].dtype
    if compute not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"no kernel variant for {compute} weights (bf16 / f32)")
    dims = [K0]
    for w, b in zip(ws, bs):
        if w.dtype != compute or b.dtype != torch.float32:
            raise ValueError("weights must share one compute dtype and "
                             "biases must be float32")
        if w.device != x.device or b.device != x.device:
            raise ValueError("weights, biases and x must be on one device")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError("weights and biases must be contiguous")
        if w.dim() != 2 or w.shape[0] != dims[-1] or \
                tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer {len(dims) - 1}: weight "
                             f"{tuple(w.shape)} / bias {tuple(b.shape)} "
                             f"do not chain from width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if dims[-1] != 2 * max(1, n_q):
        raise ValueError(f"last layer has {dims[-1]} heads, n_q={n_q} "
                         f"needs {2 * max(1, n_q)}")
    ld = -(-max(dims[:-1]) // 4) * 4
    smem = (2 * _TILE_ROWS * ld * ws[0].element_size()
            + 4 * _TILE_ROWS * (dims[-1] + 1 + N_FEATURES))
    if smem > _MAX_SMEM:
        raise ValueError(f"widths {dims} need {smem} B of shared memory; "
                         f"the kernel has {_MAX_SMEM}")
    return dims


def fused_eta_forward(packed: Packed, x: torch.Tensor, *,
                      n_q: int = 0) -> torch.Tensor:
    """(B, 12) ABI features → (B,) ETA minutes, or (B, n_q) per-quantile
    minutes for a quantile model.

    A CPU tensor goes through :func:`fused_eta_forward_plain`; a CUDA
    tensor through the kernel (``csrc/fused_eta.cu``), launched on the
    current stream without synchronising. An empty batch returns without
    a launch. ``fused_eta_forward.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_eta_forward_plain(packed, x, n_q=n_q)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_eta_forward for device {x.device}")
    dims = _launch_dims(packed, x, n_q)
    b_rows = x.shape[0]
    out = torch.empty((b_rows, n_q) if n_q else (b_rows,),
                      dtype=torch.float32, device=x.device)
    if b_rows == 0:
        return out
    from routest_tpu_torch.ops.build import load_library

    lib = load_library()
    n_layers = len(packed["w"])
    w_ptrs = (ctypes.c_uint64 * n_layers)(*(w.data_ptr() for w in packed["w"]))
    b_ptrs = (ctypes.c_uint64 * n_layers)(*(b.data_ptr() for b in packed["b"]))
    c_dims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.rtpu_fused_eta_forward(
            x.data_ptr(), out.data_ptr(), b_rows, w_ptrs, b_ptrs, c_dims,
            n_layers, n_q, int(packed["w"][0].dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_eta_forward launch failed: CUDA error {rc} "
            f"({lib.rtpu_cuda_error_string(rc).decode()})")
    fused_eta_forward.launches += 1
    return out


fused_eta_forward.launches = 0
