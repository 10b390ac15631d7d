"""The 12-feature ETA input encoding.

Feature contract (order and semantics) mirrors the reference's only
ground truth about its model input, ``Flaskr/ml.py:35-48``:

``weather_Cloudy, weather_Stormy, weather_Sunny, weather_Windy,
traffic_High, traffic_Jam, traffic_Low, traffic_Medium,
weekday_ordered (0-6), hour_ordered (0-23), distance_km, driver_age``

One-hots encode *unknown* category values (e.g. weather "Fog") as
all-zeros in their group. The serving path encodes on the host with
numpy (:func:`batch_from_mapping`) so the batcher can stage rows cheaply
before one device copy; :func:`encode_features` is the same transform
as a torch op.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

WEATHER_CATEGORIES: tuple = ("Cloudy", "Stormy", "Sunny", "Windy")
TRAFFIC_CATEGORIES: tuple = ("High", "Jam", "Low", "Medium")

FEATURE_NAMES: tuple = tuple(
    [f"weather_{w}" for w in WEATHER_CATEGORIES]
    + [f"traffic_{t}" for t in TRAFFIC_CATEGORIES]
    + ["weekday_ordered", "hour_ordered", "distance_km", "driver_age"]
)
N_FEATURES = len(FEATURE_NAMES)  # 12

# Defaults match the reference endpoints (``Flaskr/routes.py:103-104,371-372``).
DEFAULT_WEATHER = "Sunny"
DEFAULT_TRAFFIC = "Low"
DEFAULT_DRIVER_AGE = 30.0


def vocab_index(values: Iterable[str], vocab: Sequence[str]) -> np.ndarray:
    """Host-side string→index; unknown values map to -1 (⇒ all-zero one-hot)."""
    lookup = {v: i for i, v in enumerate(vocab)}
    return np.asarray([lookup.get(v, -1) for v in values], dtype=np.int32)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot with index -1 (or any out-of-range index) → all zeros —
    ``torch.nn.functional.one_hot`` raises on -1 instead."""
    return (idx.long().unsqueeze(-1)
            == torch.arange(n, device=idx.device)).to(dtype)


def encode_features(
    weather_idx: torch.Tensor,
    traffic_idx: torch.Tensor,
    weekday: torch.Tensor,
    hour: torch.Tensor,
    distance_km: torch.Tensor,
    driver_age: torch.Tensor,
    dtype=torch.float32,
) -> torch.Tensor:
    """(N,) index/scalar tensors → (N, 12) feature matrix. Index -1 in
    either categorical column produces an all-zero one-hot group."""
    scalars = torch.stack(
        [weekday.to(dtype), hour.to(dtype), distance_km.to(dtype),
         driver_age.to(dtype)], dim=-1)
    return torch.cat([_one_hot(weather_idx, len(WEATHER_CATEGORIES), dtype),
                      _one_hot(traffic_idx, len(TRAFFIC_CATEGORIES), dtype),
                      scalars], dim=-1)


def encode_requests(
    weather: Sequence[str],
    traffic: Sequence[str],
    weekday: Sequence[int],
    hour: Sequence[int],
    distance_km: Sequence[float],
    driver_age: Sequence[float],
) -> np.ndarray:
    """Host-side batch encode (numpy in, numpy out) — the serving path's
    pre-device step."""
    return batch_from_mapping(
        {
            "weather_idx": vocab_index(weather, WEATHER_CATEGORIES),
            "traffic_idx": vocab_index(traffic, TRAFFIC_CATEGORIES),
            "weekday": weekday,
            "hour": hour,
            "distance_km": distance_km,
            "driver_age": driver_age,
        }
    )


def encode_request(
    *,
    weather: Optional[str] = None,
    traffic: Optional[str] = None,
    distance_m: float = 0.0,
    weekday: int = 0,
    hour: int = 0,
    driver_age: Optional[float] = None,
) -> np.ndarray:
    """Single request → (1, 12) row, applying the reference's defaults."""
    return encode_requests(
        weather=[weather or DEFAULT_WEATHER],
        traffic=[traffic or DEFAULT_TRAFFIC],
        weekday=[weekday],
        hour=[hour],
        distance_km=[float(distance_m or 0.0) / 1000.0],
        driver_age=[float(driver_age) if driver_age is not None else DEFAULT_DRIVER_AGE],
    )


def batch_from_mapping(batch: Mapping[str, np.ndarray], *,
                       force_python: bool = False) -> np.ndarray:
    """Dataset-dict (``weather_idx``, ``traffic_idx``, ``weekday``,
    ``hour``, ``distance_km``, ``driver_age``) → (N, 12) float32
    features, on the host: one C pass through the native encoder
    (``routest_tpu_torch/native``) when its library is available, the
    numpy twin below (the same bytes) otherwise; ``ROUTEST_NATIVE=0``
    or ``force_python`` takes numpy."""
    from routest_tpu_torch import native

    if not force_python and native.available():
        return native.encode_batch(
            np.asarray(batch["weather_idx"]), np.asarray(batch["traffic_idx"]),
            np.asarray(batch["weekday"]), np.asarray(batch["hour"]),
            np.asarray(batch["distance_km"]), np.asarray(batch["driver_age"]))
    w = np.asarray(batch["weather_idx"], dtype=np.int64)
    t = np.asarray(batch["traffic_idx"], dtype=np.int64)
    n = len(w)
    out = np.zeros((n, N_FEATURES), dtype=np.float32)
    rows = np.arange(n)
    valid_w = w >= 0
    out[rows[valid_w], w[valid_w]] = 1.0
    valid_t = t >= 0
    out[rows[valid_t], len(WEATHER_CATEGORIES) + t[valid_t]] = 1.0
    base = len(WEATHER_CATEGORIES) + len(TRAFFIC_CATEGORIES)
    out[:, base + 0] = np.asarray(batch["weekday"], dtype=np.float32)
    out[:, base + 1] = np.asarray(batch["hour"], dtype=np.float32)
    out[:, base + 2] = np.asarray(batch["distance_km"], dtype=np.float32)
    out[:, base + 3] = np.asarray(batch["driver_age"], dtype=np.float32)
    return out
