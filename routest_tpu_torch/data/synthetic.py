"""Synthetic delivery dataset generator (host numpy).

A copy of ``routest_tpu/data/synthetic.py``: for the same seed it returns
bitwise the JAX package's arrays.

The reference's ``data/`` and ``notebooks/`` are empty (SURVEY.md §0) and
its trained model is an unmaterialized LFS pointer, so the training-data
capability has to be *created*: a generator whose schema exactly matches
the 12-feature contract of ``Flaskr/ml.py:35-48`` (weather/traffic
categories, weekday, hour, distance_km, driver_age → ETA minutes).

The ground-truth ETA surface is principled, not arbitrary: travel time =
distance × pace, where pace (min/km) depends on traffic tier, rush-hour
bumps, weather multipliers, a weekend discount, a slight driver-age
U-curve, plus a fixed handling overhead and multiplicative log-normal
noise. It is deliberately non-linear (interactions between traffic, hour
and distance) so tree ensembles and MLPs separate from linear baselines —
giving the RMSE comparison teeth.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from routest_tpu_torch.data.features import TRAFFIC_CATEGORIES, WEATHER_CATEGORIES

# Pace in minutes per km by traffic tier (index aligned with
# TRAFFIC_CATEGORIES = High, Jam, Low, Medium); -1 (unknown) gets the value
# at index 4.
_TRAFFIC_PACE = np.asarray([4.1, 6.3, 2.0, 3.0, 3.4], dtype=np.float64)
# Weather multiplier (Cloudy, Stormy, Sunny, Windy, unknown e.g. "Fog").
_WEATHER_MULT = np.asarray([1.04, 1.38, 1.0, 1.09, 1.18], dtype=np.float64)

HANDLING_OVERHEAD_MIN = 6.0  # parking + handoff per delivery
NOISE_SIGMA = 0.08           # log-normal multiplicative noise


def true_eta_minutes(
    weather_idx: np.ndarray,
    traffic_idx: np.ndarray,
    weekday: np.ndarray,
    hour: np.ndarray,
    distance_km: np.ndarray,
    driver_age: np.ndarray,
) -> np.ndarray:
    """Noise-free ground-truth ETA surface (numpy, float64)."""
    pace = _TRAFFIC_PACE[np.where(traffic_idx < 0, 4, traffic_idx)]
    wmult = _WEATHER_MULT[np.where(weather_idx < 0, 4, weather_idx)]
    # Rush-hour congestion: gaussian bumps at 08:00 and 18:00; scaled so the
    # effect interacts with the traffic tier (jammed roads jam harder).
    h = hour.astype(np.float64)
    rush = 1.0 + 0.35 * (
        np.exp(-0.5 * ((h - 8.0) / 1.6) ** 2) + np.exp(-0.5 * ((h - 18.0) / 1.8) ** 2)
    ) * (pace / _TRAFFIC_PACE[3])
    # Night discount: free-flowing roads after 22:00 / before 05:00.
    night = np.where((h >= 22.0) | (h <= 5.0), 0.85, 1.0)
    weekend = np.where(weekday >= 5, 0.88, 1.0)
    # Driver-age U-curve, mild: fastest around 35.
    age = driver_age.astype(np.float64)
    age_mult = 1.0 + 0.00035 * (age - 35.0) ** 2
    # Long hauls spend a larger share on arterials: pace decays toward 65%
    # of the urban pace as distance grows.
    dist = distance_km.astype(np.float64)
    arterial = 0.65 + 0.35 * np.exp(-dist / 18.0)
    travel = dist * pace * arterial * rush * night * weekend * wmult * age_mult
    return HANDLING_OVERHEAD_MIN + travel


def generate_dataset(
    n: int,
    seed: int = 0,
    unknown_frac: float = 0.03,
    noise_sigma: Optional[float] = None,
) -> Dict[str, np.ndarray]:
    """Sample n delivery records.

    ``unknown_frac`` of rows get out-of-vocabulary weather/traffic
    (index -1, like "Fog"), exercising the all-zero one-hot path the
    reference exhibits for unknown categories.
    """
    rng = np.random.default_rng(seed)
    sigma = NOISE_SIGMA if noise_sigma is None else noise_sigma

    weather_idx = rng.integers(0, len(WEATHER_CATEGORIES), size=n).astype(np.int32)
    traffic_idx = rng.integers(0, len(TRAFFIC_CATEGORIES), size=n).astype(np.int32)
    unk_w = rng.random(n) < unknown_frac
    unk_t = rng.random(n) < unknown_frac
    weather_idx[unk_w] = -1
    traffic_idx[unk_t] = -1

    weekday = rng.integers(0, 7, size=n).astype(np.int32)
    # Deliveries cluster in business hours: mixture of daytime normal and
    # uniform tail.
    day = np.clip(rng.normal(13.0, 4.0, size=n), 0, 23)
    uni = rng.uniform(0, 24, size=n)
    hour = np.where(rng.random(n) < 0.85, day, uni).astype(np.int32)

    # Urban delivery leg lengths: log-normal, clipped to [0.3, 80] km
    # (Metro Manila scale — cf. the 21 seed sites spanning ~30 km).
    distance_km = np.clip(rng.lognormal(1.7, 0.75, size=n), 0.3, 80.0).astype(np.float32)
    driver_age = np.clip(rng.normal(36.0, 9.0, size=n), 18.0, 65.0).astype(np.float32)

    eta_true = true_eta_minutes(weather_idx, traffic_idx, weekday, hour, distance_km, driver_age)
    noise = rng.lognormal(mean=0.0, sigma=sigma, size=n)
    eta_minutes = (eta_true * noise).astype(np.float32)

    return {
        "weather_idx": weather_idx,
        "traffic_idx": traffic_idx,
        "weekday": weekday,
        "hour": hour,
        "distance_km": distance_km,
        "driver_age": driver_age,
        "eta_minutes": eta_minutes,
        "eta_true": eta_true.astype(np.float32),
    }


def train_eval_split(data: Dict[str, np.ndarray], eval_frac: float = 0.1,
                     seed: int = 1):
    n = len(data["eta_minutes"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_eval = max(1, int(n * eval_frac))
    eval_idx, train_idx = perm[:n_eval], perm[n_eval:]
    take = lambda idx: {k: v[idx] for k, v in data.items()}
    return take(train_idx), take(eval_idx)
