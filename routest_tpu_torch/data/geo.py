"""Geodesic math: haversine matrices on the device, polylines on the host.

The counterpart of ``routest_tpu/data/geo.py``. The profile tables and
the host-side polyline and bearing helpers are copies (numpy, float64),
so they agree bit for bit; the haversine distance matrix is a float32
tensor computation on the device of its input. Its ``sin``/``cos``/
``arcsin`` are the device's own, so matrices agree with the JAX
package's within a few float32 ulps, not bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import numpy as np
import torch

EARTH_RADIUS_M = 6_371_008.8

# Vehicle-type → routing profile, as the reference maps them
# (``Flaskr/utils.py:22-29``).
VEHICLE_PROFILES: Dict[str, str] = {
    "car": "driving-car",
    "truck": "driving-hgv",
    "hgv": "driving-hgv",
    "motorcycle": "driving-car",
    "bike": "cycling-regular",
    "roadbike": "cycling-road",
    "foot": "foot-walking",
}
DEFAULT_PROFILE = "driving-car"

# Heuristic stand-ins for a road engine: straight-line→road-network
# inflation factor and mean speed (m/s) per profile. Metro Manila urban
# grid detour factors are typically 1.3-1.5.
PROFILE_ROAD_FACTOR: Dict[str, float] = {
    "driving-car": 1.42,
    "driving-hgv": 1.48,
    "cycling-regular": 1.38,
    "cycling-road": 1.35,
    "foot-walking": 1.25,
}
PROFILE_SPEED_MPS: Dict[str, float] = {
    "driving-car": 8.3,      # ~30 km/h urban average
    "driving-hgv": 6.9,
    "cycling-regular": 4.2,
    "cycling-road": 5.5,
    "foot-walking": 1.4,
}

_DEG = math.pi / 180.0


def profile_for_vehicle(vehicle_type: str) -> str:
    return VEHICLE_PROFILES.get((vehicle_type or "car").lower().strip(), DEFAULT_PROFILE)


def haversine_m(lat1, lon1, lat2, lon2) -> torch.Tensor:
    """Great-circle distance in meters, elementwise on float32 tensors
    that broadcast together (the JAX expression, in the same order)."""
    lat1, lon1, lat2, lon2 = (x * _DEG for x in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = torch.sin(dlat / 2.0) ** 2 + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_M * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def distance_matrix_m(points_latlon: torch.Tensor,
                      road_factor: Union[float, torch.Tensor] = 1.0
                      ) -> torch.Tensor:
    """(..., N, 2) [lat, lon] float32 → (..., N, N) pairwise road-ish
    distance in meters, on the points' device. ``road_factor`` is a
    number, or a tensor of the leading (batch) shape: the batched form
    is the counterpart of the JAX engine's vmapped
    ``_distance_matrix_batch``."""
    lat = points_latlon[..., 0]
    lon = points_latlon[..., 1]
    d = haversine_m(lat[..., :, None], lon[..., :, None],
                    lat[..., None, :], lon[..., None, :])
    if isinstance(road_factor, torch.Tensor):
        road_factor = road_factor[..., None, None]
    return d * road_factor


def great_circle_interpolate(p0: Tuple[float, float], p1: Tuple[float, float],
                             n_points: int) -> np.ndarray:
    """Host-side densified polyline between two [lat, lon] points.

    Returns (n_points, 2) as [lon, lat] — GeoJSON coordinate order, which
    is what the reference's combined Feature geometry uses
    (``Flaskr/utils.py:162,180``).
    """
    lat0, lon0 = np.radians(p0[0]), np.radians(p0[1])
    lat1, lon1 = np.radians(p1[0]), np.radians(p1[1])
    d = 2.0 * np.arcsin(
        np.sqrt(
            np.clip(
                np.sin((lat1 - lat0) / 2.0) ** 2
                + np.cos(lat0) * np.cos(lat1) * np.sin((lon1 - lon0) / 2.0) ** 2,
                0.0,
                1.0,
            )
        )
    )
    t = np.linspace(0.0, 1.0, max(2, n_points))
    if d < 1e-9:
        lats = np.full_like(t, p0[0])
        lons = np.full_like(t, p0[1])
    else:
        a = np.sin((1.0 - t) * d) / np.sin(d)
        b = np.sin(t * d) / np.sin(d)
        x = a * np.cos(lat0) * np.cos(lon0) + b * np.cos(lat1) * np.cos(lon1)
        y = a * np.cos(lat0) * np.sin(lon0) + b * np.cos(lat1) * np.sin(lon1)
        z = a * np.sin(lat0) + b * np.sin(lat1)
        lats = np.degrees(np.arctan2(z, np.sqrt(x * x + y * y)))
        lons = np.degrees(np.arctan2(y, x))
    return np.stack([lons, lats], axis=-1)


def bearing_deg(p0: Tuple[float, float], p1: Tuple[float, float]) -> float:
    """Initial bearing from p0 to p1 (degrees, [lat, lon] inputs)."""
    lat0, lon0 = np.radians(p0[0]), np.radians(p0[1])
    lat1, lon1 = np.radians(p1[0]), np.radians(p1[1])
    dlon = lon1 - lon0
    x = np.sin(dlon) * np.cos(lat1)
    y = np.cos(lat0) * np.sin(lat1) - np.sin(lat0) * np.cos(lat1) * np.cos(dlon)
    return float((np.degrees(np.arctan2(x, y)) + 360.0) % 360.0)
