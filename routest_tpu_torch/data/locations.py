"""Canonical demo dataset: 21 Metro Manila sites.

Same facts the reference seeds into its ``locations`` table
(``backend/laravel/database/seeders/LocationsTableSeeder.php:13-35``):
one warehouse origin plus twenty malls. UUIDs here are deterministic
(uuid5 of the name) so hermetic tests and the in-memory store are stable
across runs, unlike the reference's random-per-seed uuid4s.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Tuple

import numpy as np

_NAMESPACE = uuid.UUID("9f2c1a34-7b1d-4c5e-9a61-0d4f2b8a6c33")

SEED_LOCATIONS: Tuple[Tuple[str, float, float], ...] = (
    ("Main Warehouse - Mandaluyong", 14.5836, 121.0409),
    ("SM Mall of Asia", 14.5352, 120.9822),
    ("Greenbelt Mall", 14.5516, 121.0233),
    ("SM Megamall", 14.5833, 121.0567),
    ("Market! Market!", 14.5536, 121.0546),
    ("Robinsons Galleria", 14.5896, 121.0614),
    ("SM North EDSA", 14.6556, 121.0313),
    ("Trinoma Mall", 14.6537, 121.0321),
    ("Gateway Mall", 14.6206, 121.0526),
    ("SM City Manila", 14.5881, 120.9814),
    ("Lucky Chinatown Mall", 14.6054, 120.9734),
    ("SM Aura Premier", 14.5456, 121.0559),
    ("Robinsons Place Manila", 14.5730, 120.9820),
    ("Ayala Malls Vertis North", 14.6543, 121.0327),
    ("Fisher Mall", 14.6300, 121.0045),
    ("SM City Sta. Mesa", 14.6031, 121.0275),
    ("Alabang Town Center", 14.4269, 121.0314),
    ("Festival Mall Alabang", 14.4143, 121.0438),
    ("Eastwood Mall", 14.6101, 121.0791),
    ("Robinsons Magnolia", 14.6162, 121.0336),
    ("Venice Grand Canal Mall", 14.5404, 121.0530),
)


def location_id(name: str) -> str:
    return str(uuid.uuid5(_NAMESPACE, name))


def locations_table() -> List[Dict]:
    """Rows shaped like Laravel's ``GET /api/locations`` response
    (``routes/api.php:7-9``: id, name, latitude, longitude, created_at)."""
    return [
        {
            "id": location_id(name),
            "name": name,
            "latitude": lat,
            "longitude": lon,
            "created_at": "2025-08-12T14:40:39+00:00",
        }
        for name, lat, lon in SEED_LOCATIONS
    ]


def coords_array() -> np.ndarray:
    """(21, 2) [lat, lon] array for on-device distance matrices."""
    return np.asarray([[lat, lon] for _, lat, lon in SEED_LOCATIONS], dtype=np.float32)
