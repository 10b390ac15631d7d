"""Driver simulator: replays a computed route as live tracker updates.

Copied from ``routest_tpu/serve/sim.py``. It mirrors the reference's
behavior (``Flaskr/utils.py:229-251``): a daemon thread walks the route
geometry, emitting the remaining-route payload on each tick with a
random 2-5 s interval. The tick publishes straight to the bus (the
reference POSTs to its own ``/api/update_tracker``, which stays
available for real GPS sources).
"""

from __future__ import annotations

import datetime as dt
import random
import threading
from typing import Callable, Optional

from routest_tpu_torch.utils.logging import get_logger


def format_sse_data(data: dict) -> dict:
    """Tracker payload → SSE event shape (``Flaskr/utils.py:253-267``)."""
    pickup_time = dt.datetime.fromisoformat(data["pickup_time"])
    completion_time = pickup_time + dt.timedelta(seconds=float(data["duration"]))
    return {
        "destinations": data["destinations"],
        "remaining_routes": data["route"],
        "overall_duration": data["duration"],
        "overall_travel_distance": data["distance"],
        "overall_estimated_completion_time": completion_time.isoformat(),
        "total_trips": data.get("trips", 1),
        "assigned_driver": data["driver_name"],
        "transport_mode": data["vehicle_type"],
        "start_time": data["pickup_time"],
    }


def simulate_route(
    data: dict,
    publish: Callable[[str, dict], object],
    tick_range_s: tuple = (2.0, 5.0),
    rng: Optional[random.Random] = None,
) -> int:
    """Run one simulation to completion (blocking). Returns ticks sent.

    ``publish(channel, event)`` receives the formatted SSE event; the
    channel is the driver name, as in the reference (``route_id`` =
    ``driver_details.driver_name``, ``Flaskr/utils.py:237``).
    """
    rng = rng or random.Random()
    pickup_time = dt.datetime.now()
    route_points = list(data["route_details"]["geometry"]["coordinates"])
    props = data["route_details"]["properties"]
    destinations = props["destinations"]
    driver = data["driver_details"]

    ticks = 0
    while route_points:
        payload = {
            "route_id": driver["driver_name"],
            "route": list(route_points),
            "destinations": destinations,
            "driver_name": driver["driver_name"],
            "vehicle_type": driver["vehicle_type"],
            "duration": props["summary"]["duration"],
            "distance": props["summary"]["distance"],
            "trips": props["summary"].get("trips", 1),
            "pickup_time": pickup_time.isoformat(),
        }
        route_points.pop(0)
        publish(str(payload["route_id"]), format_sse_data(payload))
        ticks += 1
        if route_points:
            threading.Event().wait(rng.uniform(*tick_range_s))
    return ticks


def start_simulation(data: dict, publish,
                     tick_range_s: tuple = (2.0, 5.0),
                     rng: Optional[random.Random] = None,
                     seed: Optional[int] = None) -> threading.Thread:
    """Run :func:`simulate_route` on a daemon thread.

    ``rng`` (or ``seed``, which builds one) threads a seeded generator
    through to the tick-interval jitter, so scenarios and tests replay
    bit-identically. Unseeded callers get a fresh ``random.Random()``."""
    if rng is None and seed is not None:
        rng = random.Random(int(seed))

    def run():
        try:
            simulate_route(data, publish, tick_range_s, rng=rng)
        except Exception as e:  # daemon thread: never die silently
            get_logger("routest_tpu_torch.sim").error(
                "simulate_route_failed", error=f"{type(e).__name__}: {e}")

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread
