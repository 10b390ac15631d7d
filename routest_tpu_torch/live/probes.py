"""Fleet-scale probe source + the congestion scenario driver.

Copied from ``routest_tpu/live/probes.py``, host numpy.

``serve/sim.py`` replays ONE confirmed route as tracker ticks; this
module scales that idea to a city: hundreds–thousands of seeded
drivers random-walking the road graph, each publishing per-edge
*speed* observations over the bus every tick. Observed speeds come
from the same ground-truth congestion model the GNN trains against
(the port's ``data/road_graph.true_edge_time_s``) times the scenario's corridor
multiplier — so an injected jam is visible to the estimator exactly
the way a real one would be: through slower probes, never through a
side channel.

Determinism: one seeded RNG drives every draw, and ``step()`` is the
whole per-tick state transition — tests replay scenarios bit-
identically by calling it directly; the threaded runner only adds a
wall clock.

Wire format (one bus event per driver per tick)::

    {"t": <unix>, "hour": <0-23>, "driver": "d17",
     "obs": [[edge_id, speed_mps], ...]}
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from routest_tpu_torch.data.road_graph import true_edge_time_s
from routest_tpu_torch.utils.logging import get_logger

DEFAULT_CHANNEL = "rtpu.probes"


def corridor_edges(node_coords: np.ndarray, senders: np.ndarray,
                   receivers: np.ndarray,
                   a_latlon: Sequence[float], b_latlon: Sequence[float],
                   width_m: float = 300.0) -> np.ndarray:
    """Edge ids forming the corridor between two points: every edge
    BOTH of whose endpoints lie within ``width_m`` of the a→b segment.
    Geometry-only (no router needed), so scenarios can name a corridor
    by two landmarks and get a stable edge set on any extract."""
    coords = np.asarray(node_coords, np.float64)
    a = np.asarray(a_latlon, np.float64)
    b = np.asarray(b_latlon, np.float64)
    # Equirectangular meters around the corridor's mid-latitude: exact
    # enough at city scale, and 1000x cheaper than per-edge haversine.
    lat0 = np.radians((a[0] + b[0]) / 2.0)
    scale = np.asarray([111_194.9, 111_194.9 * np.cos(lat0)])
    p = (coords - a) * scale
    seg = (b - a) * scale
    seg_len2 = float(seg @ seg)
    if seg_len2 <= 0:
        d = np.sqrt((p ** 2).sum(axis=1))
    else:
        t = np.clip((p @ seg) / seg_len2, 0.0, 1.0)
        d = np.sqrt(((p - t[:, None] * seg[None, :]) ** 2).sum(axis=1))
    near = d <= width_m
    mask = near[np.asarray(senders, np.int64)] \
        & near[np.asarray(receivers, np.int64)]
    return np.flatnonzero(mask)


class CongestionScenario:
    """A named corridor that jams at a named time.

    ``speed_factor`` multiplies corridor speeds while active (0.25 =
    traffic at a quarter of the usual speed). Activation is either
    explicit (``set_active``) or by wall clock (``start_unix`` /
    ``end_unix``). Thread-safe by atomicity of the fields involved."""

    def __init__(self, corridor: np.ndarray, speed_factor: float = 0.25,
                 start_unix: Optional[float] = None,
                 end_unix: Optional[float] = None) -> None:
        self.corridor = np.asarray(corridor, np.int64)
        if not (0.0 < speed_factor):
            raise ValueError("speed_factor must be positive")
        self.speed_factor = float(speed_factor)
        self.start_unix = start_unix
        self.end_unix = end_unix
        self._forced: Optional[bool] = None

    def set_active(self, active: Optional[bool]) -> None:
        """Force on/off (None returns control to the clock)."""
        self._forced = active

    def active(self, now: float) -> bool:
        if self._forced is not None:
            return self._forced
        if self.start_unix is None:
            return False
        if now < self.start_unix:
            return False
        return self.end_unix is None or now < self.end_unix

    def time_multiplier(self, n_edges: int, now: float) -> np.ndarray:
        """(E,) travel-TIME multiplier (1/speed_factor on the corridor
        while active, 1 elsewhere)."""
        mult = np.ones(n_edges, np.float64)
        if self.active(now) and len(self.corridor):
            mult[self.corridor] = 1.0 / self.speed_factor
        return mult


class ProbeFleet:
    """Seeded simulated probe fleet over a road graph.

    Each driver holds a current node and, per tick, traverses
    ``obs_per_tick`` out-edges (restarting from a random node at
    dead ends), observing each edge's effective speed
    ``length / true_time`` under the scenario, with log-normal noise.
    ``step(now)`` advances every driver one tick and publishes one
    event per driver; ``start(tick_s)`` runs steps on a daemon thread.
    """

    def __init__(self, graph: Dict[str, np.ndarray], n_drivers: int,
                 publish: Callable[[str, dict], object], *,
                 seed: int = 0, channel: str = DEFAULT_CHANNEL,
                 obs_per_tick: int = 4, noise_sigma: float = 0.05,
                 scenario: Optional[CongestionScenario] = None) -> None:
        self.senders = np.asarray(graph["senders"], np.int64)
        self.receivers = np.asarray(graph["receivers"], np.int64)
        self.length_m = np.asarray(graph["length_m"], np.float64)
        self.road_class = np.asarray(graph["road_class"], np.int64)
        self.n_nodes = int(max(self.senders.max(),
                               self.receivers.max())) + 1
        self.n_edges = len(self.senders)
        self.channel = channel
        self.obs_per_tick = int(obs_per_tick)
        self.noise_sigma = float(noise_sigma)
        self.scenario = scenario
        self._publish = publish
        self._rng = np.random.default_rng(seed)
        # Out-edge CSR for the random walk.
        order = np.argsort(self.senders, kind="stable")
        self._adj_edges = order
        counts = np.bincount(self.senders, minlength=self.n_nodes)
        self._adj_ptr = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(counts, out=self._adj_ptr[1:])
        self._at = self._rng.integers(0, self.n_nodes, int(n_drivers))
        self.ticks = 0
        self.published = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self, now: Optional[float] = None,
             hour: Optional[int] = None) -> List[dict]:
        """One fleet tick: every driver walks and publishes. Returns
        the events (tests introspect them; the bus already got them)."""
        now = time.time() if now is None else float(now)
        if hour is None:
            hour = time.localtime(now).tm_hour
        # Hour is constant across the tick: price every edge once
        # (vectorized), then the per-driver walk only indexes.
        t_true_all = true_edge_time_s(
            self.length_m, self.road_class,
            np.full(self.n_edges, int(hour) % 24))
        if self.scenario is not None:
            t_true_all = t_true_all * self.scenario.time_multiplier(
                self.n_edges, now)
        events: List[dict] = []
        for di in range(len(self._at)):
            node = int(self._at[di])
            obs: List[List[float]] = []
            for _ in range(self.obs_per_tick):
                lo, hi = self._adj_ptr[node], self._adj_ptr[node + 1]
                if hi <= lo:  # dead end: teleport (disconnected pocket)
                    node = int(self._rng.integers(0, self.n_nodes))
                    continue
                e = int(self._adj_edges[
                    lo + int(self._rng.integers(0, hi - lo))])
                t_obs = float(t_true_all[e]) * float(np.exp(
                    self._rng.normal(0.0, self.noise_sigma)))
                obs.append([e, round(float(self.length_m[e]) / t_obs, 4)])
                node = int(self.receivers[e])
            self._at[di] = node
            if not obs:
                continue
            event = {"t": now, "hour": int(hour) % 24,
                     "driver": f"d{di}", "obs": obs}
            events.append(event)
            self._publish(self.channel, event)
            self.published += 1
        self.ticks += 1
        return events

    def start(self, tick_s: float = 1.0) -> None:
        def run() -> None:
            while not self._stop.wait(tick_s):
                try:
                    self.step()
                except Exception as e:  # daemon: never die silently
                    get_logger("routest_tpu_torch.live").error(
                        "probe_fleet_step_failed",
                        error=f"{type(e).__name__}: {e}")

        self._thread = threading.Thread(target=run, name="probe-fleet",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
