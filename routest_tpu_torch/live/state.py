"""Incremental per-edge congestion state (host numpy).

Copied from ``routest_tpu/live/state.py``.

The estimator of record between the probe stream and the metric
customizer: every observation batch folds into a decayed EWMA of
per-edge travel seconds, and a snapshot exports the whole thing as a
dense edge-time array (device-uploadable — the customizer hands it
straight to the overlay re-pricing) plus a confidence vector and an
epoch counter.

Design points:

- **Decayed EWMA, not a plain mean**: the weight of history halves
  every ``half_life_s`` of OBSERVATION time, so a corridor that jams
  converges to the new regime within a couple of half-lives however
  many free-flow observations preceded it.
- **Confidence from evidence, not existence**: ``1 - exp(-w / k)``
  over the decayed observation count — one stray probe moves an edge a
  little, a stream of them moves it all the way. Edges past
  ``stale_s`` without an observation report confidence 0 (the
  staleness window): the blend falls back to the model/physics base,
  so a dead probe fleet degrades serving to exactly the frozen world.
- **A bounded observation window** rides along for the continuous
  trainer: (edge, hour, seconds) triples in a preallocated ring.

Thread-safe; ``fold`` and ``snapshot`` are the whole hot API.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Optional

import numpy as np


class LiveSnapshot(NamedTuple):
    """One exported congestion-state generation."""

    epoch: int
    obs_time_s: np.ndarray     # (E,) EWMA travel seconds (freeflow init)
    conf: np.ndarray           # (E,) 0..1 blend weight
    n_obs_edges: int           # edges inside the staleness window
    total_obs: int             # observations folded since birth
    taken_unix: float


class CongestionState:
    """Per-edge EWMA travel-time estimator with staleness windows."""

    def __init__(self, freeflow_time_s: np.ndarray, *,
                 half_life_s: float = 60.0, stale_s: float = 300.0,
                 conf_obs: float = 3.0, window: int = 65536) -> None:
        self.n_edges = len(freeflow_time_s)
        self.half_life_s = float(half_life_s)
        self.stale_s = float(stale_s)
        self.conf_obs = max(float(conf_obs), 1e-6)
        self._lock = threading.Lock()
        self._val = np.asarray(freeflow_time_s, np.float64).copy()
        self._w = np.zeros(self.n_edges, np.float64)
        self._last = np.full(self.n_edges, -np.inf)
        self._epoch = 0
        self._total_obs = 0
        # Trainer window: preallocated ring of (edge, hour, seconds).
        self._win_n = max(int(window), 1)
        self._win_edge = np.zeros(self._win_n, np.int64)
        self._win_hour = np.zeros(self._win_n, np.int32)
        self._win_time = np.zeros(self._win_n, np.float32)
        self._win_pos = 0
        self._win_len = 0

    def fold(self, edges: np.ndarray, times_s: np.ndarray,
             t: Optional[float] = None,
             hour: Optional[int] = None) -> int:
        """Fold one observation batch; returns observations applied.

        Duplicate edges within a batch fold as one decayed update with
        their mean (order inside a batch carries no information — the
        publisher stamped them with one timestamp)."""
        edges = np.asarray(edges, np.int64)
        times_s = np.asarray(times_s, np.float64)
        ok = ((edges >= 0) & (edges < self.n_edges)
              & np.isfinite(times_s) & (times_s > 0))
        if not ok.all():
            edges, times_s = edges[ok], times_s[ok]
        if len(edges) == 0:
            return 0
        now = time.time() if t is None else float(t)
        if hour is None:
            hour = time.localtime(now).tm_hour
        uniq, inv = np.unique(edges, return_inverse=True)
        sums = np.bincount(inv, weights=times_s)
        counts = np.bincount(inv).astype(np.float64)
        with self._lock:
            decay = 0.5 ** np.clip(
                (now - self._last[uniq]) / self.half_life_s, 0.0, 64.0)
            w_old = self._w[uniq] * decay
            self._val[uniq] = ((self._val[uniq] * w_old + sums)
                               / (w_old + counts))
            self._w[uniq] = w_old + counts
            # Only move last-seen forward: replayed/buffered batches
            # with old stamps must not un-stale an edge. (Plain setitem
            # — fancy-indexed views are copies, ``out=`` would be lost.)
            self._last[uniq] = np.maximum(self._last[uniq], now)
            self._total_obs += int(len(edges))
            # Window append (vectorized ring write).
            k = len(edges)
            pos = (self._win_pos + np.arange(k)) % self._win_n
            self._win_edge[pos] = edges
            self._win_hour[pos] = int(hour) % 24
            self._win_time[pos] = times_s
            self._win_pos = int((self._win_pos + k) % self._win_n)
            self._win_len = min(self._win_len + k, self._win_n)
        return int(len(edges))

    def snapshot(self, now: Optional[float] = None) -> LiveSnapshot:
        """Export the current estimate; bumps the epoch counter."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self._epoch += 1
            age = now - self._last
            fresh = (self._w > 0) & (age <= self.stale_s)
            conf = np.where(
                fresh, 1.0 - np.exp(-self._w / self.conf_obs), 0.0)
            return LiveSnapshot(
                epoch=self._epoch,
                obs_time_s=self._val.astype(np.float32),
                conf=conf.astype(np.float32),
                n_obs_edges=int(fresh.sum()),
                total_obs=self._total_obs,
                taken_unix=now)

    def window(self) -> Dict[str, np.ndarray]:
        """The recent observation window (trainer input), oldest first."""
        with self._lock:
            n = self._win_len
            if n < self._win_n:
                sel = np.arange(n)
            else:
                sel = (self._win_pos + np.arange(n)) % self._win_n
            return {"edge": self._win_edge[sel].copy(),
                    "hour": self._win_hour[sel].copy(),
                    "time_s": self._win_time[sel].copy()}

    def stats(self) -> Dict:
        """Health-block view (cheap; no epoch bump)."""
        now = time.time()
        with self._lock:
            fresh = (self._w > 0) & ((now - self._last) <= self.stale_s)
            n_fresh = int(fresh.sum())
            conf_mean = float(
                (1.0 - np.exp(-self._w[fresh] / self.conf_obs)).mean()
            ) if n_fresh else 0.0
            return {"edges": self.n_edges,
                    "edges_observed": n_fresh,
                    "confidence_mean": round(conf_mean, 4),
                    "total_observations": self._total_obs,
                    "epoch": self._epoch,
                    "window_len": self._win_len}
