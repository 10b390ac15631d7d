"""Active-dispatch registry: the state the re-optimization loop watches.

Copied from ``routest_tpu/dispatch/registry.py`` (host-only Python).

A confirmed dispatch (``POST /api/dispatch`` with ``confirm``, or the
reference-shaped ``POST /api/confirm_route``) registers here with
everything a later re-solve needs: the stop coordinates (its corridor),
the solved plan, the plan's cost under the metric it was priced on
(``baseline_cost``), the SSE channel the driver sim streams on, and the
optional ``sim_seed`` so a re-targeted simulation replays
deterministically. ``dispatch/reopt.py`` walks this registry on every
live-metric epoch flip.

Bounded (``RTPU_DISPATCH_MAX_ACTIVE``): oldest dispatches evict first —
an abandoned sim thread must not pin registry slots forever. All
methods are lock-guarded; snapshots are plain dicts for ``/api/dispatch``
state reads.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from routest_tpu_torch.obs import get_registry

_m_active = get_registry().gauge(
    "rtpu_dispatch_active",
    "Active (confirmed, not completed) dispatches registered for "
    "re-optimization.")


class ActiveDispatch:
    __slots__ = ("id", "channel", "latlon", "demands", "capacity",
                 "max_cost", "tw_open", "tw_close", "plan",
                 "baseline_cost", "epoch", "sim_seed", "driver_details",
                 "destinations", "created_unix", "updates", "source")

    def __init__(self, id: str, channel: str, latlon, demands,
                 capacity: float, max_cost: float, plan: dict,
                 baseline_cost: float, epoch: int,
                 tw_open=None, tw_close=None,
                 sim_seed: Optional[int] = None,
                 driver_details: Optional[dict] = None,
                 destinations: Optional[list] = None,
                 source: str = "dispatch") -> None:
        self.id = id
        self.channel = channel
        # (N+1, 2) lat/lon, row 0 = depot — None for matrix-mode
        # dispatches (no geography to re-price; reopt skips them).
        self.latlon = None if latlon is None \
            else np.asarray(latlon, np.float32)
        self.demands = np.asarray(demands, np.float32)
        self.capacity = float(capacity)
        self.max_cost = float(max_cost)
        self.tw_open = None if tw_open is None \
            else np.asarray(tw_open, np.float32)
        self.tw_close = None if tw_close is None \
            else np.asarray(tw_close, np.float32)
        self.plan = plan
        self.baseline_cost = float(baseline_cost)
        self.epoch = int(epoch)
        self.sim_seed = sim_seed
        self.driver_details = driver_details or {}
        self.destinations = destinations
        self.source = source
        self.created_unix = time.time()
        self.updates = 0

    def snapshot(self) -> dict:
        return {
            "dispatch_id": self.id,
            "channel": self.channel,
            "stops": 0 if self.latlon is None else len(self.latlon) - 1,
            "plan": self.plan,
            "baseline_cost": round(self.baseline_cost, 3),
            "epoch": self.epoch,
            "sim_seed": self.sim_seed,
            "source": self.source,
            "updates": self.updates,
            "created_unix": int(self.created_unix),
        }


class DispatchRegistry:
    def __init__(self, max_active: int = 256) -> None:
        self.max_active = int(max_active)
        self._lock = threading.Lock()
        self._active: "OrderedDict[str, ActiveDispatch]" = OrderedDict()
        self._seq = itertools.count(1)
        self._completed = 0
        self._evicted = 0

    def register(self, **kwargs) -> ActiveDispatch:
        """Register a confirmed dispatch; returns the record (its ``id``
        is minted here unless the caller brought one)."""
        did = kwargs.pop("id", None) or f"d{next(self._seq)}"
        if not kwargs.get("channel"):
            kwargs["channel"] = did  # anonymous dispatches stream on id
        rec = ActiveDispatch(id=did, **kwargs)
        with self._lock:
            self._active[did] = rec
            while len(self._active) > self.max_active:
                self._active.popitem(last=False)
                self._evicted += 1
            _m_active.set(len(self._active))
        return rec

    def complete(self, dispatch_id: str) -> bool:
        with self._lock:
            found = self._active.pop(dispatch_id, None) is not None
            if found:
                self._completed += 1
            _m_active.set(len(self._active))
            return found

    def get(self, dispatch_id: str) -> Optional[ActiveDispatch]:
        with self._lock:
            return self._active.get(dispatch_id)

    def active(self) -> List[ActiveDispatch]:
        with self._lock:
            return list(self._active.values())

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "active": len(self._active),
                "max_active": self.max_active,
                "completed": self._completed,
                "evicted": self._evicted,
                "dispatches": [d.snapshot()
                               for d in self._active.values()],
            }
