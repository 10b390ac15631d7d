"""Background metric customizer: congestion state → router flip.

The counterpart of ``routest_tpu/live/customize.py``. Every
``interval_s``: snapshot the estimator, blend its per-edge observations
with the model/physics base (``conf * obs + (1 - conf) * base`` —
confident fresh edges follow the probes, stale/unseen edges follow the
GNN regime), and hand the blended metric to
``RoadRouter.install_live_metric``. Everything expensive (overlay
re-pricing on the router's device) happens here, on this thread, before
the flip — the serving path only ever sees a completed generation.

Failure containment: the chaos point ``live.customize`` fires at cycle
start, and any exception anywhere in the cycle — injection, snapshot,
blend, customization, install — counts a failed flip (recorded in the
change ledger) and leaves the previous metric generation serving
untouched. A cycle with too little evidence (``min_obs_edges``) skips
rather than flipping to a noise metric. A flip is a ``live.flip``
change.

Metrics: ``rtpu_live_metric_epoch``, ``rtpu_live_flips_total
{result}``, ``rtpu_live_customize_seconds``,
``rtpu_live_metric_staleness_seconds``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from routest_tpu_torch.chaos import ChaosError
from routest_tpu_torch.chaos import inject as chaos_inject
from routest_tpu_torch.live.state import CongestionState
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.utils.logging import get_logger

_metrics = None


def _cust_metrics():
    global _metrics
    if _metrics is None:
        reg = get_registry()
        _metrics = {
            "epoch": reg.gauge(
                "rtpu_live_metric_epoch",
                "Live-metric generation currently serving."),
            "flips": reg.counter(
                "rtpu_live_flips_total",
                "Metric-refresh cycles, by result "
                "(ok / skipped / chaos / failed).", ("result",)),
            "dur": reg.histogram(
                "rtpu_live_customize_seconds",
                "One metric refresh: snapshot + blend + overlay "
                "re-pricing, up to the flip."),
            "staleness": reg.gauge(
                "rtpu_live_metric_staleness_seconds",
                "Age of the serving live metric (seconds since the "
                "last successful flip)."),
        }
    return _metrics


class MetricCustomizer:
    """Periodic congestion-state → router metric refresh."""

    def __init__(self, router, state: CongestionState, *,
                 interval_s: float = 10.0, min_obs_edges: int = 1,
                 route_metric: bool = True) -> None:
        self._router = router
        self._state = state
        self.interval_s = float(interval_s)
        self.min_obs_edges = int(min_obs_edges)
        self.route_metric = bool(route_metric)
        self.flips = 0
        self.last_flip_unix: Optional[float] = None
        self.last_result: Dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self, now: Optional[float] = None) -> Dict:
        """One refresh cycle. Never raises: any failure is counted and
        reported while the previous metric generation keeps serving."""
        m = _cust_metrics()
        t0 = time.perf_counter()
        try:
            chaos_inject("live.customize")
        except ChaosError as e:
            m["flips"].labels(result="chaos").inc()
            record_change("live.customize_failed",
                          detail={"reason": f"chaos: {e}"})
            self.last_result = {"flipped": False, "reason": f"chaos: {e}"}
            return self.last_result
        try:
            snap = self._state.snapshot(now)
            if snap.n_obs_edges < self.min_obs_edges:
                m["flips"].labels(result="skipped").inc()
                self.last_result = {
                    "flipped": False,
                    "reason": f"evidence below floor "
                              f"({snap.n_obs_edges} < "
                              f"{self.min_obs_edges} edges)"}
                return self.last_result
            hour = time.localtime(snap.taken_unix).tm_hour
            base = self._router.edge_time_s(hour)
            blended = (snap.conf * snap.obs_time_s
                       + (1.0 - snap.conf) * base).astype(np.float32)
            info = self._router.install_live_metric(
                blended, snap.epoch, route=self.route_metric)
        except Exception as e:
            m["flips"].labels(result="failed").inc()
            record_change("live.customize_failed",
                          detail={"reason": f"{type(e).__name__}: {e}"})
            get_logger("routest_tpu_torch.live").error(
                "metric_refresh_failed",
                error=f"{type(e).__name__}: {e}")
            self.last_result = {"flipped": False,
                                "reason": f"{type(e).__name__}: {e}"}
            return self.last_result
        dur = time.perf_counter() - t0
        self.flips += 1
        self.last_flip_unix = time.time()
        m["flips"].labels(result="ok").inc()
        record_change("live.flip",
                      detail={"epoch": snap.epoch,
                              "obs_edges": snap.n_obs_edges})
        m["epoch"].set(snap.epoch)
        m["staleness"].set(0.0)
        m["dur"].observe(dur)
        self.last_result = {
            "flipped": True, "epoch": snap.epoch,
            "obs_edges": snap.n_obs_edges,
            "cycle_s": round(dur, 3), **info}
        return self.last_result

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.run_once()
            if self.last_flip_unix is not None:
                _cust_metrics()["staleness"].set(
                    round(time.time() - self.last_flip_unix, 3))

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="live-customize",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def snapshot(self) -> Dict:
        return {"interval_s": self.interval_s, "flips": self.flips,
                "route_metric": self.route_metric,
                "last_flip_unix": self.last_flip_unix,
                "last_result": dict(self.last_result)}
