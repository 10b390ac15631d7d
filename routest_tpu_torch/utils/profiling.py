"""Per-request latency stats for the serving layer.

The counterpart of ``routest_tpu/utils/profiling.py``'s ``RequestStats``:
the per-route view behind ``/api/metrics``'s ``http`` section, backed by
the registry's metric types (a log-bucket histogram + an error counter
per route). The JAX module's ``device_trace`` (``jax.profiler``) has no
counterpart here.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from routest_tpu_torch.obs.registry import MetricsRegistry


class RequestStats:
    """Per-route latency/error accumulators with the snapshot shape
    (count, errors, mean_ms, p50/p95/p99_ms). Each instance owns a
    private :class:`MetricsRegistry`, so apps do not see each other's
    counts; pass ``registry`` to aggregate several components into one.
    Percentiles are interpolated from the fixed log-scale buckets."""

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        self._hist = self.registry.histogram(
            "request_duration_seconds", "Per-route request latency.",
            ("route",))
        self._errors = self.registry.counter(
            "request_errors_total", "Per-route server errors (>=500).",
            ("route",))
        self.started = time.time()

    def add(self, route: str, seconds: float, error: bool = False) -> None:
        self._hist.labels(route=route).observe(seconds)
        if error:
            self._errors.labels(route=route).inc()

    def snapshot(self) -> Dict:
        routes: Dict[str, Dict] = {}
        errors = {key[0]: c.value for key, c in self._errors.items()}
        for key, h in self._hist.items():
            route = key[0]
            if not h.count:
                routes[route] = {"count": 0}
                continue
            routes[route] = {
                "count": h.count,
                "errors": int(errors.get(route, 0)),
                "mean_ms": round(1000.0 * h.sum / h.count, 3),
                "p50_ms": round(1000.0 * h.quantile(0.50), 3),
                "p95_ms": round(1000.0 * h.quantile(0.95), 3),
                "p99_ms": round(1000.0 * h.quantile(0.99), 3),
            }
        return {
            "uptime_s": round(time.time() - self.started, 1),
            "routes": routes,
        }
