"""Per-request latency stats and ``torch.profiler`` device traces.

The counterpart of ``routest_tpu/utils/profiling.py``:

- ``RequestStats``: the per-route view behind ``/api/metrics``'s
  ``http`` section, backed by the registry's metric types (a
  log-bucket histogram + an error counter per route);
- ``DeviceTrace``: a ``torch.profiler`` capture (CPU activity, plus
  CUDA activity when the traced device is the card) written as a
  Chrome trace, the counterpart of the JAX module's ``device_trace``. ``torch.profiler`` is process-wide, so every
  capture in the process (a sampled span's device trace, the triggered
  profiler, a kernel count) holds the one slot :func:`profiler_slot`
  guards; a capture that finds it taken is refused with
  :class:`ProfilerBusy`, never queued behind the other.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

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


class ProfilerBusy(RuntimeError):
    """Another ``torch.profiler`` capture holds the process's slot."""


_slot = threading.Lock()
_slot_holder: Optional[str] = None


@contextlib.contextmanager
def profiler_slot(who: str) -> Iterator[None]:
    """Hold the process's one ``torch.profiler`` slot for the block, or
    raise :class:`ProfilerBusy` naming the holder (never waits)."""
    global _slot_holder
    if not _slot.acquire(blocking=False):
        raise ProfilerBusy(f"torch.profiler is busy ({_slot_holder}); "
                           f"{who} refused")
    _slot_holder = who
    try:
        yield
    finally:
        _slot_holder = None
        _slot.release()


class DeviceTrace:
    """One ``torch.profiler`` capture from :meth:`start` to :meth:`stop`
    (same thread: the profiler's state is per-thread), exported to
    ``path`` as a Chrome trace. CUDA activity is recorded when
    ``device`` is the card, CPU activity always. Holds the profiler
    slot in between; a failed start releases it and raises."""

    def __init__(self, path: str, device="cuda", who: str = "trace") -> None:
        import torch

        self.path = path
        self.cuda = torch.device(device).type == "cuda"
        self.who = who
        self._prof = None
        self._slot = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        slot = profiler_slot(self.who)
        slot.__enter__()
        try:
            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
        except BaseException:
            slot.__exit__(None, None, None)
            raise
        self._prof, self._slot = prof, slot

    def stop(self) -> None:
        """End the capture and write the Chrome trace; the slot is
        released whatever happens."""
        prof, slot = self._prof, self._slot
        self._prof = self._slot = None
        if prof is None:
            return
        try:
            if self.cuda:
                import torch

                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            prof.export_chrome_trace(self.path)
        finally:
            slot.__exit__(None, None, None)
