"""Probe-stream ingest: bus subscriber → congestion state.

The counterpart of ``routest_tpu/live/ingest.py``. One subscription on
the probe channel per process; every received event's observations
convert speed → edge travel seconds (``length_m[e] / speed``) and fold
into :class:`CongestionState` in one vectorized call. Failures stay
local: a malformed event (fuzz, schema drift) is dropped with a reason
label, a fold that raises drops that batch (reason ``error``), and a
subscription that closes is re-subscribed with capped backoff (the
estimator goes stale, never wedged). The chaos point ``live.ingest``
fires per batch: an injected fault drops THAT batch (reason ``chaos``),
never the subscription.

Metrics: ``rtpu_live_obs_total``, ``rtpu_live_obs_dropped_total
{reason}``, ``rtpu_live_ingest_lag_seconds``, ``rtpu_live_resubscribes
_total``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from routest_tpu_torch.chaos import ChaosError
from routest_tpu_torch.chaos import inject as chaos_inject
from routest_tpu_torch.live.probes import DEFAULT_CHANNEL
from routest_tpu_torch.live.state import CongestionState
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.utils.logging import get_logger

_metrics = None


def _ingest_metrics():
    global _metrics
    if _metrics is None:
        reg = get_registry()
        _metrics = {
            "obs": reg.counter(
                "rtpu_live_obs_total",
                "Probe observations folded into congestion state."),
            "dropped": reg.counter(
                "rtpu_live_obs_dropped_total",
                "Probe batches dropped, by reason "
                "(chaos / malformed / error).", ("reason",)),
            "lag": reg.histogram(
                "rtpu_live_ingest_lag_seconds",
                "Publish-stamp to fold latency per probe batch."),
            "resub": reg.counter(
                "rtpu_live_resubscribes_total",
                "Probe subscriptions re-established after a close."),
        }
    return _metrics


class ProbeIngester:
    """Folds the probe channel into a :class:`CongestionState`."""

    def __init__(self, bus, state: CongestionState,
                 length_m: np.ndarray,
                 channel: str = DEFAULT_CHANNEL) -> None:
        self._bus = bus
        self._state = state
        self._length_m = np.asarray(length_m, np.float64)
        self.channel = channel
        self.batches = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def handle(self, event) -> int:
        """One probe event → state fold; returns observations applied
        (0 = dropped). Public so tests and the HTTP probe endpoint can
        drive ingestion without a bus round trip."""
        m = _ingest_metrics()
        try:
            chaos_inject("live.ingest")
        except ChaosError:
            m["dropped"].labels(reason="chaos").inc()
            return 0
        try:
            obs = event["obs"]
            edges = np.asarray([o[0] for o in obs], np.int64)
            speeds = np.asarray([o[1] for o in obs], np.float64)
            t = float(event.get("t") or time.time())
            hour = event.get("hour")
            hour = int(hour) % 24 if hour is not None else None
        except (KeyError, TypeError, ValueError, IndexError):
            m["dropped"].labels(reason="malformed").inc()
            return 0
        in_range = (edges >= 0) & (edges < len(self._length_m))
        good = in_range & np.isfinite(speeds) & (speeds > 0)
        if not good.any():
            m["dropped"].labels(reason="malformed").inc()
            return 0
        edges, speeds = edges[good], speeds[good]
        times_s = self._length_m[edges] / speeds
        try:
            applied = self._state.fold(edges, times_s, t=t, hour=hour)
        except Exception as e:  # drops THIS batch, never the stream
            m["dropped"].labels(reason="error").inc()
            get_logger("routest_tpu_torch.live").error(
                "probe_fold_failed", error=f"{type(e).__name__}: {e}")
            return 0
        self.batches += 1
        m["obs"].inc(applied)
        m["lag"].observe(max(0.0, time.time() - t))
        return applied

    def _run(self) -> None:
        log = get_logger("routest_tpu_torch.live")
        backoff = 0.2
        while not self._stop.is_set():
            try:
                sub = self._bus.subscribe(self.channel)
            except Exception as e:
                log.warning("probe_subscribe_failed", channel=self.channel,
                            error=f"{type(e).__name__}: {e}")
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = 0.2
            try:
                while not self._stop.is_set():
                    data = sub.get(timeout=0.5)
                    if data is not None:
                        self.handle(data)
                    elif getattr(sub, "closed", False):
                        _ingest_metrics()["resub"].inc()
                        log.warning("probe_subscription_closed",
                                    channel=self.channel)
                        break
            finally:
                sub.close()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="live-ingest", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
