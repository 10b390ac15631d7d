"""Cross-region probe-bus bridge: one region's live state, replicated.

The counterpart of ``routest_tpu/live/bridge.py``. ``POST /api/probe``
only publishes, and every replica folds from its own subscription; a
bridge generalizes that across regions: it subscribes to the probe
channel on its source region's bus and republishes every frame into
the destination region's bus, so both regions' congestion estimators
converge on the same metric from one probe fleet. Two bridges (A→B and
B→A) make the pair active-active.

Loop suppression is structural, not probabilistic: the FIRST bridge a
frame crosses stamps it with ``origin_region`` (locally-published
frames carry no tag), and every bridge drops frames already stamped
with its source or destination region — an A→B→A ring forwards each
frame exactly once per foreign region and can never amplify. Rings of
three or more regions forward a foreign-origin frame transitively
(origin ≠ destination) and still terminate where the frame began.

Failure isolation mirrors ``live/ingest.py``: the subscribe side
re-subscribes with capped backoff when the source broker dies; the
publish side leans on the netbus degraded-mode buffer (bounded FIFO +
reconnect replay), so a destination-broker restart replays the frames
published while it was down — the "bridge replay" a rejoining region
catches up from. Chaos point ``region.bridge`` drops one frame
(counted), never the subscription.

Metrics: ``rtpu_region_bridge_frames_total{src,dst}``,
``rtpu_region_bridge_dropped_total{src,dst,reason}``,
``rtpu_region_bridge_lag_seconds``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from routest_tpu_torch.live.probes import DEFAULT_CHANNEL

_metrics = None


def _bridge_metrics():
    global _metrics
    if _metrics is None:
        from routest_tpu_torch.obs import get_registry

        reg = get_registry()
        _metrics = {
            "frames": reg.counter(
                "rtpu_region_bridge_frames_total",
                "Probe frames republished across regions, by direction.",
                ("src", "dst")),
            "dropped": reg.counter(
                "rtpu_region_bridge_dropped_total",
                "Probe frames the bridge dropped, by direction and "
                "reason (loop / malformed / chaos / publish_error).",
                ("src", "dst", "reason")),
            "lag": reg.histogram(
                "rtpu_region_bridge_lag_seconds",
                "Publish-stamp to republish latency per bridged frame."),
            "resub": reg.counter(
                "rtpu_region_bridge_resubscribes_total",
                "Bridge subscriptions re-established after a close, "
                "by direction.", ("src", "dst")),
        }
    return _metrics


class ProbeBridge:
    """One direction of cross-region live-state replication.

    ``src_bus``/``dst_bus`` are bus objects with the shared
    publish/subscribe contract (``serve/bus.py`` in-memory, or a
    ``NetBus`` pinned to each region's broker). ``handle(event)`` is
    public — tests and embedding harnesses can drive one frame through
    the tag/suppress/forward decision without a bus round trip."""

    def __init__(self, src_region: str, dst_region: str,
                 src_bus, dst_bus,
                 channel: str = DEFAULT_CHANNEL) -> None:
        if src_region == dst_region:
            raise ValueError("bridge endpoints must be distinct regions")
        self.src_region = src_region
        self.dst_region = dst_region
        self._src_bus = src_bus
        self._dst_bus = dst_bus
        self.channel = channel
        self.forwarded = 0
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def handle(self, event) -> bool:
        """One frame → tag, suppress, or forward; True = republished."""
        from routest_tpu_torch.chaos import ChaosError
        from routest_tpu_torch.chaos import inject as chaos_inject

        m = _bridge_metrics()
        labels = {"src": self.src_region, "dst": self.dst_region}
        if not isinstance(event, dict) or "obs" not in event:
            m["dropped"].labels(reason="malformed", **labels).inc()
            self.dropped += 1
            return False
        origin = event.get("origin_region")
        # Loop suppression: a frame stamped with the destination region
        # already lives there (or began there); one stamped with the
        # SOURCE region has come full circle around a ring. Either way,
        # forwarding it again is the amplification this tag exists to
        # prevent. Untagged frames are local originals — stamp them.
        if origin in (self.src_region, self.dst_region):
            m["dropped"].labels(reason="loop", **labels).inc()
            self.dropped += 1
            return False
        try:
            chaos_inject("region.bridge")
        except ChaosError:
            m["dropped"].labels(reason="chaos", **labels).inc()
            self.dropped += 1
            return False
        out = dict(event)
        if origin is None:
            out["origin_region"] = self.src_region
        try:
            self._dst_bus.publish(self.channel, out)
        except Exception:
            # Degraded-mode buses buffer internally; a bus that RAISES
            # has no replay path for this frame — count the loss.
            m["dropped"].labels(reason="publish_error", **labels).inc()
            self.dropped += 1
            return False
        self.forwarded += 1
        m["frames"].labels(**labels).inc()
        t = event.get("t")
        if isinstance(t, (int, float)):
            m["lag"].observe(max(0.0, time.time() - float(t)))
        return True

    def _run(self) -> None:
        from routest_tpu_torch.utils.logging import get_logger

        log = get_logger("routest_tpu_torch.live.bridge")
        backoff = 0.2
        while not self._stop.is_set():
            try:
                sub = self._src_bus.subscribe(self.channel)
            except Exception as e:
                log.warning("bridge_subscribe_failed",
                            src=self.src_region, dst=self.dst_region,
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
                        _bridge_metrics()["resub"].labels(
                            src=self.src_region,
                            dst=self.dst_region).inc()
                        log.warning("bridge_subscription_closed",
                                    src=self.src_region,
                                    dst=self.dst_region)
                        break
            finally:
                try:
                    sub.close()
                except OSError:
                    log.debug("bridge_subscription_close_failed",
                              src=self.src_region, dst=self.dst_region)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"probe-bridge-{self.src_region}-{self.dst_region}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def snapshot(self) -> dict:
        return {"src": self.src_region, "dst": self.dst_region,
                "channel": self.channel, "forwarded": self.forwarded,
                "dropped": self.dropped,
                "running": self._thread is not None
                and self._thread.is_alive()}
