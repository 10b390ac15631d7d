"""SSE event bus: per-channel pub/sub feeding ``GET /api/realtime_feed``.

The counterpart of ``routest_tpu/serve/bus.py``. The reference
publishes tracker updates through flask-sse → Redis
(``Flaskr/routes.py:86``, ``__init__.py:25-28``); a single-process
server gets the same semantics from an in-memory bus with a replay ring,
so an SSE client reconnecting with ``Last-Event-ID`` resumes where it
left off, and a fleet of replicas shares one through the TCP broker of
``serve/netbus.py`` (``REDIS_URL=tcp://host:port``). The Redis client is
not ported: :func:`make_bus` refuses a ``redis://`` URL, and a
configured broker that does not answer fails the boot, rather than serve
a single-process bus where a fleet-wide one was asked for.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional


class InMemoryBus:
    """Per-channel fan-out with bounded subscriber queues.

    Events carry per-channel monotonically increasing ids and a bounded
    replay ring, so an SSE client reconnecting with ``Last-Event-ID``
    resumes without losing ticks. Replay and live delivery are
    serialized under one lock: publish assigns the id, appends history,
    and snapshots subscribers atomically — a concurrent subscriber
    either replays an event from history or receives it live, never
    both, never neither.
    """

    MAX_CHANNELS = 1024  # replay-state cap (channel names are client data)

    def __init__(self, max_queue: int = 256, history: int = 64) -> None:
        self._lock = threading.Lock()
        self._subscribers: Dict[str, List[queue.Queue]] = {}
        self._max_queue = max_queue
        self._history_len = history
        self._next_id: Dict[str, int] = {}
        self._history: Dict[str, List] = {}  # channel -> [(id, data), …]
        self._last_pub: Dict[str, float] = {}

    def _evict_stale_locked(self, incoming: Optional[str] = None) -> None:
        """At MAX_CHANNELS, drop the least-recently published channels
        WITHOUT live subscribers. ``incoming`` is the channel about to be
        inserted; counting it keeps the bound exact (eviction runs
        before insertion)."""
        overflow = len(self._history) - self.MAX_CHANNELS
        if incoming is not None and incoming not in self._history:
            overflow += 1
        if overflow <= 0:
            return
        idle = sorted(
            (ch for ch in self._history if not self._subscribers.get(ch)),
            key=lambda ch: self._last_pub.get(ch, 0.0))
        for ch in idle[:overflow]:
            self._history.pop(ch, None)
            self._next_id.pop(ch, None)
            self._last_pub.pop(ch, None)

    def publish(self, channel: str, data: dict) -> int:
        with self._lock:
            self._evict_stale_locked(incoming=channel)
            event_id = self._next_id.get(channel, 0) + 1
            self._next_id[channel] = event_id
            self._last_pub[channel] = time.monotonic()
            ring = self._history.setdefault(channel, [])
            ring.append((event_id, data))
            del ring[: max(0, len(ring) - self._history_len)]
            subs = list(self._subscribers.get(channel, ()))
        delivered = 0
        for q in subs:
            try:
                q.put_nowait((event_id, data))
                delivered += 1
            except queue.Full:
                # Slow consumer: drop oldest, keep the stream live.
                try:
                    q.get_nowait()
                    q.put_nowait((event_id, data))
                    delivered += 1
                except (queue.Empty, queue.Full):
                    pass
        return delivered

    def subscribe(self, channel: str,
                  last_event_id: Optional[int] = None) -> "Subscription":
        q: queue.Queue = queue.Queue(maxsize=self._max_queue)
        with self._lock:
            if last_event_id is not None:
                for event_id, data in self._history.get(channel, ()):
                    if event_id > last_event_id:
                        try:
                            q.put_nowait((event_id, data))
                        except queue.Full:
                            break
            self._subscribers.setdefault(channel, []).append(q)
        return Subscription(self, channel, q)

    def _unsubscribe(self, channel: str, q: queue.Queue) -> None:
        with self._lock:
            subs = self._subscribers.get(channel)
            if subs and q in subs:
                subs.remove(q)
                if not subs:
                    del self._subscribers[channel]

    def ping(self) -> bool:
        return True

    @property
    def kind(self) -> str:
        return "memory"


class Subscription:
    def __init__(self, bus: InMemoryBus, channel: str, q: queue.Queue) -> None:
        self._bus = bus
        self.channel = channel
        self._queue = q
        self.last_id: Optional[int] = None  # id of the last get()'s event

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        try:
            event_id, data = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None
        self.last_id = event_id
        return data

    def close(self) -> None:
        self._bus._unsubscribe(self.channel, self._queue)

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_bus(redis_url: Optional[str]):
    """Bus from the ``REDIS_URL`` scheme: unset → the in-memory bus;
    ``tcp://`` → :class:`~routest_tpu_torch.serve.netbus.NetBus` on the
    cross-process broker, with subscriber auto-reconnect
    (``RTPU_NETBUS_RECONNECT_S``, default 30 s of broker downtime before
    an SSE stream gives up) and the bounded publish replay buffer.

    Unlike the JAX package, which serves an in-memory bus when the
    broker does not answer, a configured broker that does not answer
    ``ping`` raises: a replica serving SSE from its own process would
    split the fleet's streams silently, so the boot fails and the fleet
    supervisor's backoff restarts it. ``redis://`` raises too (no Redis
    client is ported)."""
    if not redis_url:
        return InMemoryBus()
    if not redis_url.startswith("tcp://"):
        raise RuntimeError(
            f"make_bus: REDIS_URL={redis_url!r}: only the tcp:// broker "
            f"(serve/netbus.py) is ported, not Redis (unset REDIS_URL for "
            f"a single-process bus)")
    from routest_tpu_torch.serve.netbus import NetBus

    try:
        reconnect_s = float(os.environ.get("RTPU_NETBUS_RECONNECT_S") or 30.0)
    except ValueError:
        reconnect_s = 30.0
    bus = NetBus(redis_url, reconnect_s=reconnect_s)
    if not bus.ping():
        raise RuntimeError(
            f"make_bus: the broker at REDIS_URL={redis_url!r} does not "
            f"answer")
    return bus


def sse_stream(subscription, keepalive_s: float = 15.0,
               max_events: Optional[int] = None) -> Iterator[bytes]:
    """Subscription → text/event-stream byte chunks (SSE wire format):
    an ``id:`` line (so an EventSource reconnect resumes through
    ``Last-Event-ID``) and a ``data:`` line per event, a ``: keepalive``
    comment after ``keepalive_s`` of silence, and the end of the stream
    after ``max_events`` events. A subscription that reports ``closed``
    ends the stream instead of keepaliving forever."""
    sent = 0
    with subscription:
        while max_events is None or sent < max_events:
            data = subscription.get(timeout=keepalive_s)
            if data is None:
                if getattr(subscription, "closed", False):
                    return
                yield b": keepalive\n\n"
                continue
            event_id = getattr(subscription, "last_id", None)
            prefix = f"id: {event_id}\n".encode() if event_id is not None \
                else b""
            yield prefix + f"data: {json.dumps(data)}\n\n".encode()
            sent += 1
