"""SSE event bus: per-channel pub/sub feeding ``GET /api/realtime_feed``.

The counterpart of ``routest_tpu/serve/bus.py``. The reference
publishes tracker updates through flask-sse → Redis
(``Flaskr/routes.py:86``, ``__init__.py:25-28``); a single-process
server gets the same semantics from an in-memory bus with a replay ring,
so an SSE client reconnecting with ``Last-Event-ID`` resumes where it
left off. Processes share one bus through a Redis server
(``REDIS_URL=redis://…`` or ``rediss://…``: :class:`RedisBus`, over the
port's own RESP2 client in ``serve/resp.py``) or the TCP broker of
``serve/netbus.py`` (``REDIS_URL=tcp://host:port``). A configured
server that does not answer fails the boot, rather than serve a
single-process bus where a shared one was asked for.
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


class RedisBus:
    """The bus over a Redis server's pub/sub, with the JAX ``RedisBus``'s
    contract: ``publish`` sends ``PUBLISH channel json.dumps(data)``
    (the bytes the JAX bus sends, so replicas of both packages can
    share one server) and returns the receiver count; a broken
    connection is reconnected once and the command resent, and a server
    that still does not answer raises ``ConnectionError``. Publishes
    from any thread share one command connection under a lock; each
    subscription has a connection of its own. Redis keeps no history,
    so ``subscribe``'s ``last_event_id`` is accepted and ignored and
    the SSE stream carries no ``id:`` lines, as on the JAX stack."""

    def __init__(self, url: str) -> None:
        from routest_tpu_torch.serve.resp import parse_url, redact_url

        self._url = parse_url(url)
        self.url = redact_url(url)  # the form errors and logs may show
        self._lock = threading.Lock()
        self._conn = None
        self.last_error: Optional[str] = None

    def _command(self, *args):
        from routest_tpu_torch.serve.resp import Connection, RedisError

        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        conn = Connection(self._url)
                        # rtpulint: disable=blocking-call-under-lock -- the lock IS the command connection's serialization point: one command in flight, as redis-py's connection
                        conn.connect()
                        self._conn = conn
                    # rtpulint: disable=blocking-call-under-lock -- as above: a reply must be read by the thread that sent its command
                    return self._conn.command(*args)
                except RedisError:
                    raise
                except OSError as e:  # ConnectionError and ssl errors too
                    if self._conn is not None:
                        self._conn.close()
                        self._conn = None
                    if attempt:
                        raise ConnectionError(
                            f"the Redis server at {self.url} does not "
                            f"answer: {type(e).__name__}: {e}") from None
        raise ConnectionError("unreachable")  # pragma: no cover

    def publish(self, channel: str, data: dict) -> int:
        return int(self._command("PUBLISH", channel, json.dumps(data)))

    def subscribe(self, channel: str,
                  last_event_id: Optional[int] = None) -> "_RedisSubscription":
        """A subscription to ``channel``, returned once the server has
        confirmed the ``SUBSCRIBE`` (a publish after the return reaches
        it). ``last_event_id`` is ignored: pub/sub has no history."""
        sub = _RedisSubscription(self, channel)
        sub._open()
        return sub

    def ping(self) -> bool:
        """True when the server answers ``PING`` (connecting and
        authenticating first when needed); never raises. Why it did not
        answer is kept in ``last_error``."""
        try:
            ok = self._command("PING") == "PONG"
        except Exception as e:  # rtpulint: disable=broad-except-unlogged -- health probe: any failure maps to False, and its words are kept in last_error
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        self.last_error = None
        return ok

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    @property
    def kind(self) -> str:
        return "redis"


class _RedisSubscription:
    """One channel on a connection of its own. ``get`` skips the
    server's subscribe confirmations and subscribed-mode ``PING``
    replies: a ``PING`` goes out after ``PING_IDLE_S`` of silence, and
    a connection that then stays silent another ``PING_IDLE_S`` is
    broken (a server gone without closing the socket). When the
    connection breaks, ``get`` reconnects, handshakes and resubscribes
    at once and returns ``None``; while the server stays away it sets
    ``closed``, and the consumer ends its stream or subscribes again.
    No ``last_id``: the SSE stream writes no ``id:`` lines."""

    PING_IDLE_S = 5.0

    def __init__(self, bus: RedisBus, channel: str) -> None:
        self._bus = bus
        self.channel = channel
        self._conn = None
        self._heard = time.monotonic()   # the last reply's instant
        self._pinged: Optional[float] = None  # an unanswered PING's
        self.closed = False

    def _open(self) -> None:
        from routest_tpu_torch.serve.resp import Connection, RedisError

        conn = Connection(self._bus._url)
        conn.connect()
        try:
            conn.send("SUBSCRIBE", self.channel)
            while True:
                r = conn.read_reply()
                if isinstance(r, RedisError):
                    raise ConnectionError(
                        f"SUBSCRIBE {self.channel!r} refused: {r}")
                if (isinstance(r, list) and len(r) == 3
                        and r[0] == b"subscribe"):
                    break
        except BaseException:
            conn.close()
            raise
        self._conn = conn
        self._heard, self._pinged = time.monotonic(), None

    def _reopen(self, error: BaseException) -> None:
        from routest_tpu_torch.utils.logging import get_logger

        log = get_logger("routest_tpu_torch.serve.bus")
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        try:
            self._open()
        except Exception as e:  # OSError, RedisError: the server is away
            self.closed = True
            log.warning("redis_subscription_closed", url=self._bus.url,
                        channel=self.channel,
                        error=f"{type(e).__name__}: {e}")
            return
        log.info("redis_resubscribed", url=self._bus.url,
                 channel=self.channel,
                 after=f"{type(error).__name__}: {error}")

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        """The next message's payload, decoded from JSON, or ``None``
        once ``timeout`` seconds have passed (``None`` or 0: what has
        arrived, without waiting)."""
        from routest_tpu_torch.serve.resp import RedisError

        deadline = time.monotonic() + (timeout or 0.0)
        while True:
            remaining = deadline - time.monotonic()
            if self.closed:
                # a closed subscription never delivers: sleep out the
                # budget so a polling consumer does not spin
                if remaining > 0:
                    time.sleep(remaining)
                return None
            now = time.monotonic()
            try:
                if self._pinged is None:
                    if now - self._heard >= self.PING_IDLE_S:
                        self._conn.send("PING")
                        self._pinged = now
                elif now - self._pinged >= self.PING_IDLE_S:
                    raise ConnectionError(
                        f"no reply to PING in {self.PING_IDLE_S} s")
                r = self._conn.read_reply(max(remaining, 0.0))
            except TimeoutError:
                return None
            except OSError as e:  # the connection broke
                self._reopen(e)
                return None
            self._heard, self._pinged = time.monotonic(), None
            if isinstance(r, RedisError):
                self._reopen(ConnectionError(str(r)))
                return None
            if (isinstance(r, list) and len(r) == 3 and r[0] == b"message"
                    and isinstance(r[2], bytes)):
                try:
                    return json.loads(r[2])
                except ValueError:
                    from routest_tpu_torch.utils.logging import get_logger

                    get_logger("routest_tpu_torch.serve.bus").warning(
                        "redis_message_not_json", channel=self.channel,
                        size=len(r[2]))
            # subscribe/unsubscribe confirmations, pong: not messages

    def close(self) -> None:
        self.closed = True
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.send("UNSUBSCRIBE", self.channel)
            except OSError:
                pass  # the server is gone: nothing to leave
            conn.close()

    def __enter__(self) -> "_RedisSubscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def make_bus(redis_url: Optional[str]):
    """Bus from the ``REDIS_URL`` scheme, as the JAX ``make_bus``
    dispatches: unset → the in-memory bus; ``redis://`` and
    ``rediss://`` → :class:`RedisBus`; ``tcp://`` →
    :class:`~routest_tpu_torch.serve.netbus.NetBus` on the cross-process
    broker, with subscriber auto-reconnect (``RTPU_NETBUS_RECONNECT_S``,
    default 30 s of broker downtime before an SSE stream gives up) and
    the bounded publish replay buffer.

    Unlike the JAX package, which serves an in-memory bus when the
    server does not answer, a configured server that does not answer
    ``ping`` (or refuses the ``AUTH``) raises: a replica serving SSE
    from its own process would split the fleet's streams silently, so
    the boot fails and the fleet supervisor's backoff restarts it. Any
    other scheme raises too. Errors name the URL with its password
    redacted."""
    if not redis_url:
        return InMemoryBus()
    from routest_tpu_torch.serve.resp import redact_url

    shown = redact_url(redis_url)
    if redis_url.startswith(("redis://", "rediss://")):
        try:
            bus = RedisBus(redis_url)
        except ValueError as e:
            raise RuntimeError(f"make_bus: REDIS_URL={shown!r}: {e}") \
                from None
        if not bus.ping():
            raise RuntimeError(
                f"make_bus: the Redis server at REDIS_URL={shown!r} does "
                f"not answer ({bus.last_error})")
        return bus
    if not redis_url.startswith("tcp://"):
        raise RuntimeError(
            f"make_bus: REDIS_URL={shown!r}: the scheme must be redis://, "
            f"rediss:// or tcp:// (unset REDIS_URL for a single-process "
            f"bus)")
    from routest_tpu_torch.serve.netbus import NetBus

    try:
        reconnect_s = float(os.environ.get("RTPU_NETBUS_RECONNECT_S") or 30.0)
    except ValueError:
        reconnect_s = 30.0
    bus = NetBus(redis_url, reconnect_s=reconnect_s)
    if not bus.ping():
        raise RuntimeError(
            f"make_bus: the broker at REDIS_URL={shown!r} does not "
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
