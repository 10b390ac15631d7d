"""Cross-process pub/sub: a small TCP broker and its bus client.

The counterpart of ``routest_tpu/serve/netbus.py``, and the same wire
protocol: each package's client talks to the other's broker. The
reference fans SSE out across workers through Upstash Redis
(``Flaskr/__init__.py:25-28``: one worker receives the tracker POST,
another holds the browser's SSE socket). This module is the stdlib
equivalent for hosts without a Redis server: a broker speaking
newline-delimited JSON over TCP, and a ``NetBus`` client with the same
interface as ``InMemoryBus`` (publish / subscribe / ping).

Select it with ``REDIS_URL=tcp://host:port`` (``make_bus`` dispatches on
the scheme); run a broker with ``python -m routest_tpu_torch.serve.netbus``.

Protocol (one JSON object per line):
- ``{"op": "ping"}``                       → ``{"ok": true}``
- ``{"op": "publish", "channel": c, "data": …}``
                                           → ``{"ok": true, "receivers": n}``
- ``{"op": "subscribe", "channel": c}``    → ``{"ok": true}`` then a
  ``{"channel": c, "data": …}`` push line per published message; the
  connection stays open for the life of the subscription.

Not a Redis replacement — no persistence, no auth, loopback-trust
security model (bind 127.0.0.1 unless told otherwise).
"""

from __future__ import annotations

import collections
import json
import select
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, Optional, Set, Tuple
from urllib.parse import urlsplit

# A subscriber that stops reading (backgrounded browser tab, network
# stall) must never block publishes for everyone else: once its TCP
# window fills, sends time out after this long and the broker drops it.
_SEND_TIMEOUT_S = 1.0


class _BrokerHandler(socketserver.StreamRequestHandler):
    def setup(self) -> None:
        super().setup()
        # Serializes the handler thread's acks with fanout pushes from
        # publisher threads — without it a subscribe ack could interleave
        # with (or trail) the first pushed event.
        self._wlock = threading.Lock()

    def handle(self) -> None:  # one connection = publisher or subscriber
        server: Broker = self.server  # type: ignore[assignment]
        subscribed: Optional[str] = None
        try:
            for raw in self.rfile:
                try:
                    msg = json.loads(raw)
                    op = msg.get("op")
                except Exception:  # rtpulint: disable=broad-except-unlogged -- the error IS surfaced: the peer gets a structured bad-json reply
                    self._send({"ok": False, "error": "bad json"})
                    continue
                if op == "ping":
                    self._send({"ok": True})
                elif op == "publish":
                    n = server.fanout(str(msg.get("channel")), msg.get("data"))
                    self._send({"ok": True, "receivers": n})
                elif op == "subscribe":
                    subscribed = str(msg.get("channel"))
                    # SO_SNDTIMEO (send-only: blocking reads unaffected)
                    # bounds pushes to a stalled consumer.
                    self.connection.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", int(_SEND_TIMEOUT_S),
                                    int((_SEND_TIMEOUT_S % 1) * 1e6)))
                    lei = msg.get("last_event_id")
                    try:  # json floats include Infinity/NaN: int() raises
                        lei = int(lei) if isinstance(lei, (int, float)) \
                            else None
                    except (ValueError, OverflowError):
                        lei = None
                    # Event-id epochs: ids restart when a broker does, so
                    # a resume id from a PREVIOUS incarnation would
                    # silently skip everything already republished into
                    # this one. A client that proves it watched a
                    # different epoch gets the full ring instead.
                    client_epoch = msg.get("epoch")
                    if (lei is not None and client_epoch is not None
                            and client_epoch != server.epoch):
                        lei = 0
                    # Register-then-ack, both under the write lock: the
                    # ack must imply "registered" (a caller may publish
                    # immediately after subscribe() returns), while the
                    # lock keeps any concurrent fanout push from landing
                    # on the wire ahead of the ack — and therefore ahead
                    # of the replay lines, which must precede live
                    # events. Lock order is safe: fanout copies its
                    # targets out of _subs_lock before taking any
                    # handler's write lock; register+ring-copy are atomic
                    # under _subs_lock, so every event is replayed or
                    # pushed live, never both or neither.
                    with self._wlock:
                        replay = server.add_subscriber(subscribed, self, lei)
                        self.wfile.write(json.dumps(
                            {"ok": True, "epoch": server.epoch}
                        ).encode() + b"\n")
                        for line in replay:
                            self.wfile.write(line)
                        self.wfile.flush()
                else:
                    self._send({"ok": False, "error": f"unknown op {op!r}"})
        except (ConnectionError, OSError):
            pass
        finally:
            if subscribed is not None:
                server.drop_subscriber(subscribed, self)

    def _send(self, obj: dict) -> None:
        with self._wlock:
            self.wfile.write(json.dumps(obj).encode() + b"\n")
            self.wfile.flush()

    def push(self, line: bytes) -> bool:
        try:
            with self._wlock:
                self.wfile.write(line)
                self.wfile.flush()
            return True
        except (ConnectionError, OSError):
            # includes socket.timeout: a consumer that stayed stalled past
            # SO_SNDTIMEO gets dropped rather than blocking the channel
            return False


class Broker(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    HISTORY = 64  # replay-ring length per channel (matches InMemoryBus)
    MAX_CHANNELS = 1024  # replay-state cap (channel names are client data)

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__((host, port), _BrokerHandler)
        # Epoch: identifies this broker incarnation in subscribe acks;
        # event ids are only comparable within one epoch.
        import uuid as _uuid

        self.epoch = _uuid.uuid4().hex[:12]
        self._subs: Dict[str, Set[_BrokerHandler]] = {}
        self._subs_lock = threading.Lock()
        self._next_id: Dict[str, int] = {}
        self._history: Dict[str, list] = {}  # channel -> [(id, line), …]
        self._last_pub: Dict[str, float] = {}

    def _evict_stale_locked(self, now: float,
                            incoming: Optional[str] = None) -> None:
        """Bound replay state (same policy as InMemoryBus): at the cap,
        drop the least-recently published subscriber-less channels.
        ``incoming`` counts the channel about to be inserted so the
        bound holds exactly (eviction runs before insertion)."""
        overflow = len(self._history) - self.MAX_CHANNELS
        if incoming is not None and incoming not in self._history:
            overflow += 1
        if overflow <= 0:
            return
        idle = sorted((ch for ch in self._history if not self._subs.get(ch)),
                      key=lambda ch: self._last_pub.get(ch, 0.0))
        for ch in idle[:overflow]:
            self._history.pop(ch, None)
            self._next_id.pop(ch, None)
            self._last_pub.pop(ch, None)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def add_subscriber(self, channel: str, h: _BrokerHandler,
                       last_event_id: Optional[int] = None) -> list:
        """Register; returns the replay lines (id > last_event_id), copied
        atomically with registration so exactly-once holds vs fanout."""
        with self._subs_lock:
            self._subs.setdefault(channel, set()).add(h)
            if last_event_id is None:
                return []
            return [line for event_id, line
                    in self._history.get(channel, ())
                    if event_id > last_event_id]

    def drop_subscriber(self, channel: str, h: _BrokerHandler) -> None:
        with self._subs_lock:
            self._subs.get(channel, set()).discard(h)

    def fanout(self, channel: str, data) -> int:
        with self._subs_lock:
            now = time.monotonic()
            self._evict_stale_locked(now, incoming=channel)
            event_id = self._next_id.get(channel, 0) + 1
            self._next_id[channel] = event_id
            self._last_pub[channel] = now
            line = json.dumps({"channel": channel, "id": event_id,
                               "data": data}).encode() + b"\n"
            ring = self._history.setdefault(channel, [])
            ring.append((event_id, line))
            del ring[: max(0, len(ring) - self.HISTORY)]
            targets = list(self._subs.get(channel, ()))
        delivered = 0
        for h in targets:
            if h.push(line):
                delivered += 1
            else:
                self.drop_subscriber(channel, h)
                # Close the socket too: the peer must see EOF (so its SSE
                # stream ends and the client reconnects) rather than keep
                # polling a zombie subscription that will never deliver;
                # it also unblocks the handler thread.
                try:
                    h.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    h.connection.close()
                except OSError:
                    pass
        return delivered


def start_broker(host: str = "127.0.0.1",
                 port: int = 0) -> Tuple[Broker, threading.Thread]:
    """In-process broker (tests); returns (server, serving thread)."""
    broker = Broker(host, port)
    t = threading.Thread(target=broker.serve_forever, daemon=True)
    t.start()
    return broker, t


def _parse(url: str) -> Tuple[str, int]:
    parts = urlsplit(url)
    if parts.scheme != "tcp" or not parts.hostname or not parts.port:
        raise ValueError(f"netbus url must be tcp://host:port, got {url!r}")
    return parts.hostname, parts.port


class NetBus:
    """Bus client over a :class:`Broker` (interface-equal to
    ``InMemoryBus`` in ``serve/bus.py``).

    ``ack_timeout`` covers the broker's worst-case fanout stall: each
    stalled subscriber may cost up to ``_SEND_TIMEOUT_S`` before being
    dropped, so publish acks can lag several seconds without the publish
    having failed.

    Degraded mode (a broker restart must not lose the tracker feed):

    - a publish that dies at transport level is BUFFERED in a bounded
      replay ring and re-published by a background reconnect thread
      (capped-backoff ping loop) once the broker answers again —
      callers see ``0 receivers``, never an exception;
    - ``reconnect_s > 0`` makes subscriptions self-healing: a dropped
      subscription re-subscribes with its ``last_event_id`` (resuming
      from the broker's replay ring when it survived, or live when the
      broker restarted fresh) for up to ``reconnect_s`` seconds of
      broker downtime before reporting ``closed``. The default (0)
      keeps the historical contract — closed means closed, the SSE
      stream ends, the browser reconnects — which several tests and
      the slow-consumer drop policy rely on; ``make_bus`` opts the
      serving path in via ``RTPU_NETBUS_RECONNECT_S``.
    """

    def __init__(self, url: str, timeout: float = 2.0,
                 ack_timeout: float = 10.0, reconnect_s: float = 0.0,
                 replay_limit: int = 256) -> None:
        self._addr = _parse(url)
        self._timeout = timeout
        self._ack_timeout = ack_timeout
        self._reconnect_s = reconnect_s
        self._lock = threading.Lock()  # one command in flight on the conn
        self._conn: Optional[socket.socket] = None
        self._rfile = None
        self._replay_limit = max(1, replay_limit)
        self._replay: collections.deque = collections.deque()
        self._replay_lock = threading.Lock()
        self._reconnect_thread: Optional[threading.Thread] = None

    def _connect(self):
        conn = socket.create_connection(self._addr, timeout=self._timeout)
        conn.settimeout(self._ack_timeout)
        return conn, conn.makefile("rb")

    def _reset(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        self._conn = None
        self._rfile = None

    def _command(self, obj: dict, retry_after_ack_loss: bool) -> dict:
        """One request/response on the cached connection.

        Failure semantics: a SEND failure is always retried once (the
        request never reached the broker — typically a stale keep-alive).
        A failure while waiting for the ACK is retried only when
        ``retry_after_ack_loss`` — a publish may already have fanned out,
        and blindly re-sending would deliver the event twice to every
        healthy subscriber.
        """
        payload = json.dumps(obj).encode() + b"\n"
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._conn is None:
                        self._conn, self._rfile = self._connect()
                    # rtpulint: disable=blocking-call-under-lock -- the lock IS the socket's write-serialization point: concurrent publishers must not interleave frames
                    self._conn.sendall(payload)
                except (ConnectionError, OSError):
                    self._reset()
                    if attempt:
                        raise
                    continue  # send never landed: always safe to retry
                try:
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("broker closed connection")
                    return json.loads(line)
                except (ConnectionError, OSError, ValueError):
                    self._reset()
                    if attempt or not retry_after_ack_loss:
                        raise
        raise ConnectionError("unreachable")  # pragma: no cover

    def publish(self, channel: str, data: dict) -> int:
        from routest_tpu_torch.chaos import inject as chaos_inject
        from routest_tpu_torch.obs import get_registry
        from routest_tpu_torch.obs.trace import trace_span

        t0 = time.monotonic()
        with trace_span("netbus.publish", channel=channel) as sp:
            try:
                chaos_inject("netbus.publish")
                resp = self._command({"op": "publish", "channel": channel,
                                      "data": data},
                                     retry_after_ack_loss=False)
            except (ConnectionError, OSError) as e:
                # Broker down: buffer for replay instead of failing the
                # tracker POST — degraded, not down. Receivers=0 is
                # honest (nobody got it yet).
                self._buffer_publish(channel, data, e)
                sp.set_attr("buffered", True)
                return 0
            receivers = int(resp.get("receivers", 0))
            sp.set_attr("receivers", receivers)
        get_registry().histogram(
            "rtpu_netbus_publish_seconds",
            "Broker publish round-trip latency.").observe(
                time.monotonic() - t0)
        return receivers

    # ── degraded mode: publish replay + background reconnect ──────────

    def _buffer_publish(self, channel: str, data: dict,
                        error: BaseException) -> None:
        from routest_tpu_torch.obs import get_registry
        from routest_tpu_torch.utils.logging import get_logger

        with self._replay_lock:
            dropped = 0
            while len(self._replay) >= self._replay_limit:
                self._replay.popleft()   # bounded: oldest events lost
                dropped += 1
            self._replay.append((channel, data))
            depth = len(self._replay)
        reg = get_registry()
        reg.counter("rtpu_netbus_buffered_total",
                    "Publishes buffered while the broker was down.").inc()
        if dropped:
            reg.counter(
                "rtpu_netbus_replay_dropped_total",
                "Buffered publishes lost to the bound.").inc(dropped)
        get_logger("routest_tpu_torch.netbus").warning(
            "netbus_publish_buffered", channel=channel, depth=depth,
            error=f"{type(error).__name__}: {error}")
        self._ensure_reconnect_thread()

    def _ensure_reconnect_thread(self) -> None:
        with self._replay_lock:
            if (self._reconnect_thread is not None
                    and self._reconnect_thread.is_alive()):
                return
            t = threading.Thread(target=self._reconnect_loop,
                                 name="netbus-reconnect", daemon=True)
            self._reconnect_thread = t
        t.start()

    def _reconnect_loop(self) -> None:
        """Capped-backoff ping loop; on recovery, re-publish the buffer
        FIFO. Exits when the buffer is drained (restarted on the next
        buffered publish)."""
        from routest_tpu_torch.obs import get_registry
        from routest_tpu_torch.utils.logging import get_logger

        log = get_logger("routest_tpu_torch.netbus")
        backoff = 0.05
        while True:
            with self._replay_lock:
                if not self._replay:
                    self._reconnect_thread = None
                    return
            if not self.ping():
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = 0.05
            replayed = 0
            while True:
                with self._replay_lock:
                    if not self._replay:
                        break
                    channel, data = self._replay[0]
                try:
                    self._command({"op": "publish", "channel": channel,
                                   "data": data},
                                  retry_after_ack_loss=False)
                except (ConnectionError, OSError):
                    break  # broker died again; keep the entry, back off
                with self._replay_lock:
                    if self._replay and self._replay[0] == (channel, data):
                        self._replay.popleft()
                replayed += 1
            if replayed:
                get_registry().counter(
                    "rtpu_netbus_replayed_total",
                    "Buffered publishes replayed after reconnect."
                ).inc(replayed)
                log.info("netbus_replayed", replayed=replayed,
                         remaining=len(self._replay))

    @property
    def replay_depth(self) -> int:
        with self._replay_lock:
            return len(self._replay)

    def subscribe(self, channel: str,
                  last_event_id: Optional[int] = None):
        from routest_tpu_torch.chaos import inject as chaos_inject

        chaos_inject("netbus.subscribe")
        sub = self._raw_subscribe(channel, last_event_id)
        if self._reconnect_s > 0:
            return _ReconnectingSubscription(self, channel, sub,
                                             self._reconnect_s)
        return sub

    def _raw_subscribe(self, channel: str,
                       last_event_id: Optional[int] = None,
                       epoch: Optional[str] = None) -> "_NetSubscription":
        conn = socket.create_connection(self._addr, timeout=self._timeout)
        req = {"op": "subscribe", "channel": channel}
        if last_event_id is not None:
            req["last_event_id"] = int(last_event_id)
        if epoch is not None:
            req["epoch"] = epoch
        conn.sendall(json.dumps(req).encode() + b"\n")
        sub = _NetSubscription(conn)
        ack = sub._read_line(timeout=self._timeout)
        if ack is None:
            conn.close()
            raise ConnectionError(f"subscribe to {channel!r} refused")
        ack_obj = json.loads(ack)
        if not ack_obj.get("ok"):
            conn.close()
            raise ConnectionError(f"subscribe to {channel!r} refused")
        sub.epoch = ack_obj.get("epoch")
        return sub

    def ping(self) -> bool:
        try:
            return bool(self._command({"op": "ping"},
                                      retry_after_ack_loss=True).get("ok"))
        except Exception:  # rtpulint: disable=broad-except-unlogged -- health probe: any broker failure maps to unhealthy=False
            return False

    @property
    def kind(self) -> str:
        return "netbus"


class _NetSubscription:
    """Line reader over the subscription socket.

    select() + a manual byte buffer instead of socket.makefile +
    settimeout: a timeout firing mid-line on a buffered file object
    leaves its internal buffer inconsistent (documented makefile
    caveat), silently corrupting the next message — here a partial line
    just stays in ``_buf`` until the rest arrives.
    """

    def __init__(self, conn: socket.socket) -> None:
        self._conn = conn
        self._conn.setblocking(False)
        self._buf = bytearray()
        self.closed = False  # broker gone / dropped us — stream should end
        self.last_id: Optional[int] = None  # last delivered event id
        self.epoch: Optional[str] = None  # broker incarnation (from ack)

    def _read_line(self, timeout: float) -> Optional[bytes]:
        deadline = time.monotonic() + max(timeout, 0.001)
        while b"\n" not in self._buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            if self.closed:
                # A dead socket selects readable forever (EOF): returning
                # instantly would hot-spin the consumer's keepalive loop.
                # Sleep out the budget instead; the consumer sees
                # ``closed`` and ends the stream.
                time.sleep(remaining)
                return None
            try:
                readable, _, _ = select.select([self._conn], [], [], remaining)
            except (OSError, ValueError):  # closed fd
                self.closed = True
                continue
            if not readable:
                return None
            try:
                chunk = self._conn.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                self.closed = True
                continue
            if not chunk:  # peer closed
                self.closed = True
                continue
            self._buf += chunk
        line, _, rest = bytes(self._buf).partition(b"\n")
        self._buf = bytearray(rest)
        return line

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        line = self._read_line(timeout if timeout and timeout > 0 else 0.01)
        if not line:
            return None
        try:
            msg = json.loads(line)
        except ValueError:
            return None
        if "id" in msg:  # enables SSE Last-Event-ID resume downstream
            self.last_id = msg["id"]
        return msg.get("data")

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass

    def __enter__(self) -> "_NetSubscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _ReconnectingSubscription:
    """Self-healing subscription: when the inner one dies (broker
    restart, slow-consumer drop), re-subscribe with the last delivered
    event id — resuming missed events from the broker's replay ring
    when it survived, or picking up live (plus the publisher-side
    replay buffer) when it restarted fresh. Gives up — ``closed`` goes
    True, the SSE stream ends, the browser takes over — after
    ``window_s`` seconds of continuous downtime."""

    def __init__(self, bus: "NetBus", channel: str,
                 sub: _NetSubscription, window_s: float) -> None:
        self._bus = bus
        self._channel = channel
        self._sub = sub
        self._window_s = window_s
        self._down_since: Optional[float] = None
        self.closed = False

    @property
    def last_id(self) -> Optional[int]:
        return self._sub.last_id

    def get(self, timeout: Optional[float] = None) -> Optional[dict]:
        deadline = time.monotonic() + (timeout if timeout and timeout > 0
                                       else 0.01)
        while True:
            if self.closed:
                return None
            if self._sub.closed:
                # Retry cadence while the broker is down: one attempt,
                # then ≤0.5 s pause slices — a restarted broker is
                # noticed quickly without hot-spinning a dead port.
                self._try_reconnect()
                if self._sub.closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    time.sleep(min(remaining, 0.5))
                    continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            data = self._sub.get(remaining)
            if data is not None:
                self._down_since = None
                return data
            if not self._sub.closed:
                return None  # genuinely quiet: let the caller keepalive

    def _try_reconnect(self) -> None:
        from routest_tpu_torch.obs import get_registry
        from routest_tpu_torch.utils.logging import get_logger

        now = time.monotonic()
        if self._down_since is None:
            self._down_since = now
            get_logger("routest_tpu_torch.netbus").warning(
                "netbus_subscription_lost", channel=self._channel,
                last_id=self._sub.last_id)
        try:
            # Resume from the last delivered id, proving which epoch it
            # belongs to — a restarted broker (new epoch) replays its
            # whole ring instead of honoring a stale id (lei or 0: a
            # subscriber that saw nothing yet resumes from the start).
            fresh = self._bus._raw_subscribe(
                self._channel, last_event_id=self._sub.last_id or 0,
                epoch=self._sub.epoch)
        except (ConnectionError, OSError, ValueError):
            if now - self._down_since >= self._window_s:
                self.closed = True
                get_logger("routest_tpu_torch.netbus").error(
                    "netbus_subscription_abandoned", channel=self._channel,
                    downtime_s=round(now - self._down_since, 1))
            return
        if fresh.epoch == self._sub.epoch:
            fresh.last_id = self._sub.last_id  # same epoch: ids continue
        self._sub.close()
        self._sub = fresh
        self._down_since = None
        get_registry().counter(
            "rtpu_netbus_reconnects_total",
            "Subscriptions transparently re-established.").inc()
        get_logger("routest_tpu_torch.netbus").info(
            "netbus_subscription_reconnected", channel=self._channel)

    def close(self) -> None:
        self.closed = True
        self._sub.close()

    def __enter__(self) -> "_ReconnectingSubscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def main() -> None:
    import argparse

    from routest_tpu_torch.utils.logging import get_logger

    parser = argparse.ArgumentParser(description="routest_tpu_torch SSE broker")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args()
    broker = Broker(args.host, args.port)
    get_logger("routest_tpu_torch.netbus").info(
        "broker_listening", url=f"tcp://{args.host}:{broker.port}")
    broker.serve_forever()


if __name__ == "__main__":
    main()
