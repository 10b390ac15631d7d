"""Persistent multiplexed wire channel between a client and a replica.

The counterpart of ``routest_tpu/serve/wirechannel.py``, and the same
protocol: each package's client talks to the other's server. The
per-request HTTP exchange (request line + headers both directions, ~600
B of text per exchange) is a measurable fraction of small-batch ETA
latency. This module replaces it for wire-format traffic with ONE
long-lived TCP connection per client→replica pair carrying
length-prefixed binary messages, many requests in flight at once:

- **Client**: one socket per replica, a writer lock for atomic sends,
  and a reader thread that matches responses to waiting callers by
  request id — requests multiplex instead of queueing behind each other,
  so one slow batch does not head-of-line-block a small one. A dead
  socket fails every pending request loudly and the next call
  reconnects.
- **Server** (replica side): an accept loop, one reader thread per
  connection, one handler thread per in-flight request (the handlers
  are the SAME ``app.wire_handlers`` the HTTP negotiation path calls),
  responses written under a per-connection lock in completion order.

Channel message layout (little-endian), both directions::

    total_len  u32   bytes after this field
    request_id u32   client-chosen; echoed on the response
    op         u8    1 = request, 2 = response
    meta_len   u32   JSON metadata length
    meta       ...   request: {"path", "probe"?, "deadline_ms"?}
                     response: {"status"}
    frame      ...   one wirecodec frame (the payload)

The channel exists only when ``RTPU_WIRE=1`` (``python -m
routest_tpu_torch.serve`` listens on ``RTPU_WIRE_PORT``, or ``PORT +
RTPU_WIRE_PORT_OFFSET``). Deadlines propagate via ``deadline_ms``
exactly like the ``X-Deadline-Ms`` header. The fleet gateway that rides
the client in production arrives with the fleet slice.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.serve.wirechannel")

OP_REQUEST = 1
OP_RESPONSE = 2

_LEN = struct.Struct("<I")
_HEAD = struct.Struct("<IBI")   # request_id, op, meta_len (after total_len)

# Meta is tiny JSON ({"path", "probe"?, "deadline_ms"?} / {"status"});
# anything near this bound is a corrupt or hostile peer.
_MAX_META = 64 * 1024

_reg = get_registry()
_m_frames = _reg.counter(
    "rtpu_wire_frames_total",
    "Wire frames exchanged by channel clients, by direction and route.",
    ("direction", "route"))
_m_bytes = _reg.counter(
    "rtpu_wire_bytes_total",
    "Wire payload bytes exchanged by channel clients, by direction.",
    ("direction",))
_m_conns = _reg.counter(
    "rtpu_wire_conns_total",
    "Wire channel connection events at the client: reused = request "
    "rode an existing channel, fresh = new channel connect, dead = "
    "channel failed mid-flight.", ("event",))
_m_server = _reg.counter(
    "rtpu_wire_server_requests_total",
    "Wire-channel requests served by this replica, by route and "
    "status class.", ("route", "status"))


class WireChannelError(ConnectionError):
    """Channel transport failure (connect, send, or matching response
    lost): a transport verdict, never a request-level answer."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed the wire channel")
        got += r
    return bytes(buf)


def _read_message(sock: socket.socket,
                  max_bytes: int) -> Tuple[int, int, dict, bytes]:
    """→ (request_id, op, meta, frame). Raises on any framing defect —
    a channel that desyncs is torn down, never resynchronized."""
    (total,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if total < _HEAD.size or total > max_bytes + _MAX_META + _HEAD.size:
        raise ConnectionError(f"wire channel message of {total} bytes "
                              "outside bounds")
    body = _recv_exact(sock, total)
    rid, op, meta_len = _HEAD.unpack_from(body, 0)
    if meta_len > _MAX_META or _HEAD.size + meta_len > total:
        raise ConnectionError("wire channel meta length corrupt")
    try:
        meta = json.loads(body[_HEAD.size:_HEAD.size + meta_len]
                          .decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ConnectionError(f"wire channel meta not JSON: {e}") from e
    if not isinstance(meta, dict):
        raise ConnectionError("wire channel meta must be an object")
    return rid, op, meta, body[_HEAD.size + meta_len:]


def _send_message(sock: socket.socket, lock: threading.Lock, rid: int,
                  op: int, meta: dict, frame: bytes) -> None:
    meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    head = _HEAD.pack(rid, op, len(meta_b))
    total = len(head) + len(meta_b) + len(frame)
    msg = b"".join((_LEN.pack(total), head, meta_b, frame))
    with lock:
        # The lock is the socket's write-serialization point: multiplexed
        # senders must not interleave message bytes.
        sock.sendall(msg)


# ── replica side ─────────────────────────────────────────────────────


class WireChannelServer:
    """Accept loop + per-connection readers over ``handlers``
    (path → ``fn(frame_bytes) → (status, frame_bytes)`` — the app's
    ``wire_handlers``)."""

    def __init__(self, handlers: Mapping[str, Callable], host: str,
                 port: int, max_frame_bytes: int = 64 << 20) -> None:
        self.handlers = dict(handlers)
        self.host = host
        self.port = port
        self.max_frame_bytes = int(max_frame_bytes)
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conns: Dict[int, socket.socket] = {}
        self._conns_lock = threading.Lock()
        self._next_conn = 0

    def start(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self.port))
            self.port = srv.getsockname()[1]  # resolve port 0
            srv.listen(64)
        except OSError:
            srv.close()  # a taken port must not leak the socket
            raise
        self._listener = srv
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="wirechannel-accept").start()
        _log.info("wire_channel_listening", host=self.host, port=self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                # shutdown() wakes a thread blocked in accept();
                # close() alone leaves it holding a zombie LISTEN
                # socket that keeps the port bound.
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_lock:
            conns, self._conns = dict(self._conns), {}
        for sock in conns.values():
            try:
                # Hard close (RST, no FIN_WAIT lingering): a restarted
                # worker must be able to rebind this port immediately
                # even when a peer never answers our FIN.
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_LINGER,
                    struct.pack("ii", 1, 0))
                sock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            if self._stop.is_set():   # raced a stop(): don't serve
                sock.close()
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                cid = self._next_conn
                self._next_conn += 1
                self._conns[cid] = sock
            threading.Thread(target=self._conn_loop, args=(cid, sock),
                             daemon=True,
                             name=f"wirechannel-conn-{cid}").start()

    def _conn_loop(self, cid: int, sock: socket.socket) -> None:
        wlock = threading.Lock()
        try:
            while not self._stop.is_set():
                rid, op, meta, frame = _read_message(sock,
                                                     self.max_frame_bytes)
                if op != OP_REQUEST:
                    raise ConnectionError(f"unexpected channel op {op}")
                # Handler threads per in-flight request: the whole point
                # of the channel is that a slow batch must not
                # head-of-line-block the next frame on this connection.
                threading.Thread(
                    target=self._serve_one,
                    args=(sock, wlock, rid, meta, frame),
                    daemon=True, name="wirechannel-req").start()
        except (ConnectionError, OSError) as e:
            if not self._stop.is_set():
                _log.info("wire_channel_conn_closed", conn=cid,
                          reason=str(e))
        finally:
            with self._conns_lock:
                self._conns.pop(cid, None)
            try:
                sock.close()
            except OSError:
                pass

    def _serve_one(self, sock: socket.socket, wlock: threading.Lock,
                   rid: int, meta: dict, frame: bytes) -> None:
        from routest_tpu_torch.serve.deadline import (DeadlineExceeded,
                                                      bind_deadline,
                                                      reset_deadline)
        from routest_tpu_torch.serve.wirecodec import encode_error_frame

        path = str(meta.get("path", ""))
        fn = self.handlers.get(path)
        dl_token = None
        try:
            if fn is None:
                status, out = 404, encode_error_frame(
                    404, f"no wire handler for {path!r}")
            else:
                deadline_ms = meta.get("deadline_ms")
                if isinstance(deadline_ms, (int, float)):
                    if deadline_ms <= 0:
                        raise DeadlineExceeded("expired at the channel edge")
                    dl_token = bind_deadline(float(deadline_ms))
                status, out = fn(frame)
        except DeadlineExceeded:
            status, out = 504, encode_error_frame(504, "deadline exceeded")
        except Exception as e:
            _log.error("wire_handler_failed", path=path, error=str(e))
            status, out = 500, encode_error_frame(
                500, f"internal error: {e}")
        finally:
            if dl_token is not None:
                reset_deadline(dl_token)
        _m_server.labels(route=path or "other",
                         status=f"{status // 100}xx").inc()
        try:
            _send_message(sock, wlock, rid, OP_RESPONSE,
                          {"status": int(status)}, out)
        except (OSError, ConnectionError):
            pass  # peer gone; its client already failed the waiters


# ── client side ──────────────────────────────────────────────────────


class _Waiter:
    __slots__ = ("event", "status", "frame", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.status: Optional[int] = None
        self.frame: Optional[bytes] = None
        self.error: Optional[BaseException] = None


class WireChannelClient:
    """One persistent channel to one replica, many requests in flight.

    Thread-safe. ``request()`` raises :class:`WireChannelError` on any
    transport failure; the caller decides whether to retry over HTTP."""

    def __init__(self, host: str, port: int,
                 connect_timeout: float = 2.0,
                 max_frame_bytes: int = 64 << 20) -> None:
        self.host = host
        self.port = port
        self.connect_timeout = float(connect_timeout)
        self.max_frame_bytes = int(max_frame_bytes)
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, _Waiter] = {}
        self._next_rid = 0
        self._closed = False

    # ── connection lifecycle ─────────────────────────────────────────

    def _ensure_connected(self) -> socket.socket:
        with self._state_lock:
            if self._closed:
                raise WireChannelError("channel client closed")
            if self._sock is not None:
                _m_conns.labels(event="reused").inc()
                return self._sock
        # Connect OUTSIDE the state lock: a slow connect (dead host,
        # SYN blackhole) must not wedge close()/_kill() or a concurrent
        # sender that could have ridden an existing channel.
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout)
        except OSError as e:
            raise WireChannelError(
                f"wire channel connect to {self.host}:{self.port} "
                f"failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)  # the reader thread blocks; waiters
        with self._state_lock:  # enforce their own timeouts
            if self._closed:
                sock.close()
                raise WireChannelError("channel client closed")
            if self._sock is not None:    # lost the connect race —
                sock.close()              # ride the winner's channel
                _m_conns.labels(event="reused").inc()
                return self._sock
            self._sock = sock
            _m_conns.labels(event="fresh").inc()
            threading.Thread(target=self._read_loop, args=(sock,),
                             daemon=True,
                             name=f"wirechannel-read-{self.port}").start()
            return sock

    def _kill(self, sock: socket.socket, reason: str) -> None:
        """Fail every pending request and drop the socket (the next
        ``request()`` reconnects)."""
        with self._state_lock:
            if self._sock is sock:
                self._sock = None
                _m_conns.labels(event="dead").inc()
            pending, self._pending = dict(self._pending), {}
        try:
            # shutdown() wakes the reader blocked in recv(), and its FIN
            # ends the server's connection thread; close() alone leaves
            # both blocked on a socket the kernel keeps open for them.
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        err = WireChannelError(f"wire channel to {self.host}:{self.port} "
                               f"died: {reason}")
        for waiter in pending.values():
            waiter.error = err
            waiter.event.set()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                rid, op, meta, frame = _read_message(sock,
                                                     self.max_frame_bytes)
                if op != OP_RESPONSE:
                    raise ConnectionError(f"unexpected channel op {op}")
                with self._state_lock:
                    waiter = self._pending.pop(rid, None)
                if waiter is None:
                    continue  # caller gave up (timeout) — late answer
                waiter.status = int(meta.get("status", 500))
                waiter.frame = frame
                waiter.event.set()
        except (ConnectionError, OSError) as e:
            self._kill(sock, str(e))

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
            sock, self._sock = self._sock, None
        if sock is not None:
            self._kill(sock, "client closed")

    # ── the request path ─────────────────────────────────────────────

    def request(self, path: str, frame: bytes,
                timeout: float = 10.0,
                deadline_ms: Optional[float] = None) -> Tuple[int, bytes]:
        """One multiplexed exchange → (status, response frame bytes)."""
        sock = self._ensure_connected()
        waiter = _Waiter()
        with self._state_lock:
            self._next_rid = (self._next_rid + 1) & 0xFFFFFFFF
            rid = self._next_rid
            self._pending[rid] = waiter
        meta: dict = {"path": path}
        if deadline_ms is not None:
            meta["deadline_ms"] = deadline_ms
        try:
            _send_message(sock, self._wlock, rid, OP_REQUEST, meta, frame)
        except (OSError, ConnectionError) as e:
            self._kill(sock, str(e))
            raise WireChannelError(f"wire channel send failed: {e}") from e
        _m_frames.labels(direction="sent", route=path).inc()
        _m_bytes.labels(direction="sent").inc(len(frame))
        if not waiter.event.wait(timeout):
            with self._state_lock:
                self._pending.pop(rid, None)
            raise WireChannelError(
                f"wire channel response timeout after {timeout:.1f}s")
        if waiter.error is not None:
            raise waiter.error
        _m_frames.labels(direction="received", route=path).inc()
        _m_bytes.labels(direction="received").inc(len(waiter.frame))
        return waiter.status, waiter.frame

