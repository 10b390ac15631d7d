"""Open-loop driver: fire each request at its scheduled instant and
measure latency from that instant.

Closed-loop harnesses (a fixed pool of workers, each sending its next
request only after the previous one returns) systematically under-
report tail latency: when the server stalls, the generator stops
offering load, so the stall's victims are requests that were *never
sent* — they appear in no percentile. That is coordinated omission
(Tene, "How NOT to Measure Latency"). The fix is structural, not
statistical: schedule send times independently of the system under
test, and clock every request from its **intended** send time, so a
request that left late because the system backed the generator up
still charges its full user-visible wait.

Mechanics: arrivals (``arrivals.py``) and bodies (``workload.py``) are
precomputed; a pool of workers pulls the next (offset, request) in
order, sleeps until ``t0 + offset``, sends on a persistent keep-alive
connection, and records both latencies (from intended send and from
actual send — their divergence is itself reported, as
``send_delay``). If every worker is busy at an arrival's instant the
send slips and ``send_delay`` grows; reports surface the p99 so an
under-provisioned *generator* is visible instead of silently polluting
the measurement of the *server*.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import threading
import time
import urllib.parse
from typing import Callable, List, Optional, Sequence

from routest_tpu_torch.loadgen.workload import PlannedRequest


@dataclasses.dataclass
class RequestRecord:
    """One completed (or failed) exchange."""

    route: str
    offset_s: float             # scheduled offset into the run
    status: int                 # -1 = transport failure
    latency_s: float            # completion - INTENDED send (CO-correct)
    service_s: float            # completion - actual send
    send_delay_s: float         # actual send - intended send
    error: Optional[str] = None


class KeepAliveClient:
    """One persistent HTTP/1.1 connection, reconnect-once on a stale
    keep-alive — same contract as the closed-loop harness's poster so
    open vs closed comparisons measure the server, not the client."""

    def __init__(self, base: str, timeout: float = 30.0) -> None:
        parts = urllib.parse.urlsplit(base)
        self._host = parts.hostname
        self._port = parts.port
        self._timeout = timeout
        self._conn = self._make()

    def _make(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._timeout)

    def reset(self) -> None:
        self._conn.close()
        self._conn = self._make()

    def close(self) -> None:
        self._conn.close()

    def send(self, req: PlannedRequest):
        """→ (status, body bytes); raises on double transport failure."""
        if isinstance(req.body, (bytes, bytearray, memoryview)):
            body = bytes(req.body)   # pre-encoded (binary wire frames)
        elif req.body is not None:
            body = json.dumps(req.body).encode()
        else:
            body = None
        headers = {"Content-Type": req.content_type} if body else {}
        try:
            self._conn.request(req.method, req.path, body=body,
                               headers=headers)
            resp = self._conn.getresponse()
            return resp.status, resp.read()
        except (http.client.HTTPException, OSError):
            self.reset()
            self._conn.request(req.method, req.path, body=body,
                               headers=headers)
            resp = self._conn.getresponse()
            return resp.status, resp.read()


def run_open_loop(bases: Sequence[str], offsets: Sequence[float],
                  requests: Sequence[PlannedRequest], *,
                  workers: int = 32, timeout: float = 30.0,
                  stop: Optional[threading.Event] = None,
                  on_record: Optional[Callable[[RequestRecord], None]]
                  = None, start: Optional[float] = None,
                  spin_s: float = 0.0) -> List[RequestRecord]:
    """Fire ``requests[i]`` at ``t0 + offsets[i]``; return one record
    per arrival (schedule order). ``stop`` aborts early (remaining
    arrivals are simply not sent and not recorded); ``on_record`` is
    called per completion on the worker thread (timeline builders).
    ``start`` is ``t0`` as a ``time.perf_counter()`` instant (the
    host's monotonic clock, one for all its processes), so several
    sender processes can share one schedule; by default ``t0`` is 50 ms
    after the call. ``spin_s`` > 0 ends each wait that much early and
    spins to the instant (no wake-up latency at the send)."""
    n = min(len(offsets), len(requests))
    records: List[Optional[RequestRecord]] = [None] * n
    cursor = [0]
    lock = threading.Lock()
    stop = stop or threading.Event()
    # small runway for thread start
    t0 = time.perf_counter() + 0.05 if start is None else start

    def worker(wid: int) -> None:
        client = KeepAliveClient(bases[wid % len(bases)], timeout=timeout)
        try:
            while not stop.is_set():
                with lock:
                    i = cursor[0]
                    if i >= n:
                        return
                    cursor[0] = i + 1
                target = t0 + offsets[i]
                while True:
                    delta = target - time.perf_counter()
                    if delta <= spin_s:
                        break
                    if stop.wait(min(delta - spin_s, 0.2)):
                        return
                sent = time.perf_counter()
                while sent < target:
                    sent = time.perf_counter()
                status, err = -1, None
                try:
                    status, _ = client.send(requests[i])
                except Exception as e:   # transport failure, post-retry
                    err = f"{type(e).__name__}: {e}"[:80]
                    client.reset()
                done = time.perf_counter()
                rec = RequestRecord(
                    route=requests[i].route, offset_s=float(offsets[i]),
                    status=status, latency_s=done - target,
                    service_s=done - sent, send_delay_s=sent - target,
                    error=err)
                records[i] = rec
                if on_record is not None:
                    on_record(rec)
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for r in records if r is not None]


def run_closed_loop(bases: Sequence[str],
                    requests: Sequence[PlannedRequest], *,
                    workers: int = 8, duration_s: Optional[float] = None,
                    timeout: float = 30.0) -> List[RequestRecord]:
    """The traditional harness, kept as the comparison arm: ``workers``
    clients send back-to-back (next request only after the previous
    response), latency clocked from the ACTUAL send. Under a stalled
    server this stops offering load — which is exactly the
    coordinated-omission blind spot the open-loop runner exists to
    close; benches run both to measure the gap."""
    records: List[RequestRecord] = []
    cursor = [0]
    lock = threading.Lock()
    t0 = time.perf_counter()

    def worker(wid: int) -> None:
        client = KeepAliveClient(bases[wid % len(bases)], timeout=timeout)
        try:
            while True:
                if duration_s is not None \
                        and time.perf_counter() - t0 >= duration_s:
                    return
                with lock:
                    i = cursor[0]
                    if i >= len(requests):
                        return
                    cursor[0] = i + 1
                sent = time.perf_counter()
                status, err = -1, None
                try:
                    status, _ = client.send(requests[i])
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"[:80]
                    client.reset()
                done = time.perf_counter()
                rec = RequestRecord(
                    route=requests[i].route, offset_s=sent - t0,
                    status=status, latency_s=done - sent,
                    service_s=done - sent, send_delay_s=0.0, error=err)
                with lock:
                    records.append(rec)
        finally:
            client.close()

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records


class SseClients:
    """``n`` long-lived ``/api/realtime_feed`` subscribers held open for
    the run (streams are connections, not arrivals — they ride beside
    the request schedule). Counts events per connection.

    The server flushes SSE headers with the FIRST chunk (an event or
    the 15 s keepalive), so ``header_timeout`` must cover that gap;
    publish tracker events on the same ``channel`` (the
    ``update_tracker`` workload kind does) to light the streams up."""

    def __init__(self, base: str, n: int, channel: str = "loadgen",
                 header_timeout: float = 30.0) -> None:
        self.base = base
        self.n = n
        self.path = f"/api/realtime_feed?channel={channel}"
        self.channel = channel
        self.events = 0
        self.connected = 0
        self.errors = 0
        self._header_timeout = header_timeout
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._socks: List = []

    def _run_one(self) -> None:
        parts = urllib.parse.urlsplit(self.base)
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=self._header_timeout)
        try:
            conn.request("GET", self.path)
            resp = conn.getresponse()
            if resp.status != 200:
                with self._lock:
                    self.errors += 1
                return
            # Reads are BLOCKING from here: a socket-level read timeout
            # is unusable for idle-waiting (the first timeout poisons
            # the stream — SocketIO raises "cannot read from timed out
            # object" on every read after it, silently dropping all
            # later events). ``__exit__`` wakes blocked readers with
            # ``shutdown()`` instead. SSE carries no Content-Length
            # (read-until-close), so ``getresponse`` hands the socket
            # to the response and nulls ``conn.sock`` — the live handle
            # is the SocketIO under ``resp.fp``.
            sock = conn.sock
            if sock is None:
                sock = getattr(getattr(resp.fp, "raw", None),
                               "_sock", None)
            if sock is not None:
                sock.settimeout(None)
            with self._lock:
                self.connected += 1
                self._socks.append(sock)
            while not self._stop.is_set():
                chunk = resp.read1(65536)
                if not chunk:
                    return              # server closed (or shutdown())
                with self._lock:
                    self.events += chunk.count(b"data:")
        except (http.client.HTTPException, OSError):
            if not self._stop.is_set():     # shutdown-induced ≠ error
                with self._lock:
                    self.errors += 1
        finally:
            conn.close()

    def __enter__(self) -> "SseClients":
        for _ in range(self.n):
            t = threading.Thread(target=self._run_one, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        # Closing an fd does NOT wake a thread blocked in recv();
        # shutdown() does (the read returns EOF immediately).
        with self._lock:
            socks = list(self._socks)
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=3.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"requested": self.n, "connected": self.connected,
                    "events": self.events, "errors": self.errors}
