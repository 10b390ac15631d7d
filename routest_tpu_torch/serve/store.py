"""Persistence: PostgREST-shaped stores for route requests and results.

The counterpart of ``routest_tpu/serve/store.py``. Schema follows the
Laravel migrations plus the runtime drift the Flask service writes
(SURVEY.md §2.2): ``route_requests`` (origin_id, stops, status, engine,
vehicle_id, driver_age, request_time) and ``route_results`` (request_id
with cascading delete, total_distance, total_duration, optimized_order,
legs, geometry, eta_minutes_ml, eta_completion_time_ml).

Two backends behind one interface, both wrapped by :func:`make_store`:

- ``InMemoryStore`` — the hermetic default;
- ``PostgRESTStore`` — the reference's runtime path (Supabase
  service-role writes, embedded-resource selects, cascading delete,
  ``Flaskr/routes.py:134-182,193-250,386-405``), on ``urllib.request``
  with the JAX package's URLs, headers and JSON bodies;

then ``ResilientStore`` (bounded retry with jittered backoff, a circuit
breaker, a bounded write journal that replays on recovery) and
``TracedStore`` (a ``store.<op>`` trace span and the
``rtpu_store_op_seconds{op,backend}`` histogram per operation). Every
backend attempt passes the ``store.http`` chaos point, and the breaker
opening triggers a flight-recorder bundle, as in the JAX package.
"""

from __future__ import annotations

import collections
import datetime as dt
import json
import os
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Deque, Dict, List, Optional, Protocol, Tuple

from routest_tpu_torch.chaos import ChaosError
from routest_tpu_torch.chaos import inject as chaos_inject
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.trace import trace_span
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.serve.store")


class StoreUnavailable(RuntimeError):
    """The store's circuit breaker is open: fail fast instead of
    stacking timeouts against a dead backend. Read handlers surface
    this as an explicit ``degraded: true`` response marker."""


class Store(Protocol):
    def insert_request(self, row: Dict) -> str: ...
    def insert_result(self, row: Dict) -> None: ...
    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]: ...
    def get_request(self, req_id: str) -> Optional[Dict]: ...
    def delete_request(self, req_id: str) -> bool: ...
    def ping(self) -> bool: ...
    @property
    def kind(self) -> str: ...


def _now_iso() -> str:
    return dt.datetime.now(dt.timezone.utc).isoformat()


class InMemoryStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: Dict[str, Dict] = {}
        self._results: Dict[str, List[Dict]] = {}

    def insert_request(self, row: Dict) -> str:
        # A caller-supplied id is honored (the resilience layer mints
        # ids for journaled writes so results can reference their
        # request before the replay lands), as PostgREST would.
        req_id = str(row.get("id") or uuid.uuid4())
        with self._lock:
            self._requests[req_id] = {
                "request_time": _now_iso(),
                **row,
                "id": req_id,
            }
        return req_id

    def insert_result(self, row: Dict) -> None:
        result = {"id": str(uuid.uuid4()), "created_at": _now_iso(), **row}
        with self._lock:
            req_id = row.get("request_id")
            if req_id not in self._requests:
                raise KeyError(f"route_requests.{req_id} does not exist")
            self._results.setdefault(req_id, []).append(result)

    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]:
        with self._lock:
            rows = sorted(self._requests.values(),
                          key=lambda r: r["request_time"], reverse=True)
            if engine is not None:
                rows = [r for r in rows if r.get("engine") == engine]
            rows = rows[:limit]
            return [
                {**r, "route_results": list(self._results.get(r["id"], ()))}
                for r in rows
            ]

    def get_request(self, req_id: str) -> Optional[Dict]:
        with self._lock:
            r = self._requests.get(req_id)
            if r is None:
                return None
            return {**r, "route_results": list(self._results.get(req_id, ()))}

    def delete_request(self, req_id: str) -> bool:
        with self._lock:
            existed = req_id in self._requests
            self._requests.pop(req_id, None)
            self._results.pop(req_id, None)  # FK cascade
            return existed

    def ping(self) -> bool:
        return True

    @property
    def kind(self) -> str:
        return "memory"


class PostgRESTStore:
    """Supabase PostgREST client, request-shape compatible with the
    reference service. A non-2xx answer raises ``urllib.error.HTTPError``
    (its ``.code`` carries the status) where the JAX store's
    ``raise_for_status`` raises; a dead socket or a timeout raises an
    ``OSError``."""

    def __init__(self, url: str, service_key: str,
                 timeout: float = 20.0) -> None:
        self._rest = f"{url.rstrip('/')}/rest/v1"
        self._headers = {
            "apikey": service_key,
            "Authorization": f"Bearer {service_key}",
            "Content-Type": "application/json",
            "Prefer": "return=representation",
        }
        self._timeout = timeout

    def _send(self, method: str, table: str, timeout: float,
              params: Optional[Dict] = None, row: Optional[Dict] = None):
        """One exchange → (status, parsed JSON body or None when empty)."""
        url = f"{self._rest}/{table}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = (None if row is None
                else json.dumps(row, allow_nan=False).encode("utf-8"))
        req = urllib.request.Request(url, data=data, headers=self._headers,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status, raw = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            e.close()  # release the error's socket; .code still answers
            raise
        return status, (json.loads(raw) if raw.strip() else None)

    def insert_request(self, row: Dict) -> str:
        _status, body = self._send("POST", "route_requests", self._timeout,
                                   row=row)
        return body[0]["id"]

    def insert_result(self, row: Dict) -> None:
        self._send("POST", "route_results", self._timeout, row=row)

    _HISTORY_SELECT = (
        "id,request_time,origin_id,stops,engine,vehicle_id,driver_age,"
        "route_results(id,total_distance,total_duration,optimized_order,"
        "created_at,eta_minutes_ml,eta_completion_time_ml)"
    )
    _DETAIL_SELECT = (
        "id,origin_id,stops,status,request_time,engine,vehicle_id,driver_age,"
        "route_results(id,total_distance,total_duration,optimized_order,legs,"
        "created_at,eta_minutes_ml,eta_completion_time_ml,geometry)"
    )

    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]:
        params = {"select": self._HISTORY_SELECT,
                  "order": "request_time.desc", "limit": str(limit)}
        if engine is not None:
            params["engine"] = f"eq.{engine}"  # PostgREST filter syntax
        _status, body = self._send("GET", "route_requests", self._timeout,
                                   params=params)
        return body

    def get_request(self, req_id: str) -> Optional[Dict]:
        _status, rows = self._send(
            "GET", "route_requests", self._timeout,
            params={"select": self._DETAIL_SELECT, "id": f"eq.{req_id}",
                    "limit": "1"})
        return rows[0] if rows else None

    def delete_request(self, req_id: str) -> bool:
        # Prefer: return=representation makes PostgREST return the
        # deleted rows — an empty body (or a 204) means nothing matched,
        # which surfaces as not-found (parity with InMemoryStore).
        try:
            status, rows = self._send("DELETE", "route_requests", 10,
                                      params={"id": f"eq.{req_id}"})
        except urllib.error.HTTPError:
            return False
        except ValueError:  # a body that is not JSON
            return False
        return status in (200, 204) and bool(rows)

    def ping(self) -> bool:
        try:
            status, _ = self._send("GET", "route_requests", 3,
                                   params={"select": "id", "limit": "1"})
            return 200 <= status < 300
        except urllib.error.HTTPError:
            return False  # answered, not 2xx: as the JAX store reads it
        except Exception as e:
            # Visible, not swallowed: health says "error", and this says
            # why.
            _log.warning("store_ping_failed", backend="postgrest",
                         error=f"{type(e).__name__}: {e}")
            get_registry().counter(
                "rtpu_store_errors_total",
                "Store backend call failures, by operation.",
                ("op",)).labels(op="ping").inc()
            return False

    @property
    def kind(self) -> str:
        return "postgrest"


def _is_transient(e: BaseException) -> bool:
    """Failure classification: transient errors (a 5xx answer, a dead
    socket, a timeout) are retried, charged to the breaker, and (for
    writes) journaled; everything else — FK violations, 4xx answers — is
    the caller's problem and raises immediately.

    The status check comes FIRST: ``urllib.error.HTTPError`` subclasses
    ``OSError``, so a 409 would otherwise read as a dead socket. An
    injected ``store.http`` fault is transient, like the outage it
    models."""
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500  # 5xx = backend's fault; 4xx = ours
    if isinstance(e, (ConnectionError, TimeoutError, OSError)):
        return True
    return isinstance(e, ChaosError)


class ResilientStore:
    """Degraded-mode decorator: bounded retry with jittered backoff, a
    failure-threshold circuit breaker, and a bounded in-memory
    write-behind journal that replays on recovery.

    - transient failures retry up to ``retries`` times with jittered
      exponential backoff; ``breaker_threshold`` consecutive transient
      failures open the breaker for ``cooldown_s``;
    - breaker open: READS fail fast with :class:`StoreUnavailable`
      (handlers answer with ``degraded: true``); WRITES append to the
      journal and succeed locally — ``insert_request`` mints the row id
      up front so dependent ``insert_result`` rows keep their FK;
    - the first successful backend call after an outage (a read, a
      half-open probe, or ``ping`` from the health poller) replays the
      journal FIFO; a replay failure re-opens the breaker and keeps the
      remaining entries;
    - the journal is bounded (``journal_limit``): overflow drops the
      OLDEST entry and counts ``rtpu_store_journal_dropped_total``.
    """

    def __init__(self, inner: Store, retries: int = 2,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 1.0,
                 breaker_threshold: int = 3, cooldown_s: float = 5.0,
                 journal_limit: int = 512) -> None:
        self._inner = inner
        self._retries = max(0, retries)
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._threshold = max(1, breaker_threshold)
        self._cooldown_s = cooldown_s
        self._journal_limit = max(1, journal_limit)
        self._journal: Deque[Tuple[str, Dict]] = collections.deque()
        self._lock = threading.Lock()
        self._replay_lock = threading.Lock()
        self._failures = 0
        self._open_until = 0.0
        self._open = False
        self._rng = random.Random()
        reg = get_registry()
        self._m_errors = reg.counter(
            "rtpu_store_errors_total",
            "Store backend call failures, by operation.", ("op",))
        self._m_retries = reg.counter(
            "rtpu_store_retries_total", "Store attempts retried.")
        self._m_breaker_opens = reg.counter(
            "rtpu_store_breaker_opens_total",
            "Times the store circuit breaker opened.")
        self._m_breaker_state = reg.gauge(
            "rtpu_store_breaker_open",
            "1 while the store circuit breaker is open.")
        self._m_journal_depth = reg.gauge(
            "rtpu_store_journal_depth", "Writes awaiting replay.")
        self._m_replayed = reg.counter(
            "rtpu_store_journal_replayed_total",
            "Journaled writes replayed to the backend.")
        self._m_dropped = reg.counter(
            "rtpu_store_journal_dropped_total",
            "Journaled writes lost to the bound (oldest dropped).")
        self._m_journaled = reg.counter(
            "rtpu_store_journal_writes_total",
            "Writes diverted to the journal (backend unavailable).")

    # ── breaker bookkeeping ───────────────────────────────────────────

    def _breaker_blocks(self) -> bool:
        """True while open and cooling down; after cooldown the next
        call through is the half-open probe."""
        with self._lock:
            if not self._open:
                return False
            return time.monotonic() < self._open_until

    def _note_failure(self, op: str, e: BaseException) -> None:
        self._m_errors.labels(op=op).inc()
        opened = False
        with self._lock:
            self._failures += 1
            if self._failures >= self._threshold and not self._open:
                self._open = True
                opened = True
            if self._open:
                self._open_until = time.monotonic() + self._cooldown_s
        if opened:
            self._m_breaker_opens.inc()
            self._m_breaker_state.set(1)
            _log.warning("store_breaker_opened", backend=self._inner.kind,
                         failures=self._failures,
                         cooldown_s=self._cooldown_s,
                         last_error=f"{type(e).__name__}: {e}")
            # Postmortem trigger: the breaker opening marks the moment
            # the outage became policy (fail-fast + journal) — capture
            # the evidence while the offending requests are still in the
            # recorder and span rings. Rate-limited inside trigger().
            from routest_tpu_torch.obs.recorder import get_recorder

            get_recorder().trigger("store_breaker_open", {
                "backend": self._inner.kind,
                "consecutive_failures": self._failures,
                "last_error": f"{type(e).__name__}: {e}",
            })
        else:
            _log.warning("store_error", op=op, backend=self._inner.kind,
                         error=f"{type(e).__name__}: {e}")

    def _note_success(self) -> None:
        closed = False
        with self._lock:
            self._failures = 0
            if self._open:
                self._open = False
                closed = True
        if closed:
            self._m_breaker_state.set(0)
            _log.info("store_breaker_closed", backend=self._inner.kind)
        if self._journal:
            self._replay_journal()

    # ── write-behind journal ──────────────────────────────────────────

    def _journal_write(self, op: str, row: Dict) -> None:
        with self._lock:
            if len(self._journal) >= self._journal_limit:
                self._journal.popleft()
                self._m_dropped.inc()
            self._journal.append((op, dict(row)))
            depth = len(self._journal)
        self._m_journaled.inc()
        self._m_journal_depth.set(depth)
        _log.warning("store_write_journaled", op=op, journal_depth=depth)

    def _replay_journal(self) -> int:
        """FIFO replay; stops (and re-opens the breaker) on the first
        failure so order is preserved. Returns entries replayed."""
        if not self._replay_lock.acquire(blocking=False):
            return 0  # one replayer at a time; the next success retries
        replayed = 0
        try:
            while True:
                with self._lock:
                    if not self._journal or self._open:
                        break
                    op, row = self._journal[0]
                try:
                    self._attempt(op, row)
                except Exception as e:
                    if _is_transient(e):
                        self._note_failure(op, e)
                        break
                    # Permanent (e.g. the request row was deleted while
                    # its result sat journaled): drop it or it wedges
                    # the queue forever.
                    _log.error("store_journal_entry_failed", op=op,
                               error=f"{type(e).__name__}: {e}")
                    self._m_dropped.inc()
                    with self._lock:
                        if self._journal and self._journal[0] == (op, row):
                            self._journal.popleft()
                    continue
                with self._lock:
                    if self._journal and self._journal[0] == (op, row):
                        self._journal.popleft()
                    depth = len(self._journal)
                replayed += 1
                self._m_replayed.inc()
                self._m_journal_depth.set(depth)
        finally:
            self._replay_lock.release()
        if replayed:
            _log.info("store_journal_replayed", replayed=replayed,
                      remaining=len(self._journal))
        return replayed

    def _attempt(self, op: str, row: Dict):
        chaos_inject("store.http")
        if op == "insert_request":
            return self._inner.insert_request(row)
        return self._inner.insert_result(row)

    # ── call plumbing ─────────────────────────────────────────────────

    def _call(self, op: str, fn, *args):
        """Reads (and delete): retry → fail fast when the breaker is
        open → raise. The caller sees StoreUnavailable only for
        breaker-open fast-fails; a genuine error after retries keeps
        its type (→ 500, not a degraded marker)."""
        if self._breaker_blocks():
            raise StoreUnavailable(f"store breaker open ({op})")
        last: Optional[BaseException] = None
        for attempt in range(self._retries + 1):
            try:
                chaos_inject("store.http")
                out = fn(*args)
            except Exception as e:
                if not _is_transient(e):
                    self._m_errors.labels(op=op).inc()
                    raise
                last = e
                self._note_failure(op, e)
                if self._breaker_blocks():
                    break  # threshold hit mid-op: stop hammering
                if attempt < self._retries:
                    self._m_retries.inc()
                    self._sleep_backoff(attempt)
            else:
                self._note_success()
                return out
        if self._breaker_blocks():
            raise StoreUnavailable(f"store breaker open ({op})") from last
        raise last

    def _sleep_backoff(self, attempt: int) -> None:
        delay = min(self._backoff_cap_s,
                    self._backoff_base_s * (2 ** attempt))
        # Full jitter: desynchronizes retry storms across handler
        # threads hammering the same dead backend.
        time.sleep(delay * self._rng.random())

    def _write(self, op: str, row: Dict):
        """Writes: same retry path, but a transient dead-end lands in
        the journal instead of failing the request — the route response
        still carries a valid request id."""
        if self._breaker_blocks():
            self._journal_write(op, row)
            return None
        for attempt in range(self._retries + 1):
            try:
                out = self._attempt(op, row)
            except Exception as e:
                if not _is_transient(e):
                    self._m_errors.labels(op=op).inc()
                    raise
                self._note_failure(op, e)
                if self._breaker_blocks():
                    break
                if attempt < self._retries:
                    self._m_retries.inc()
                    self._sleep_backoff(attempt)
            else:
                self._note_success()
                return out
        self._journal_write(op, row)
        return None

    # ── Store interface ───────────────────────────────────────────────

    def insert_request(self, row: Dict) -> str:
        # Mint the id up front so the journaled row and any dependent
        # result rows agree on it whether or not the backend is up.
        row = dict(row)
        if not row.get("id"):
            row["id"] = str(uuid.uuid4())
        if "request_time" not in row:
            row["request_time"] = _now_iso()  # journal keeps true time
        out = self._write("insert_request", row)
        return str(out) if out is not None else row["id"]

    def insert_result(self, row: Dict) -> None:
        self._write("insert_result", dict(row))

    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]:
        return self._call("list_history", self._inner.list_history,
                          limit, engine)

    def get_request(self, req_id: str) -> Optional[Dict]:
        return self._call("get_request", self._inner.get_request, req_id)

    def delete_request(self, req_id: str) -> bool:
        return self._call("delete_request", self._inner.delete_request,
                          req_id)

    def ping(self) -> bool:
        """Health probe — doubles as the breaker's half-open driver:
        once the cooldown passes, a ping reaches the backend and a
        success closes the breaker + replays the journal. While cooling
        down it answers False instantly."""
        if self._breaker_blocks():
            return False
        try:
            chaos_inject("store.http")
            ok = bool(self._inner.ping())
        except Exception as e:
            if not _is_transient(e):
                raise
            self._note_failure("ping", e)
            return False
        if ok:
            self._note_success()
        else:
            self._note_failure("ping", ConnectionError("ping returned False"))
        return ok

    # ── introspection ─────────────────────────────────────────────────

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._open or bool(self._journal)

    def resilience(self) -> Dict:
        with self._lock:
            return {
                "breaker": "open" if self._open else "closed",
                "consecutive_failures": self._failures,
                "journal_depth": len(self._journal),
                "journal_limit": self._journal_limit,
            }

    @property
    def kind(self) -> str:
        return self._inner.kind


class TracedStore:
    """Store decorator: every operation becomes a child span of the
    ambient request trace plus one observation in the process registry's
    ``rtpu_store_op_seconds{op,backend}`` histogram. Pure
    pass-through otherwise (same Protocol, same exceptions)."""

    def __init__(self, inner: Store) -> None:
        self._inner = inner
        self._hist = get_registry().histogram(
            "rtpu_store_op_seconds", "Store operation latency.",
            ("op", "backend"))

    def _call(self, op: str, fn, *args):
        t0 = time.perf_counter()
        with trace_span(f"store.{op}", backend=self._inner.kind):
            try:
                return fn(*args)
            finally:
                self._hist.labels(op=op, backend=self._inner.kind).observe(
                    time.perf_counter() - t0)

    def insert_request(self, row: Dict) -> str:
        return self._call("insert_request", self._inner.insert_request, row)

    def insert_result(self, row: Dict) -> None:
        return self._call("insert_result", self._inner.insert_result, row)

    def list_history(self, limit: int,
                     engine: Optional[str] = None) -> List[Dict]:
        return self._call("list_history", self._inner.list_history,
                          limit, engine)

    def get_request(self, req_id: str) -> Optional[Dict]:
        return self._call("get_request", self._inner.get_request, req_id)

    def delete_request(self, req_id: str) -> bool:
        return self._call("delete_request", self._inner.delete_request,
                          req_id)

    def ping(self) -> bool:
        return self._call("ping", self._inner.ping)

    @property
    def degraded(self) -> bool:
        return bool(getattr(self._inner, "degraded", False))

    @property
    def resilience(self):
        # The inner ResilientStore's snapshot method, or None for a
        # bare store (health reports resilience only when it exists).
        return getattr(self._inner, "resilience", None)

    @property
    def kind(self) -> str:
        return self._inner.kind


def make_store(supabase_url: Optional[str],
               service_key: Optional[str]) -> Store:
    """Backend → resilience layer → tracing, outermost last: PostgREST
    when a Supabase URL and key are both set, else memory. Retry /
    breaker / journal knobs are env-tunable (``RTPU_STORE_*``) with
    boot-safe parsing (a malformed value keeps the default)."""

    def _num(name, default, cast):
        raw = os.environ.get(name)
        if not raw:
            return default
        try:
            return cast(raw)
        except ValueError:
            return default

    inner: Store
    if supabase_url and service_key:
        inner = PostgRESTStore(supabase_url, service_key)
    else:
        inner = InMemoryStore()
    resilient = ResilientStore(
        inner,
        retries=_num("RTPU_STORE_RETRIES", 2, int),
        backoff_base_s=_num("RTPU_STORE_BACKOFF_MS", 50.0, float) / 1000.0,
        breaker_threshold=_num("RTPU_STORE_BREAKER_AFTER", 3, int),
        cooldown_s=_num("RTPU_STORE_COOLDOWN_S", 5.0, float),
        journal_limit=_num("RTPU_STORE_JOURNAL", 512, int),
    )
    return TracedStore(resilient)
