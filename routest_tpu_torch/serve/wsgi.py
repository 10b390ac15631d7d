"""Minimal WSGI micro-framework on the standard library alone.

The counterpart of ``routest_tpu/serve/wsgi.py`` without werkzeug, which
the machine with the card does not have: a small :class:`Request` /
:class:`Response` over the WSGI environ, method+path routing with
``<param>`` captures, JSON request/response helpers with the same
400/413/504 behaviour and error bodies, the reference's CORS policy
(localhost:3000 + ``*.vercel.app``, ``Flaskr/__init__.py:14-23``),
streamed responses for SSE, per-route request stats
(``App.request_stats``, read by ``/api/metrics``; streamed responses are
skipped, their lifetime is connection time), and a threaded ``wsgiref``
server that drains in-flight handlers on SIGTERM. Cookies are read
with ``http.cookies`` and written with werkzeug's attributes (one
``Set-Cookie`` line each). Every request runs inside a
``replica.request`` span (a caller's W3C ``traceparent`` is adopted,
``X-Trace-Id`` is echoed), its handler inside ``replica.handler``, and
the flight recorder keeps one record per completed request; probe
traffic (``X-RTPU-Probe``) counts in its own family, never in the
route stats the SLO engine rolls up.
"""

from __future__ import annotations

import email.utils
import http
import http.cookies
import json
import os
import re
import signal
import socketserver
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer

from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.recorder import get_recorder
from routest_tpu_torch.obs.trace import (REQUEST_ID_RE, mint_request_id,
                                         parse_traceparent, trace_span)
from routest_tpu_torch.serve.deadline import (DEADLINE_HEADER,
                                              DeadlineExceeded,
                                              bind_deadline,
                                              parse_deadline_ms,
                                              reset_deadline)
from routest_tpu_torch.utils.logging import (get_logger, reset_request_id,
                                             set_request_id)
from routest_tpu_torch.utils.profiling import RequestStats

_PARAM_RE = re.compile(r"<([a-zA-Z_][a-zA-Z0-9_]*)>")
# Origins the reference allows: the localhost dev origins plus the
# configured production frontend (``ROUTEST_FRONTEND_ORIGIN``) get
# credentialed CORS; the ``*.vercel.app`` wildcard stays reachable but
# credential-less (any Vercel tenant can host an origin matching it).
_CREDENTIALED_ORIGIN_RE = re.compile(
    r"^https?://localhost:3000$|^https?://127\.0\.0\.1:3000$"
)
_PUBLIC_ORIGIN_RE = re.compile(r"^https://[a-z0-9-]+\.vercel\.app$")

# Cookie values werkzeug sends unquoted (its ``_cookie_no_quote_re``);
# any other value is quoted: ``"`` and ``\`` backslash-escaped, the other
# bytes outside that set as three-digit octal escapes, as werkzeug and
# http.cookies do.
_COOKIE_PLAIN_RE = re.compile(r"[\w!#$%&'()*+\-./:<=>?@\[\]^`{|}~]*")
_COOKIE_ESCAPE_RE = re.compile(rb"[\x00-\x19\",;\\\x7f-\xff]")

# Compact separators: the default pads every delimiter with a space —
# pure wire bloat on multi-thousand-row batch responses.
_JSON_SEPARATORS = (",", ":")


class RequestEntityTooLarge(Exception):
    """The request body exceeds ``RTPU_MAX_BODY_MB``; surfaces as 413."""


class Request:
    """The parts of the WSGI environ the handlers read."""

    def __init__(self, environ: dict) -> None:
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "") or "/"
        self._data: Optional[bytes] = None
        # The parsed query string, first value per name (what werkzeug's
        # ``request.args.get`` returns).
        self.args: Dict[str, str] = {}
        self._query = parse_qsl(environ.get("QUERY_STRING", ""),
                                keep_blank_values=True)
        for name, value in self._query:
            self.args.setdefault(name, value)
        self.remote_addr: Optional[str] = environ.get("REMOTE_ADDR")
        self.content_type: str = environ.get("CONTENT_TYPE", "")
        self.scheme: str = environ.get("wsgi.url_scheme", "http")
        self._cookies: Optional[Dict[str, str]] = None

    def arg_list(self, name: str) -> List[str]:
        """Every value of a repeated query parameter, in order (what
        werkzeug's ``request.args.getlist`` returns)."""
        return [v for k, v in self._query if k == name]

    @property
    def cookies(self) -> Dict[str, str]:
        """The ``Cookie`` header as name → value (parsed once). A header
        ``http.cookies`` refuses reads as no cookies."""
        if self._cookies is None:
            jar = http.cookies.SimpleCookie()
            try:
                jar.load(self.environ.get("HTTP_COOKIE", ""))
            except http.cookies.CookieError:
                jar = http.cookies.SimpleCookie()
            self._cookies = {name: m.value for name, m in jar.items()}
        return self._cookies

    @property
    def content_length(self) -> Optional[int]:
        raw = self.environ.get("CONTENT_LENGTH")
        try:
            return max(0, int(raw)) if raw else None
        except ValueError:
            return None

    def header(self, name: str, default: str = "") -> str:
        return self.environ.get(
            "HTTP_" + name.upper().replace("-", "_"), default)

    def get_data(self) -> bytes:
        """The body (read once, then cached). Only ``Content-Length``
        bytes are read; a declared length over the body ceiling raises
        :class:`RequestEntityTooLarge` before any byte is read."""
        if self._data is None:
            n = self.content_length or 0
            if n > _max_body_bytes():
                raise RequestEntityTooLarge()
            self._data = self.environ["wsgi.input"].read(n) if n else b""
        return self._data


class Response:
    """A whole body (``str`` or bytes), or a streamed one: any other
    iterable of byte chunks (an SSE generator), sent without a
    ``Content-Length`` as the iterable yields, until it ends or the
    client goes away (the server then closes the iterable)."""

    def __init__(self, body=b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None) -> None:
        if isinstance(body, str):
            body = body.encode()
        self.is_streamed = not isinstance(body, (bytes, bytearray,
                                                 memoryview))
        self.body = body if self.is_streamed else bytes(body)
        self.status_code = status
        self.headers = {"Content-Type": content_type}
        if headers:
            self.headers.update(headers)
        # One ``Set-Cookie`` value per cookie: sent as repeated headers.
        self.cookies: List[str] = []

    def set_cookie(self, name: str, value: str = "", *,
                   max_age: Optional[int] = None, path: str = "/",
                   secure: bool = False, httponly: bool = False,
                   samesite: Optional[str] = None,
                   expires: Optional[float] = None) -> None:
        """Add a ``Set-Cookie`` line with werkzeug's attributes, in its
        order; ``max_age`` without ``expires`` also sets ``Expires``."""
        if samesite is not None:
            samesite = samesite.title()
            if samesite not in ("Strict", "Lax", "None"):
                raise ValueError("SameSite must be 'Strict', 'Lax', or 'None'.")
        if not _COOKIE_PLAIN_RE.fullmatch(value):
            value = '"' + _COOKIE_ESCAPE_RE.sub(
                lambda m: (b"\\" + m.group() if m.group() in (b'"', b"\\")
                           else b"\\%03o" % m.group()[0]),
                value.encode()).decode("ascii") + '"'
        if expires is None and max_age is not None:
            expires = time.time() + max_age
        parts = [f"{name}={value}"]
        if expires is not None:
            parts.append("Expires="
                         + email.utils.formatdate(expires, usegmt=True))
        if max_age is not None:
            parts.append(f"Max-Age={int(max_age)}")
        if secure:
            parts.append("Secure")
        if httponly:
            parts.append("HttpOnly")
        if path is not None:
            parts.append(f"Path={path}")
        if samesite is not None:
            parts.append(f"SameSite={samesite}")
        self.cookies.append("; ".join(parts))

    def delete_cookie(self, name: str, path: str = "/", *,
                      secure: bool = False, httponly: bool = False,
                      samesite: Optional[str] = None) -> None:
        """Expire a cookie: empty value, ``Expires`` at the epoch,
        ``Max-Age=0`` (werkzeug's ``delete_cookie``)."""
        self.set_cookie(name, "", max_age=0, expires=0, path=path,
                        secure=secure, httponly=httponly, samesite=samesite)

    def __call__(self, environ, start_response):
        try:
            reason = http.HTTPStatus(self.status_code).phrase
        except ValueError:
            reason = "Unknown"
        # one pair per header, one per cookie
        headers = (list(self.headers.items())
                   + [("Set-Cookie", c) for c in self.cookies])
        if not self.is_streamed:
            headers.append(("Content-Length", str(len(self.body))))
        start_response(f"{self.status_code} {reason}", headers)
        return self.body if self.is_streamed else [self.body]


def json_response(payload: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(json.dumps(payload, separators=_JSON_SEPARATORS),
                    status=status, content_type="application/json",
                    headers=headers)


class App:
    """Route table + WSGI callable with per-route latency stats."""

    def __init__(self) -> None:
        self._routes: List[Tuple[str, str, re.Pattern, Callable]] = []
        # Exact-match fast path: parameterless routes resolve with ONE
        # dict lookup instead of a linear regex scan.
        self._exact: Dict[Tuple[str, str], Tuple[Callable, str]] = {}
        self.request_stats = RequestStats()
        # Graceful-drain bookkeeping: handlers currently executing (the
        # SIGTERM path waits for this to hit zero before exiting). A
        # streamed (SSE) body is iterated after __call__ returns: it is
        # a long-lived connection, not a unit of work, so the drain
        # does not wait on open streams.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._m_expired = get_registry().counter(
            "rtpu_replica_expired_total",
            "Requests rejected with 504: deadline already expired at "
            "the replica edge.")
        # Probe traffic (X-RTPU-Probe header) counts HERE instead of the
        # per-route request-stat families the SLO engine rolls up:
        # synthetic probe load must never burn user error budget.
        self._m_probe = get_registry().counter(
            "rtpu_probe_replica_requests_total",
            "Probe-tagged requests served by this replica (excluded "
            "from the user request-stat families), by route.",
            ("route",))

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def route(self, path: str, methods: Tuple[str, ...] = ("GET",)):
        pattern = re.compile(
            "^" + _PARAM_RE.sub(r"(?P<\1>[^/]+)", path) + "$"
        )

        def register(fn: Callable) -> Callable:
            for m in methods:
                self._routes.append((m.upper(), path, pattern, fn))
                if "<" not in path:
                    self._exact[(m.upper(), path)] = (fn, path)
            return fn

        return register

    def _match(self, method: str, path: str):
        hit = self._exact.get((method, path))
        if hit is not None:
            return hit[0], hit[1], {}, None
        allowed: List[str] = []
        for m, template, pattern, fn in self._routes:
            match = pattern.match(path)
            if match:
                if m == method:
                    return fn, template, match.groupdict(), None
                allowed.append(m)
        return None, None, {}, allowed

    def __call__(self, environ, start_response):
        request = Request(environ)
        # Correlation id: honor a well-formed X-Request-ID, else mint
        # one; bound to the logging context for the handler's duration
        # and echoed on the response.
        rid = request.header("X-Request-ID")
        if not REQUEST_ID_RE.match(rid):
            rid = mint_request_id()
        token = set_request_id(rid)
        # Trace context: adopt the caller's ``traceparent``; a missing or
        # malformed header starts a new root HERE (parent=None, never
        # the ambient context of a reused server thread).
        remote_ctx = parse_traceparent(request.header("traceparent") or None)
        # Deadline propagation: an already-expired request is rejected
        # with 504 here, before model or device work.
        raw_deadline = request.header(DEADLINE_HEADER)
        deadline_ms = parse_deadline_ms(raw_deadline) if raw_deadline else None
        # Synthetic-probe tag: the route-stats record sites divert to
        # the probe family, and the root span carries it.
        probe_kind = request.header("X-RTPU-Probe") or None
        request._rtpu_probe = probe_kind
        with self._inflight_lock:
            self._inflight += 1
        t0 = time.perf_counter()
        try:
            with trace_span("replica.request", parent=remote_ctx,
                            method=request.method, path=request.path,
                            request_id=rid) as span:
                if probe_kind:
                    span.set_attr("probe", probe_kind)
                dl_token = None
                try:
                    if deadline_ms is not None and deadline_ms <= 0:
                        self._m_expired.inc()
                        # An edge rejection counts in the route's stats:
                        # a deadline storm is an availability incident.
                        _fn, template, _kw, _al = self._match(
                            request.method, request.path)
                        route = f"{request.method} {template or request.path}"
                        if probe_kind:
                            self._m_probe.labels(route=route).inc()
                        else:
                            self.request_stats.add(route, 0.0, error=True)
                        response = json_response(
                            {"error": "deadline exceeded",
                             "deadline_ms": deadline_ms}, 504)
                    else:
                        if deadline_ms is not None:
                            dl_token = bind_deadline(deadline_ms)
                        response = self._dispatch(request)
                except Exception as e:  # last resort: one request, not the server
                    get_logger("routest_tpu_torch.serve").error(
                        "handler_failed", path=request.path,
                        error=f"{type(e).__name__}: {e}")
                    response = json_response(
                        {"error": f"internal error: {e}"}, 500)
                finally:
                    if dl_token is not None:
                        reset_deadline(dl_token)
                    reset_request_id(token)
                span.set_attr("status", response.status_code)
                if span.trace_id is not None:
                    response.headers["X-Trace-Id"] = span.trace_id
            response.headers["X-Request-ID"] = rid
            self._apply_cors(request, response)
            # Flight recorder: one bounded-ring record per completed
            # request (streamed responses record at handler return).
            get_recorder().record_request(
                tier="replica", method=request.method, path=request.path,
                status=response.status_code,
                duration_ms=(time.perf_counter() - t0) * 1000.0,
                request_id=rid, trace_id=span.trace_id,
                deadline_ms=deadline_ms,
                extra={"probe": probe_kind} if probe_kind else None)
            return response(environ, start_response)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _dispatch(self, request: Request) -> Response:
        if request.method == "OPTIONS":
            return Response("", 204)
        fn, template, kwargs, allowed = self._match(request.method,
                                                     request.path)
        if fn is None:
            if allowed:
                return json_response({"error": "method not allowed"}, 405,
                                     {"Allow": ", ".join(sorted(set(allowed)))})
            return json_response({"error": "not found"}, 404)
        t0 = time.perf_counter()
        response: Optional[Response] = None
        try:
            with trace_span("replica.handler",
                            route=f"{request.method} {template}") as hs:
                result = fn(request, **kwargs)
                if isinstance(result, Response):
                    response = result
                elif isinstance(result, tuple):
                    payload, status = result
                    response = json_response(payload, status)
                else:
                    response = json_response(result)
                hs.set_attr("status", response.status_code)
                hs.set_attr("streamed", response.is_streamed)
            return response
        except RequestEntityTooLarge:
            response = json_response(
                {"error": "request body too large "
                          f"(max {_max_body_bytes() >> 20} MB)"}, 413)
            return response
        except DeadlineExceeded:
            # The budget ran out mid-handler (typically: the batcher
            # dropped this request's rows at drain time).
            self._m_expired.inc()
            response = json_response({"error": "deadline exceeded"}, 504)
            return response
        finally:
            # An unhandled exception (→ 500 in __call__) counts as an
            # error; a streamed (SSE) body's lifetime is connection
            # time, not handler latency, so it is skipped.
            if response is None or not response.is_streamed:
                error = response is None or response.status_code >= 500
                route = f"{request.method} {template}"
                if getattr(request, "_rtpu_probe", None):
                    # Probe traffic: its own family, never the user
                    # request stats the SLO engine rolls up.
                    self._m_probe.labels(route=route).inc()
                else:
                    self.request_stats.add(route,
                                           time.perf_counter() - t0,
                                           error=error)

    @staticmethod
    def _apply_cors(request: Request, response: Response) -> None:
        origin = request.header("Origin")
        if not origin:
            return
        credentialed = bool(_CREDENTIALED_ORIGIN_RE.match(origin)) or \
            origin == os.environ.get("ROUTEST_FRONTEND_ORIGIN")
        if not credentialed and not _PUBLIC_ORIGIN_RE.match(origin):
            return
        response.headers["Access-Control-Allow-Origin"] = origin
        response.headers["Vary"] = "Origin"
        response.headers["Access-Control-Allow-Methods"] = \
            "GET, POST, DELETE, OPTIONS"
        if credentialed:
            response.headers["Access-Control-Allow-Headers"] = \
                "Content-Type, Authorization, X-XSRF-TOKEN"
            response.headers["Access-Control-Allow-Credentials"] = "true"
        else:
            response.headers["Access-Control-Allow-Headers"] = \
                "Content-Type, Authorization"


# (raw env value, parsed bytes): _max_body_bytes runs on every request,
# so the int-parse is memoized on the raw string — a changed env var
# still takes effect on the next request.
_body_limit_memo: Tuple[Optional[str], int] = (None, 64 << 20)


def _max_body_bytes() -> int:
    """Request-body ceiling in bytes (``RTPU_MAX_BODY_MB``, default 64;
    malformed or non-positive values keep the default)."""
    global _body_limit_memo
    raw = os.environ.get("RTPU_MAX_BODY_MB")
    memo_raw, memo_bytes = _body_limit_memo
    if raw == memo_raw:
        return memo_bytes
    try:
        mb = int(raw)
    except (TypeError, ValueError):
        mb = 64
    if mb <= 0:
        mb = 64
    _body_limit_memo = (raw, mb << 20)
    return mb << 20


_JSON_MISSING = object()


def get_json(request: Request, silent: bool = True) -> Optional[dict]:
    """Parse the request body as a JSON OBJECT. A syntactically valid
    but non-object top level (``[1,2,3]``, ``"str"``, ``42``) coerces to
    None exactly like malformed JSON, so handlers' ``or {}`` yields
    their normal "missing field" 400s. Memoized on the request (dispatch
    aliases such as ``/api/predict`` peek at the body, then delegate)."""
    cached = getattr(request, "_rtpu_json", _JSON_MISSING)
    if cached is not _JSON_MISSING:
        return cached
    raw = request.get_data()
    try:
        parsed = json.loads(raw.decode("utf-8")) if raw else None
    except (ValueError, UnicodeDecodeError):
        if silent:
            request._rtpu_json = None
            return None
        raise
    if not isinstance(parsed, dict):
        parsed = None
    request._rtpu_json = parsed
    return parsed


class _ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # werkzeug's listen backlog (the stdlib default of 5 resets bursts
    # of concurrent connections, e.g. merged dispatch requests)
    request_queue_size = 128


class _QuietHandler(WSGIRequestHandler):
    """One JSON log line per request is the app's job, not stderr's."""

    def log_message(self, format, *args) -> None:  # noqa: A002
        pass


def make_server(app: App, host: str, port: int) -> WSGIServer:
    """A threaded stdlib WSGI server for ``app`` (port 0 = any free
    port; read it back from ``server.server_port``)."""
    server = _ThreadingWSGIServer((host, port), _QuietHandler)
    server.set_app(app)
    return server


def run_with_graceful_shutdown(app: App, host: str, port: int,
                               drain_timeout_s: float = 30.0,
                               ready_event: Optional[threading.Event] = None):
    """Serve ``app`` until SIGTERM/SIGINT, then drain: stop accepting,
    wait up to ``drain_timeout_s`` for in-flight handlers to finish
    (streamed SSE bodies are not waited for), then return. Must run on
    the main thread (signal handlers). Returns the count of handlers still running at exit (0 = clean drain)."""
    log = get_logger("routest_tpu_torch.serve.boot")
    # SIGUSR2 → postmortem bundle; main-thread only, which this function
    # already requires.
    from routest_tpu_torch.obs.recorder import install_sigusr2_trigger

    install_sigusr2_trigger()
    server = make_server(app, host, port)
    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    previous = {sig: signal.signal(sig, _on_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    # shutdown() must come from a different thread than serve_forever().
    def _stopper():
        stop.wait()
        server.shutdown()

    threading.Thread(target=_stopper, daemon=True,
                     name="serve-sigterm-drain").start()
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    finally:
        stop.set()  # serve_forever can also end via server errors
        server.server_close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    log.info("drain_started", inflight=app.inflight,
             timeout_s=drain_timeout_s)
    deadline = time.monotonic() + drain_timeout_s
    while app.inflight > 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    leftover = app.inflight
    if leftover:
        log.warning("drain_timeout", inflight=leftover)
    else:
        log.info("drain_finished")
    return leftover
