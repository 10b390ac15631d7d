"""Structured logging: JSON lines instead of the reference's bare prints.

Every event is one JSON object on stderr: machine-parseable, with logger
name, level, wall time, and free-form fields. Copied from
``routest_tpu/utils/logging.py``: a line emitted inside a trace span
carries its trace and span ids, and the flight recorder's log tee
(``set_log_tee``) sees every record.
"""

from __future__ import annotations

import contextvars
import datetime as dt
import json
import sys
import threading
from typing import Any, Optional, TextIO

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

# Per-request correlation id (set by the WSGI layer): every log line
# emitted while handling a request carries it, so one request's events
# can be grepped out of interleaved multi-threaded logs. Contextvars are
# per-thread-context, so concurrent handlers never see each other's id.
_request_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "rtpu_request_id", default=None)

# Trace correlation: every line emitted inside an active span carries
# the span's trace/span ids automatically, so the flight recorder (and
# a grep) can pull one request's log lines with no per-call-site
# changes. The lookup is deferred-imported: obs.trace imports nothing
# from this module, so this cannot cycle, and utils stays importable
# without the obs package initialized.
_trace_context = None


def _ambient_span_ids():
    global _trace_context
    if _trace_context is None:
        from routest_tpu_torch.obs.trace import current_context

        _trace_context = current_context
    return _trace_context()


# Log tee: the flight recorder installs a callback here to keep a
# bounded ring of recent records (dicts, post-stamping). One slot, not
# a list — there is one process recorder; tests may swap it.
_tee = None


def set_log_tee(fn) -> None:
    """Install (or clear, with None) the process log tee. ``fn`` gets
    every record dict AFTER level filtering and id stamping; it must
    not raise (the recorder's ring append cannot)."""
    global _tee
    _tee = fn


def set_request_id(rid: Optional[str]):
    """Bind the current context's request id; returns the reset token."""
    return _request_id.set(rid)


def reset_request_id(token) -> None:
    _request_id.reset(token)


def current_request_id() -> Optional[str]:
    return _request_id.get()


class JsonLogger:
    def __init__(self, name: str, stream: Optional[TextIO] = None,
                 level: str = "info") -> None:
        self.name = name
        self._stream = stream if stream is not None else sys.stderr
        self._min = _LEVELS[level]
        self._lock = threading.Lock()

    def _emit(self, level: str, event: str, **fields: Any) -> None:
        if _LEVELS[level] < self._min:
            return
        record = {
            "ts": dt.datetime.now(dt.timezone.utc).isoformat(),
            "level": level,
            "logger": self.name,
            "event": event,
            **fields,
        }
        rid = _request_id.get()
        if rid is not None and "request_id" not in record:
            record["request_id"] = rid
        ctx = _ambient_span_ids()
        if ctx is not None:
            # Ids flow even for unsampled traces (same rule the tracer
            # applies to header propagation): correlation must not
            # depend on the sampling coin.
            record.setdefault("trace_id", ctx.trace_id)
            record.setdefault("span_id", ctx.span_id)
        tee = _tee
        if tee is not None:
            tee(record)
        line = json.dumps(record, default=str)
        with self._lock:
            try:
                # One write per line: print() writes the line and its
                # newline separately, and on a pipe that several
                # processes share (a fleet and its replicas) another
                # process's line can land between the two.
                self._stream.write(line + "\n")
                self._stream.flush()
            except ValueError:
                # The stream can be closed under us (pytest tears its
                # capture stream down while daemon threads — SLO
                # ticker, timeline ticker, triggered profiler — are
                # still finishing). The tee above already delivered the
                # record to the flight recorder; a log line must never
                # crash the thread that emitted it.
                pass

    def debug(self, event: str, **fields: Any) -> None:
        self._emit("debug", event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit("info", event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit("warning", event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit("error", event, **fields)


_loggers: dict = {}
_lock = threading.Lock()


def get_logger(name: str) -> JsonLogger:
    with _lock:
        if name not in _loggers:
            _loggers[name] = JsonLogger(name)
        return _loggers[name]
