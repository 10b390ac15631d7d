"""Structured logging: JSON lines instead of the reference's bare prints.

Every event is one JSON object on stderr: machine-parseable, with logger
name, level, wall time, and free-form fields. Copied from
``routest_tpu/utils/logging.py``; trace-span correlation and the flight
recorder's log tee arrive with the observability slice.
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


def set_request_id(rid: Optional[str]):
    """Bind the current context's request id; returns the reset token."""
    return _request_id.set(rid)


def reset_request_id(token) -> None:
    _request_id.reset(token)


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
        line = json.dumps(record, default=str)
        with self._lock:
            try:
                print(line, file=self._stream, flush=True)
            except ValueError:
                # The stream can be closed under us (pytest tears its
                # capture stream down while daemon threads are still
                # finishing); a log line must never crash its thread.
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
