"""End-to-end request deadlines: the budget every tier honors.

Dean & Barroso's Tail-at-Scale prescription: a request's deadline must
travel WITH it, shrinking at every hop, so downstream tiers can refuse
work nobody is waiting for instead of computing answers into the void.
The wire format is the ``X-Deadline-Ms`` header carrying the REMAINING
budget in milliseconds (relative, not an absolute timestamp — no clock
sync between tiers required):

- the client (optionally) sends it to the gateway;
- the gateway re-stamps the remaining budget on every upstream hop —
  retries and hedge copies included — after admission queue time is
  spent (``serve/fleet/gateway.py``);
- the replica WSGI layer (``serve/wsgi.py``) rejects already-expired
  requests with 504 before touching the model, and binds the absolute
  deadline to this module's contextvar for the handler's duration;
- the dynamic batcher (``serve/ml_service.py``) captures the ambient
  deadline at submit, drops expired entries at drain time (their
  waiters get :class:`DeadlineExceeded` → 504), and bounds how long a
  waiter can spin against a wedged flush.

The contextvar carries the ABSOLUTE deadline in ``time.monotonic()``
terms — immune to wall-clock steps, comparable across threads in one
process (the batcher's flush thread reads submitters' deadlines).
"""

from __future__ import annotations

import contextvars
import math
import time
from typing import Optional

DEADLINE_HEADER = "X-Deadline-Ms"


class DeadlineExceeded(Exception):
    """The request's end-to-end budget expired; surfaces as HTTP 504."""


_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "rtpu_deadline", default=None)


def parse_deadline_ms(raw) -> Optional[float]:
    """Header value → remaining milliseconds, or None when malformed
    (a bad header means "no deadline", never a 400 — the budget is an
    optimization, not part of request validity)."""
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None
    return value if math.isfinite(value) else None


def bind_deadline(remaining_ms: float) -> contextvars.Token:
    """Bind the current context's absolute deadline from a remaining
    budget; returns the reset token."""
    return _deadline.set(time.monotonic() + remaining_ms / 1000.0)


def reset_deadline(token: contextvars.Token) -> None:
    _deadline.reset(token)


def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (``time.monotonic()`` terms), or
    None when the request carried no budget."""
    return _deadline.get()


def remaining_ms() -> Optional[float]:
    dl = _deadline.get()
    return None if dl is None else (dl - time.monotonic()) * 1000.0


def expired() -> bool:
    dl = _deadline.get()
    return dl is not None and time.monotonic() >= dl
