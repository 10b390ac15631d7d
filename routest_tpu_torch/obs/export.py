"""Span sinks: bounded in-memory buffer, tail-based retention, JSONL,
Chrome trace_event JSON, and the per-span device-trace hook.

The buffer is the debug surface behind ``/api/trace``: newest-last,
bounded (old spans fall off — this is a flight recorder, not storage).
:class:`TailSampler` sits in front of it when tail-based retention is
armed (``RTPU_TAIL_SAMPLE=1``): every trace's spans buffer briefly and
the KEEP decision is made at root completion — slow, errored, or
reservoir-sampled — so the buffer reliably holds the p99.9 outlier
instead of a head-sampled dice roll (the Dapper→tail-sampling lineage:
the trace you need is precisely the one head sampling probably missed).
``to_chrome_trace`` renders spans as complete ("X") trace events loadable
directly in ``chrome://tracing`` / Perfetto, one row per thread, with the
trace/span ids in ``args`` so a row correlates back to log lines by
request id.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple


class SpanBuffer:
    """Thread-safe bounded ring of finished span records (plain dicts)."""

    def __init__(self, capacity: int = 2048) -> None:
        self._deque: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, rec: dict) -> None:
        with self._lock:
            if len(self._deque) == self._deque.maxlen:
                self.dropped += 1
            self._deque.append(rec)

    def snapshot(self, trace_id: Optional[str] = None,
                 limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            spans = list(self._deque)
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        if limit is not None and limit >= 0:
            spans = spans[-limit:]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._deque.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._deque)


class _PendingTrace:
    __slots__ = ("spans", "created", "has_error", "dropped_spans")

    def __init__(self) -> None:
        self.spans: List[dict] = []
        self.created = time.monotonic()
        self.has_error = False
        self.dropped_spans = 0


class TailSampler:
    """Tail-based trace retention: buffer, then decide at completion.

    ``offer(rec)`` takes every finished span record. Non-root spans
    buffer under their trace id; the LOCAL-root span's completion —
    ``parent_id is None`` (a true root: the gateway edge), or
    ``remote_parent`` (the parent arrived via ``traceparent`` from
    another process: the replica edge behind a gateway) — triggers the
    verdict:

    - **slow** — the root's duration exceeds its route's latency
      threshold (derived from the SLO objective spec, the same numbers
      the burn-rate engine alerts on; ``default_slow_ms`` covers routes
      with no objective);
    - **error** — any span in the trace finished with status ``error``;
    - **probe** — the root carries the blackbox prober's ``probe``
      attr (tagged ``X-RTPU-Probe`` traffic): always kept, so a
      correctness page can point at the offending probe's trace;
    - **reservoir** — a small random fraction of normal traces is kept
      anyway, so the buffer stays representative of healthy traffic;
    - otherwise the whole trace is dropped.

    Kept traces return ``(reason, spans)`` — the tracer moves them into
    the main span buffer (and the JSONL export), root stamped with
    ``tail: <reason>``. The pending set is bounded (``max_pending``
    traces, ``max_spans`` per trace, ``ttl_s`` age — roots that never
    complete, e.g. severed SSE streams, age out) so a trace storm can
    never hold unbounded memory."""

    MAX_SPANS_PER_TRACE = 512

    def __init__(self, thresholds: Sequence[Tuple[str, float]] = (),
                 default_slow_ms: float = 1000.0,
                 reservoir: float = 0.02, max_pending: int = 256,
                 ttl_s: float = 60.0) -> None:
        # (route substring, threshold ms), most specific (longest)
        # first; a root's path matches the first containing entry.
        self.thresholds = sorted(
            ((r, float(ms)) for r, ms in thresholds if ms),
            key=lambda rt: len(rt[0]), reverse=True)
        self.default_slow_ms = float(default_slow_ms)
        self.reservoir = max(0.0, min(1.0, float(reservoir)))
        self.max_pending = max(1, int(max_pending))
        self.ttl_s = float(ttl_s)
        self._pending: "collections.OrderedDict[str, _PendingTrace]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._rng = random.Random()
        from routest_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._m_traces = reg.counter(
            "rtpu_tail_traces_total",
            "Tail-sampling verdicts, by decision.", ("decision",))
        self._m_pending = reg.gauge(
            "rtpu_tail_pending_traces",
            "Traces currently buffered awaiting their root's completion.")

    @classmethod
    def from_obs_config(cls, obs) -> "TailSampler":
        """Build from :class:`~routest_tpu_torch.core.config.ObsConfig`:
        per-route thresholds come from the SLO objective spec (built-in
        defaults when empty) unless ``tail_slow_ms`` pins one flat
        threshold."""
        thresholds: List[Tuple[str, float]] = []
        default_ms = obs.tail_slow_ms or 1000.0
        if not obs.tail_slow_ms:
            from routest_tpu_torch.core.config import load_slo_config
            from routest_tpu_torch.obs.slo import (GATEWAY_DEFAULT_OBJECTIVES,
                                             REPLICA_DEFAULT_OBJECTIVES,
                                             parse_objective_spec)

            objs = parse_objective_spec(load_slo_config().objectives)
            if not objs:
                objs = (REPLICA_DEFAULT_OBJECTIVES
                        + GATEWAY_DEFAULT_OBJECTIVES)
            for obj in objs:
                if obj.get("latency_ms"):
                    thresholds.append((obj["route"], obj["latency_ms"]))
        return cls(thresholds=thresholds, default_slow_ms=default_ms,
                   reservoir=obs.tail_reservoir,
                   max_pending=obs.tail_max_pending, ttl_s=obs.tail_ttl_s)

    def slow_threshold_ms(self, path: str) -> float:
        for route, ms in self.thresholds:
            if route in path:
                return ms
        return self.default_slow_ms

    # ── the protocol ──────────────────────────────────────────────────

    def offer(self, rec: dict) -> Optional[Tuple[str, List[dict]]]:
        """One finished span record. → ``(reason, spans)`` when this
        record completed a trace that is KEPT, else None."""
        trace_id = rec.get("trace_id")
        if trace_id is None:
            return None
        with self._lock:
            self._purge_locked()
            pending = self._pending.get(trace_id)
            if pending is None:
                pending = self._pending[trace_id] = _PendingTrace()
                while len(self._pending) > self.max_pending:
                    self._pending.popitem(last=False)
                    self._m_traces.labels(decision="dropped_overflow").inc()
            local_root = rec.get("parent_id") is None \
                or rec.get("remote_parent")
            # The root always buffers (it carries the verdict and the
            # tail stamp); an over-cap CHILD is counted, not kept.
            if len(pending.spans) < self.MAX_SPANS_PER_TRACE \
                    or local_root:
                pending.spans.append(rec)
            else:
                pending.dropped_spans += 1
            if rec.get("status") == "error":
                pending.has_error = True
            if not local_root:
                self._m_pending.set(len(self._pending))
                return None
            # Root completion: the verdict.
            self._pending.pop(trace_id, None)
            self._m_pending.set(len(self._pending))
        path = str((rec.get("attrs") or {}).get("path")
                   or rec.get("name") or "")
        duration_ms = rec.get("duration_ms") or 0.0
        if pending.has_error:
            reason = "error"
        elif duration_ms >= self.slow_threshold_ms(path):
            reason = "slow"
        elif (rec.get("attrs") or {}).get("probe"):
            # Blackbox-probe traces are always retained: probes run at
            # a bounded low rate, and a correctness-page bundle must be
            # able to point at the offending probe's kept trace.
            reason = "probe"
        elif self._rng.random() < self.reservoir:
            reason = "reservoir"
        else:
            self._m_traces.labels(decision="dropped").inc()
            return None
        self._m_traces.labels(decision=reason).inc()
        rec["tail"] = reason
        if pending.dropped_spans:
            rec["tail_dropped_spans"] = pending.dropped_spans
        return reason, pending.spans

    def _purge_locked(self) -> None:
        cut = time.monotonic() - self.ttl_s
        while self._pending:
            trace_id, oldest = next(iter(self._pending.items()))
            if oldest.created >= cut:
                break
            del self._pending[trace_id]
            self._m_traces.labels(decision="dropped_expired").inc()

    def snapshot(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "max_pending": self.max_pending,
                    "ttl_s": self.ttl_s,
                    "reservoir": self.reservoir,
                    "default_slow_ms": self.default_slow_ms,
                    "thresholds": [
                        {"route": r, "slow_ms": ms}
                        for r, ms in self.thresholds]}


def to_jsonl(spans: Iterable[dict]) -> str:
    return "".join(json.dumps(s, default=str) + "\n" for s in spans)


def to_chrome_trace(spans: Iterable[dict]) -> dict:
    """Chrome trace_event JSON (the Trace Event Format's "X" complete
    events): ts/dur in microseconds, pid = this process, tid = the
    recording thread, ids and attrs under args."""
    pid = os.getpid()
    events = []
    for s in spans:
        events.append({
            "name": s.get("name", "?"),
            "ph": "X",
            "ts": float(s.get("start_unix", 0.0)) * 1e6,
            "dur": float(s.get("duration_ms") or 0.0) * 1e3,
            "pid": pid,
            "tid": s.get("thread", 0),
            "cat": s.get("status", "ok"),
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                **(s.get("attrs") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ── device-trace attachment ──────────────────────────────────────────

_device_trace_lock = threading.Lock()
_device_traces_taken = 0


def maybe_device_trace(span, device="cuda"):
    """Context manager: a ``torch.profiler`` capture for THIS span (CUDA
    activity when ``device`` is the card, CPU activity always), when
    (a) the span is sampled, (b) ``RTPU_OBS_DEVICE_TRACE_DIR`` (or
    ObsConfig.device_trace_dir) names a directory, and (c) the
    per-process budget (``RTPU_OBS_DEVICE_TRACE_MAX``, default 1 —
    device captures are heavyweight) has not run out. The Chrome trace
    lands in ``torch_<trace_id>_<span_id>/trace.json`` under that
    directory (the span's ``device_trace_dir`` attr), so
    ``chrome://tracing`` rows, log lines and the kernel timeline all
    correlate through one trace id. A capture the profiler refuses
    (another capture holds it, or it cannot start) is named on the span
    as ``device_trace_error`` and logged; the traced work runs all the
    same. Returns a null context otherwise."""
    import contextlib

    if span is None or not getattr(span, "sampled", False):
        return contextlib.nullcontext()
    # Fast path first: this runs on every sampled flush, and building a
    # full ObsConfig (an os.environ copy) per flush is measurable — one
    # env lookup decides the common no-capture case.
    if not os.environ.get("RTPU_OBS_DEVICE_TRACE_DIR"):
        return contextlib.nullcontext()
    from routest_tpu_torch.core.config import load_obs_config

    obs = load_obs_config()
    if not obs.device_trace_dir:
        return contextlib.nullcontext()
    global _device_traces_taken
    with _device_trace_lock:
        if _device_traces_taken >= obs.device_trace_max:
            return contextlib.nullcontext()
        _device_traces_taken += 1
    log_dir = os.path.join(obs.device_trace_dir,
                           f"torch_{span.trace_id}_{span.span_id}")
    span.set_attr("device_trace_dir", log_dir)
    from routest_tpu_torch.utils.profiling import DeviceTrace

    return _span_device_trace(
        span, DeviceTrace(os.path.join(log_dir, "trace.json"), device,
                          who=f"span {span.name} {span.span_id}"))


def _span_device_trace(span, trace):
    import contextlib

    def _refused(stage, e):
        err = f"{stage}: {type(e).__name__}: {e}"
        span.set_attr("device_trace_error", err)
        from routest_tpu_torch.utils.logging import get_logger

        get_logger("routest_tpu_torch.obs.export").warning(
            "device_trace_refused", span=span.name, error=err)

    @contextlib.contextmanager
    def _cm():
        try:
            trace.start()
        except Exception as e:
            _refused("start", e)
            yield
            return
        try:
            yield
        finally:
            try:
                trace.stop()
            except Exception as e:
                _refused("stop", e)

    return _cm()
