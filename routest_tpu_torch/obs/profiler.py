"""Triggered on-path profiling: where did the time go, captured live.

When an SLO warns there are two questions the telemetry layer must
answer: *when did it start* (the timeline's job) and *where is the time
going inside the replica* (this module's). Reproducing an incident to
profile it is usually impossible — the profile has to be taken ON the
incident, bounded tightly enough that the capture itself cannot become
one.

:class:`TriggeredProfiler` arms a capture from three sources:

- the SLO engine's **warn/page edge** (``SloEngine.on_warn`` — the
  earliest evidence edge, so the sample brackets the incident's onset);
- ``POST /api/debug/profile`` (an operator asking now);
- direct ``arm()`` calls (benches, tests).

A capture is a **Python stack sampler**: a daemon thread walks
``sys._current_frames()`` every ``interval_ms`` for ``duration_s``,
folding each thread's stack into `semicolon-joined frames → count`
lines (the flamegraph "folded" format — feed it straight to
``flamegraph.pl`` / speedscope), plus a per-function self-time summary.
With ``RTPU_PROFILE_DEVICE=1`` a ``torch.profiler`` capture (CUDA
activity when the replica serves on the card) covers the same window
and ships in the bundle as ``device_trace.json``, a Chrome trace.
``torch.profiler`` is process-wide: when another capture holds it (a
sampled span's device trace), or it cannot start, the refusal is named
in ``profile.json`` (``device_trace_error``), in :meth:`snapshot`, and
so in ``POST /api/debug/profile``'s answer, which waits for the capture
to start. Results ship as a flight-recorder bundle (``profile.folded``
+ ``profile.json`` via the recorder's ``extra_files``), inheriting the
recorder's disk bounds and pruning — a profile is postmortem evidence
like any other.

Budgets: at most ``max_captures`` per process, spaced
``min_interval_s`` apart, one at a time. A warn-storm arms ONE capture,
not a capture storm.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from routest_tpu_torch.core.config import ProfileConfig, load_profile_config
from routest_tpu_torch.obs.registry import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.profiler")


def _fold_stack(frame) -> str:
    """One thread's stack → ``outermost;...;innermost`` of
    ``function (file:line)`` entries, paths trimmed to the last two
    segments (absolute site-packages paths are noise in a flame
    graph)."""
    parts: List[str] = []
    while frame is not None:
        code = frame.f_code
        path = code.co_filename.replace("\\", "/")
        short = "/".join(path.rsplit("/", 2)[-2:])
        parts.append(f"{code.co_name} ({short}:{frame.f_lineno})")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class TriggeredProfiler:
    """Budgeted stack-sample capture → flight-recorder bundle."""

    def __init__(self, config: Optional[ProfileConfig] = None,
                 recorder=None, component: str = "replica",
                 device="cuda") -> None:
        self.config = config or load_profile_config()
        self.component = component
        # The device whose activity a device trace records (the serving
        # device; CPU activity is recorded either way).
        self.device = device
        self.device_trace_error: Optional[str] = None
        self._recorder = recorder
        self._lock = threading.Lock()
        self._running = False
        self._captures = 0
        self._last_capture_mono = -float("inf")
        self.last_bundle: Optional[str] = None
        self.last_reason: Optional[str] = None
        reg = get_registry()
        self._m_captures = reg.counter(
            "rtpu_profile_captures_total",
            "Triggered profile captures, by trigger reason.", ("trigger",))
        self._m_suppressed = reg.counter(
            "rtpu_profile_suppressed_total",
            "Profile triggers suppressed (budget, spacing, or one "
            "already running), by reason.", ("reason",))

    # ── arming ────────────────────────────────────────────────────────

    def arm(self, trigger: str, detail: Optional[dict] = None,
            duration_s: Optional[float] = None,
            wait_start_s: float = 0.0) -> bool:
        """Start a capture on a daemon thread → True when armed, False
        when disabled, already running, out of budget, or inside the
        spacing window. Never waits out the capture (the SLO tick or an
        HTTP handler must not wait out a 2 s capture); with
        ``wait_start_s`` it waits up to that long for the device trace
        to start, so ``device_trace_error`` is current on return."""
        cfg = self.config
        if not cfg.enabled:
            self._m_suppressed.labels(reason="disabled").inc()
            return False
        with self._lock:
            now = time.monotonic()
            if self._running:
                self._m_suppressed.labels(reason="running").inc()
                return False
            if self._captures >= cfg.max_captures:
                self._m_suppressed.labels(reason="budget").inc()
                return False
            if now - self._last_capture_mono < cfg.min_interval_s:
                self._m_suppressed.labels(reason="spacing").inc()
                return False
            self._running = True
            self._captures += 1
            self._last_capture_mono = now
        duration = min(30.0, duration_s if duration_s and duration_s > 0
                       else cfg.duration_s)
        self._m_captures.labels(trigger=trigger).inc()
        _log.info("profile_armed", trigger=trigger, duration_s=duration,
                  capture=self._captures, budget=cfg.max_captures)
        started = threading.Event()
        self._started = started
        threading.Thread(
            target=self._capture, args=(trigger, detail or {}, duration),
            daemon=True, name="triggered-profiler").start()
        if wait_start_s > 0:
            started.wait(wait_start_s)
        return True

    # ── capture ───────────────────────────────────────────────────────

    def _capture(self, trigger: str, detail: dict,
                 duration_s: float) -> None:
        try:
            self._capture_inner(trigger, detail, duration_s)
        except Exception as e:
            # A failed capture is loggable evidence loss, never a crash
            # inside the incident that triggered it.
            _log.error("profile_capture_failed", trigger=trigger,
                       error=f"{type(e).__name__}: {e}")
        finally:
            self._started.set()
            with self._lock:
                self._running = False

    def _capture_inner(self, trigger: str, detail: dict,
                       duration_s: float) -> None:
        cfg = self.config
        interval = max(0.001, cfg.interval_ms / 1000.0)
        own_thread = threading.get_ident()
        stacks: Dict[int, Dict[str, int]] = {}
        samples = 0
        device = self._start_device_trace(trigger)
        self._started.set()
        t0 = time.time()
        deadline = time.monotonic() + duration_s
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == own_thread:
                    continue
                folded = _fold_stack(frame)
                per = stacks.setdefault(tid, {})
                per[folded] = per.get(folded, 0) + 1
            samples += 1
            time.sleep(interval)
        device_trace = self._stop_device_trace(device)
        # Merge threads for the folded output (thread id as the root
        # frame so per-thread flames stay separable), and tally
        # self-time by innermost frame for the summary.
        names = {t.ident: t.name for t in threading.enumerate()}
        folded_lines: List[str] = []
        self_time: Dict[str, int] = {}
        for tid, per in sorted(stacks.items()):
            tname = names.get(tid, f"tid-{tid}")
            for stack, count in sorted(per.items(), key=lambda kv: -kv[1]):
                folded_lines.append(f"{tname};{stack} {count}")
                leaf = stack.rsplit(";", 1)[-1]
                self_time[leaf] = self_time.get(leaf, 0) + count
        top = sorted(self_time.items(), key=lambda kv: -kv[1])[:25]
        meta = {
            "trigger": trigger,
            "detail": detail,
            "component": self.component,
            "started_unix": round(t0, 3),
            "duration_s": duration_s,
            "interval_ms": cfg.interval_ms,
            "samples": samples,
            "threads": len(stacks),
            "top_self": [{"frame": f, "samples": c,
                          "frac": round(c / max(1, samples *
                                                max(1, len(stacks))), 4)}
                         for f, c in top],
        }
        if self.config.device_trace:
            meta["device_trace_error"] = self.device_trace_error
        extra = {"profile.folded": "\n".join(folded_lines) + "\n",
                 "profile.json": json.dumps(meta, indent=2, default=str)}
        if device_trace is not None:
            extra["device_trace.json"] = device_trace
        recorder = self._recorder
        if recorder is None:
            from routest_tpu_torch.obs.recorder import get_recorder

            recorder = get_recorder()
        bundle = recorder.trigger(
            f"profile_{trigger}", {"trigger": trigger, **detail,
                                   "samples": samples},
            force=True, extra_files=extra)
        with self._lock:
            self.last_bundle = bundle
            self.last_reason = trigger
        _log.warning("profile_captured", trigger=trigger, samples=samples,
                     threads=len(stacks), bundle=bundle)

    # ── device trace (opt-in) ─────────────────────────────────────────

    def _start_device_trace(self, trigger: str):
        """→ a started :class:`DeviceTrace`, or None (off, or refused:
        the reason lands in ``device_trace_error``)."""
        self.device_trace_error = None
        if not self.config.device_trace:
            return None
        try:
            from routest_tpu_torch.core.config import load_recorder_config
            from routest_tpu_torch.utils.profiling import DeviceTrace

            root = (self._recorder.config if self._recorder is not None
                    else load_recorder_config()).dir
            path = os.path.join(
                os.path.abspath(root), "profiles",
                f"torch_{int(time.time() * 1000)}_{trigger}", "trace.json")
            trace = DeviceTrace(path, self.device,
                                who=f"triggered profile {trigger}")
            trace.start()
            return trace
        except Exception as e:
            self.device_trace_error = f"{type(e).__name__}: {e}"
            _log.error("profile_device_trace_failed",
                       error=self.device_trace_error)
            return None

    def _stop_device_trace(self, trace) -> Optional[str]:
        """→ the Chrome trace's text (its working file is removed), or
        None when there was no capture or writing it failed."""
        if trace is None:
            return None
        import shutil

        try:
            trace.stop()
            with open(trace.path) as f:
                return f.read()
        except Exception as e:
            self.device_trace_error = f"{type(e).__name__}: {e}"
            _log.error("profile_device_trace_stop_failed",
                       error=self.device_trace_error)
            return None
        finally:
            shutil.rmtree(os.path.dirname(trace.path), ignore_errors=True)

    # ── introspection / wiring ────────────────────────────────────────

    def on_slo_edge(self, slo: str, detail: dict) -> None:
        """``SloEngine.on_warn`` adapter: the warn→page climb arms one
        bounded capture while the incident is still forming."""
        self.arm("slo_" + str(detail.get("to", "warn")),
                 {"slo": slo, **{k: v for k, v in detail.items()
                                 if k in ("from", "to", "burn_fast",
                                          "burn_slow", "route")}})

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "running": self._running,
                "captures": self._captures,
                "max_captures": self.config.max_captures,
                "min_interval_s": self.config.min_interval_s,
                "duration_s": self.config.duration_s,
                "interval_ms": self.config.interval_ms,
                "device_trace": self.config.device_trace,
                "device_trace_error": self.device_trace_error,
                "last_bundle": self.last_bundle,
                "last_reason": self.last_reason,
            }
