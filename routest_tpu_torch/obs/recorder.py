"""Always-on flight recorder: bounded request/log rings → postmortem bundles.

The span ring behind ``/api/trace`` already *is* a flight recorder for
spans — but it evaporates with the process, and nothing correlates it
with responses, log lines, or the config that produced them. This
module closes the forensics gap: every completed request appends one
small record (trace id, route, status, duration, deadline budget,
active chaos points) to a bounded ring; every ``JsonLogger`` line
(trace-stamped by ``utils/logging.py``) lands in a second ring; and on
a **trigger** the recorder writes a self-contained postmortem bundle::

    artifacts/postmortems/pm_<utc>_<reason>_<pid>/
        manifest.json     trigger reason+detail, config fingerprint,
                          registry snapshot, SLO state, chaos ledger
        requests.jsonl    the completed-request ring (newest last)
        spans.jsonl       the tracer's span ring (trees reconstruct by
                          trace_id/parent_id)
        logs.jsonl        recent structured log lines (trace-stamped)

Triggers: a 5xx burst, a deadline-expiry (504) spike, an SLO page edge
(the engine's ``on_page`` hook), the store circuit breaker opening,
``SIGUSR2``, and ``POST /api/debug/snapshot``. Automatic triggers are
rate-limited (``min_interval_s``) and the bundle directory is bounded
(``max_bundles`` count + ``max_total_mb`` bytes, oldest pruned first)
so a crash loop cannot fill the disk. A failed bundle write logs
loudly and counts ``rtpu_recorder_bundle_errors_total`` — the trigger
path never swallows errors silently (pinned by
``tests/test_no_silent_excepts.py``).
"""

from __future__ import annotations

import collections
import datetime as dt
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Deque, Dict, List, Optional

from routest_tpu_torch.core.config import RecorderConfig, load_recorder_config
from routest_tpu_torch.obs.registry import get_registry
from routest_tpu_torch.utils.logging import get_logger, set_log_tee

_log = get_logger("routest_tpu_torch.obs.recorder")

# Env keys whose VALUES never enter a bundle (the manifest fingerprint
# must be shareable in an incident channel).
_SECRET_MARKERS = ("KEY", "SECRET", "TOKEN", "PASSWORD", "CREDENTIAL")


def _config_fingerprint() -> dict:
    """The serving-relevant environment, secrets redacted, plus a
    stable digest — "were these two incidents the same config?". A
    URL's ``user:password@`` (``REDIS_URL=rediss://default:…@``) is
    written ``user:<redacted>@``, and the digest is over that form."""
    from routest_tpu_torch.serve.resp import redact_url

    # The port's runtime knobs: CUDA_*, PYTORCH_* and TORCH_* where the
    # JAX package snapshots JAX_* and XLA_*.
    prefixes = ("RTPU_", "ROUTEST_", "CUDA_", "PYTORCH_", "TORCH_")
    names = ("PORT", "SUPABASE_URL", "REDIS_URL", "ETA_MODEL_PATH")
    env = {}
    for key, value in sorted(os.environ.items()):
        if not (key.startswith(prefixes) or key in names):
            continue
        if any(marker in key.upper() for marker in _SECRET_MARKERS):
            value = "<redacted>"
        elif key.endswith("_URL"):
            value = redact_url(value)
        env[key] = value
    digest = hashlib.sha1(
        json.dumps(env, sort_keys=True).encode()).hexdigest()[:16]
    return {"env": env, "digest": digest}


class FlightRecorder:
    """Instantiable recorder (tests build their own); serving uses the
    process-wide :func:`get_recorder`."""

    def __init__(self, config: Optional[RecorderConfig] = None) -> None:
        self.config = config or load_recorder_config()
        cap = max(1, self.config.capacity)
        self._requests: Deque[dict] = collections.deque(maxlen=cap)
        self._logs: Deque[dict] = collections.deque(
            maxlen=max(1, self.config.log_capacity))
        # Operational events (fleet scale decisions, replica joins /
        # drains): far rarer than requests, but a postmortem without
        # the fleet-size history around the incident is half a story.
        self._events: Deque[dict] = collections.deque(maxlen=256)
        self._lock = threading.Lock()
        self._last_bundle_mono = -float("inf")
        # Burst detectors: timestamps of recent server errors / 504s.
        self._fivexx: Deque[float] = collections.deque(
            maxlen=max(1, self.config.burst_5xx))
        self._expiries: Deque[float] = collections.deque(
            maxlen=max(1, self.config.deadline_spike))
        # SLO engines whose state belongs in the manifest (wired by the
        # serving layer; the recorder never constructs one).
        self.slo_engines: List = []
        # Timeline stores whose recent history belongs in every bundle
        # (``timeline.json``) — the "when did it start" evidence a
        # registry snapshot cannot carry. Same wiring contract as the
        # SLO engines: one slot per component, serving layer registers.
        self.timelines: List = []
        # Change ledger whose in-window events every bundle ranks into
        # ``suspects.json`` — one slot, serving layer
        # registers; None = bundles without suspect attribution.
        self.change_ledger = None
        # Rolling page roll-up behind ``/api/incidents``: one entry
        # per bundle written, with its top suspects.
        self._incidents: Deque[dict] = collections.deque(maxlen=64)
        self.bundles_written = 0
        self.triggers_suppressed = 0
        reg = get_registry()
        self._m_records = reg.counter(
            "rtpu_recorder_records_total",
            "Completed-request records accepted by the flight recorder.")
        self._m_bundles = reg.counter(
            "rtpu_recorder_bundles_total",
            "Postmortem bundles written, by trigger reason.", ("reason",))
        self._m_suppressed = reg.counter(
            "rtpu_recorder_suppressed_total",
            "Triggers suppressed by rate limiting, by reason.", ("reason",))
        self._m_errors = reg.counter(
            "rtpu_recorder_bundle_errors_total",
            "Postmortem bundle writes that failed.")

    # ── always-on capture ─────────────────────────────────────────────

    def record_request(self, *, tier: str, method: str, path: str,
                       status: int, duration_ms: float,
                       request_id: Optional[str] = None,
                       trace_id: Optional[str] = None,
                       deadline_ms: Optional[float] = None,
                       extra: Optional[Dict] = None) -> None:
        """One completed request. Cheap by design — a dict append plus
        two burst checks — because it runs on EVERY response."""
        if not self.config.enabled:
            return
        rec = {"ts": round(time.time(), 3), "tier": tier, "method": method,
               "path": path, "status": int(status),
               "duration_ms": round(duration_ms, 3)}
        if request_id:
            rec["request_id"] = request_id
        if trace_id:
            rec["trace_id"] = trace_id
        if deadline_ms is not None:
            rec["deadline_ms"] = round(deadline_ms, 1)
        chaos_points = _active_chaos_points()
        if chaos_points:
            rec["chaos"] = chaos_points
        if extra:
            rec.update(extra)
        self._requests.append(rec)
        self._m_records.inc()
        now = time.monotonic()
        cfg = self.config
        if status >= 500:
            with self._lock:
                self._fivexx.append(now)
                burst = (len(self._fivexx) == cfg.burst_5xx
                         and now - self._fivexx[0] <= cfg.burst_window_s)
            if burst:
                self.trigger("5xx_burst", {
                    "count": cfg.burst_5xx,
                    "window_s": cfg.burst_window_s, "tier": tier,
                    "last_status": status, "last_path": path,
                    "last_trace_id": trace_id})
        if status == 504:
            with self._lock:
                self._expiries.append(now)
                spike = (len(self._expiries) == cfg.deadline_spike
                         and now - self._expiries[0] <= cfg.burst_window_s)
            if spike:
                self.trigger("deadline_expiry_spike", {
                    "count": cfg.deadline_spike,
                    "window_s": cfg.burst_window_s, "tier": tier,
                    "last_path": path, "last_trace_id": trace_id})

    def add_log(self, record: dict) -> None:
        """The ``JsonLogger`` tee target: bounded append, never raises."""
        self._logs.append(record)

    def record_event(self, kind: str, detail: Optional[Dict] = None) -> None:
        """One operational event (autoscale decision, replica join,
        drain) into the bounded events ring — bundles carry these as
        ``events.jsonl`` so a postmortem shows the fleet-size history
        alongside the requests it shaped."""
        if not self.config.enabled:
            return
        rec = {"ts": round(time.time(), 3), "kind": kind}
        if detail:
            rec.update(detail)
        self._events.append(rec)

    def on_slo_page(self, slo: str, detail: dict) -> None:
        """SLO engine ``on_page`` adapter: one bundle NOW (the rings as
        the alert fired) plus a follow-up a few seconds later — a page
        edge often precedes the completion of the very requests that
        caused it, and the follow-up captures what the incident's
        opening seconds actually served."""
        self.trigger("slo_page", {"slo": slo, **detail})
        followup = self.config.followup_s
        if followup > 0:
            timer = threading.Timer(
                followup,
                lambda: self.trigger(
                    "slo_page_followup",
                    {"slo": slo, "after_s": followup}, force=True))
            timer.daemon = True
            timer.start()

    def register_slo_engine(self, engine) -> None:
        """Carry ``engine``'s state in every bundle manifest. One slot
        per component (tests build many short-lived replica apps in one
        process; the manifest should reflect the LIVE one)."""
        with self._lock:
            self.slo_engines = [
                e for e in self.slo_engines
                if getattr(e, "component", None) != engine.component]
            self.slo_engines.append(engine)

    def register_timeline(self, store) -> None:
        """Embed ``store``'s recent history (finest resolution, the
        store's ``bundle_window_s``) as ``timeline.json`` in every
        bundle — a postmortem can then show WHEN the latency/error
        curves moved, not just where they ended up. One slot per
        component, same replacement rule as the SLO engines."""
        with self._lock:
            self.timelines = [
                t for t in self.timelines
                if getattr(t, "component", None) != store.component]
            self.timelines.append(store)

    def register_change_ledger(self, ledger) -> None:
        """Rank ``ledger``'s in-window events against every trigger's
        paging scope and ship the result as ``suspects.json`` in the
        bundle (plus the ``/api/incidents`` roll-up). One slot — the
        last registered ledger wins, same rule as the timelines."""
        with self._lock:
            self.change_ledger = ledger
            kept = int(getattr(ledger.config, "incidents_kept", 0) or 0)
            if kept > 0 and kept != self._incidents.maxlen:
                self._incidents = collections.deque(
                    self._incidents, maxlen=kept)

    def _rank_suspects(self, reason: str, detail: dict,
                       now: float) -> Optional[List[dict]]:
        """Suspect ranking for one trigger, fail-soft: None when no
        ledger is registered, it is disabled, or it holds no event
        inside the incident window — the bundle then simply carries no
        ``suspects.json``, never an error."""
        ledger = self.change_ledger
        if ledger is None or not getattr(ledger, "enabled", False):
            return None
        from routest_tpu_torch.obs.ledger import rank_suspects, scope_from_detail

        try:
            suspects = rank_suspects(
                ledger.events(), now,
                scope=scope_from_detail({"reason": reason, **detail}),
                window_s=float(ledger.config.window_s),
                limit=int(ledger.config.max_suspects))
        except Exception as e:
            # Attribution is advisory; a broken ranking must not cost
            # the bundle itself.
            _log.error("suspect_ranking_failed", reason=reason,
                       error=f"{type(e).__name__}: {e}")
            return None
        return suspects or None

    def incidents_snapshot(self) -> List[dict]:
        """Recent pages with their top suspects, oldest first — the
        ``/api/incidents`` payload body."""
        with self._lock:
            return [dict(r) for r in self._incidents]

    # ── triggers + bundles ────────────────────────────────────────────

    def trigger(self, reason: str, detail: Optional[dict] = None,
                force: bool = False,
                extra_files: Optional[Dict[str, str]] = None
                ) -> Optional[str]:
        """Write a postmortem bundle; returns its path, or None when
        disabled or rate-limited. ``force`` (manual triggers: SIGUSR2,
        ``/api/debug/snapshot``) bypasses the rate limit — the disk
        bounds still hold. ``extra_files`` (name → text content) land
        in the bundle directory alongside the standard rings — the
        triggered profiler ships its stack captures this way, so
        profiles inherit the same disk bounds and pruning."""
        if not self.config.enabled:
            return None
        with self._lock:
            now = time.monotonic()
            if not force and \
                    now - self._last_bundle_mono < self.config.min_interval_s:
                self.triggers_suppressed += 1
                self._m_suppressed.labels(reason=reason).inc()
                _log.info("postmortem_suppressed", reason=reason,
                          min_interval_s=self.config.min_interval_s)
                return None
            self._last_bundle_mono = now
        try:
            path = self._write_bundle(reason, detail or {}, extra_files)
        except Exception as e:
            # LOUD failure: a recorder that cannot write its bundle is
            # an incident inside the incident — never swallow it.
            self._m_errors.inc()
            _log.error("postmortem_write_failed", reason=reason,
                       error=f"{type(e).__name__}: {e}")
            return None
        self.bundles_written += 1
        self._m_bundles.labels(reason=reason).inc()
        _log.warning("postmortem_written", reason=reason, path=path,
                     requests=len(self._requests), logs=len(self._logs))
        return path

    def _bundle_root(self) -> str:
        return os.path.abspath(self.config.dir)

    def _prune_locked(self, root: str) -> None:
        """Enforce the disk bounds: at most ``max_bundles - 1`` bundles
        (room for the one about to be written) and ``max_total_mb``
        total bytes, oldest pruned first (names sort by UTC stamp)."""
        try:
            bundles = sorted(d for d in os.listdir(root)
                             if d.startswith("pm_"))
        except FileNotFoundError:
            return

        def size(path: str) -> int:
            total = 0
            for dirpath, _dirs, files in os.walk(path):
                for f in files:
                    try:
                        total += os.path.getsize(os.path.join(dirpath, f))
                    except OSError:
                        pass  # racing prune from a sibling process
            return total

        budget = int(self.config.max_total_mb * (1 << 20))
        while bundles and (
                len(bundles) >= max(1, self.config.max_bundles)
                or sum(size(os.path.join(root, b)) for b in bundles)
                > budget):
            victim = bundles.pop(0)
            shutil.rmtree(os.path.join(root, victim), ignore_errors=True)
            _log.info("postmortem_pruned", bundle=victim)

    def _write_bundle(self, reason: str, detail: dict,
                      extra_files: Optional[Dict[str, str]] = None) -> str:
        from routest_tpu_torch.obs.trace import get_tracer

        root = self._bundle_root()
        os.makedirs(root, exist_ok=True)
        with self._lock:
            self._prune_locked(root)
            stamp = dt.datetime.now(dt.timezone.utc).strftime(
                "%Y%m%dT%H%M%S.%f")[:-3]
            safe_reason = "".join(c if c.isalnum() or c in "-_" else "-"
                                  for c in reason)[:40]
            path = os.path.join(root,
                                f"pm_{stamp}_{safe_reason}_{os.getpid()}")
            os.makedirs(path, exist_ok=True)
            requests = list(self._requests)
            logs = list(self._logs)
            events = list(self._events)
            timelines = list(self.timelines)
        spans = get_tracer().buffer.snapshot()
        # Suspect ranking: the change ledger's in-window events scored
        # against this trigger's blast radius — the bundle opens with a
        # cause hypothesis, not just rings.
        suspects = self._rank_suspects(reason, detail, time.time())
        # Timeline slices: each registered store's recent finest-
        # resolution history — the bundle's "when did it start" axis.
        timeline_doc = None
        if timelines:
            timeline_doc = {}
            for store in timelines:
                window = getattr(store.config, "bundle_window_s", 900.0)
                timeline_doc[store.component] = store.query(
                    window_s=window, partial=True)
        manifest = {
            "reason": reason,
            "detail": detail,
            "written_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "config": _config_fingerprint(),
            "counts": {"requests": len(requests), "spans": len(spans),
                       "logs": len(logs), "events": len(events),
                       "suspects": len(suspects or ()),
                       "timeline_frames": sum(
                           len(t["frames"])
                           for t in (timeline_doc or {}).values())},
            "registry": get_registry().snapshot(),
            "slo": [engine.snapshot() for engine in self.slo_engines],
            "chaos": _chaos_snapshot(),
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        if timeline_doc is not None:
            with open(os.path.join(path, "timeline.json"), "w") as f:
                json.dump(timeline_doc, f, default=str)
        for name, rows in (("requests.jsonl", requests),
                           ("spans.jsonl", spans),
                           ("logs.jsonl", logs),
                           ("events.jsonl", events)):
            with open(os.path.join(path, name), "w") as f:
                for row in rows:
                    f.write(json.dumps(row, default=str) + "\n")
        if suspects:
            with open(os.path.join(path, "suspects.json"), "w") as f:
                json.dump({"reason": reason, "detail": detail,
                           "window_s": float(
                               self.change_ledger.config.window_s),
                           "suspects": suspects}, f, indent=2,
                          default=str)
        for name, content in (extra_files or {}).items():
            safe = os.path.basename(name)
            with open(os.path.join(path, safe), "w") as f:
                f.write(content)
        incident = {"ts": manifest["written_unix"], "reason": reason,
                    "detail": detail, "bundle": os.path.basename(path),
                    "suspects": suspects or []}
        # Under the lock: register_change_ledger() may concurrently
        # replace self._incidents with a resized deque, and an append
        # to the discarded one would vanish from /api/incidents.
        with self._lock:
            self._incidents.append(incident)
        return path

    # ── introspection ─────────────────────────────────────────────────

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.config.enabled,
                "requests_buffered": len(self._requests),
                "logs_buffered": len(self._logs),
                "events_buffered": len(self._events),
                "bundles_written": self.bundles_written,
                "triggers_suppressed": self.triggers_suppressed,
                "dir": self._bundle_root(),
            }

    def requests_snapshot(self) -> List[dict]:
        return list(self._requests)

    def events_snapshot(self) -> List[dict]:
        return list(self._events)


def _active_chaos_points() -> List[str]:
    """Names of configured chaos fault points when injection is live
    ([] in production — one attribute check, no engine build)."""
    from routest_tpu_torch.chaos import current_engine

    engine = current_engine()
    return sorted(engine.snapshot()) if engine is not None else []


def _chaos_snapshot() -> Optional[dict]:
    from routest_tpu_torch.chaos import current_engine

    engine = current_engine()
    if engine is None:
        return None
    return {"spec": engine.spec, "seed": engine.seed,
            "points": engine.snapshot()}


# ── process-wide recorder ────────────────────────────────────────────

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process recorder, built from ``RTPU_RECORDER_*`` on first
    use; installs itself as the ``JsonLogger`` tee so log correlation
    needs no per-call-site changes."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                rec = FlightRecorder()
                set_log_tee(rec.add_log)
                _recorder = rec
    return _recorder


def configure_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Install a recorder explicitly (tests, benches); ``None`` resets
    to lazy env-driven construction."""
    global _recorder
    with _recorder_lock:
        _recorder = recorder
        set_log_tee(recorder.add_log if recorder is not None else None)


def install_sigusr2_trigger() -> bool:
    """SIGUSR2 → manual postmortem bundle. Main-thread only (POSIX
    signal registration); returns False where that's not possible. The
    write runs on a helper thread so a multi-MB dump never blocks the
    signal handler."""
    import signal

    def _on_usr2(_signum, _frame):
        threading.Thread(
            target=lambda: get_recorder().trigger("sigusr2", force=True),
            daemon=True, name="postmortem-sigusr2").start()

    try:
        signal.signal(signal.SIGUSR2, _on_usr2)
    except (ValueError, AttributeError):
        return False  # non-main thread, or a platform without SIGUSR2
    return True
