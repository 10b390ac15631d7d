"""Fleet-wide metric history: the registry ticked into bounded rings.

``/api/metrics`` answers *what is the state now*; an incident needs
*what changed over the last ten minutes*. This module closes that gap
without an external TSDB (the Monarch observation: serving systems need
an in-memory, serving-path-local time-series layer; durability comes
from scrapes, not from the store):

- :class:`TimelineStore` — a daemon ticker samples one or more
  :class:`~routest_tpu_torch.obs.registry.MetricsRegistry` instances into
  **multi-resolution rings** (default 10 s × 360 ≈ 1 h and 60 s × 360
  ≈ 6 h). Counters land as per-window deltas (+ rates), gauges as last
  value, histograms as per-window **bucket deltas** with interpolated
  p50/p95/p99 — so a latency shift is visible per window, not smeared
  into the process-lifetime cumulative distribution. Frames are sparse
  (a series with no activity in a window costs nothing) and the rings
  are strictly bounded.
- :class:`FleetTimelineScraper` — the gateway's view: periodically
  pulls each upstream replica's ``/api/timeline`` (frames align across
  processes because every store cuts windows at wall-clock multiples
  of the step) and serves **per-replica**, **per-version** (the
  rollout/placement labels), and **fleet-rollup** merges — counters
  sum, histogram buckets add, percentiles recompute over the merged
  distribution.
- :class:`AnomalyWatcher` — compares each fresh finest-resolution
  window against the trailing baseline (latency shift, error-rate
  step, throughput collapse, cache-hit-rate collapse) and fires a
  flight-recorder bundle; bundles embed the timeline slice (the
  recorder's ``register_timeline``), so a postmortem finally answers
  *when did it start*.

Everything is queryable via ``GET /api/timeline?family=&window=&step=``
on replica AND gateway (``docs/OBSERVABILITY.md`` "Metric timeline").
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from routest_tpu_torch.core.config import TimelineConfig, load_timeline_config
from routest_tpu_torch.obs.registry import MetricsRegistry, get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.timeline")


def bucket_quantile(bounds: Sequence[float], counts: Sequence[float],
                    q: float) -> Optional[float]:
    """``histogram_quantile`` over a window's bucket DELTAS — the same
    covering-bucket linear interpolation :class:`registry.Histogram`
    applies to its cumulative counts, reusable here and by the fleet
    rollup (merged distributions have no Histogram object). ``counts``
    has ``len(bounds) + 1`` entries (the +Inf bucket last). None when
    the window is empty."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    running = 0.0
    for i, c in enumerate(counts):
        if running + c >= rank and c > 0:
            lower = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):        # +Inf bucket: clamp, don't invent
                return float(bounds[-1]) if bounds else None
            upper = bounds[i]
            return lower + (upper - lower) * ((rank - running) / c)
        running += c
    return float(bounds[-1]) if bounds else None


def _merged_sample(registries: Sequence[MetricsRegistry]) -> dict:
    """One cumulative sample across every registry (family names are
    disjoint by convention — ``request_duration_seconds`` lives in the
    per-App stats registry, ``rtpu_*`` in the process registry; on a
    clash the later registry wins, documented not defended)."""
    out: dict = {}
    for reg in registries:
        out.update(reg.cumulative_sample())
    return out


def _delta_frame(prev: dict, cur: dict, t: float, dur: float) -> dict:
    """One window's frame: sparse per-family series of deltas/values.
    Counters/histograms with no activity in the window are omitted;
    a restarted series (cumulative value DROPPED — only possible when
    a private registry was swapped) re-baselines silently rather than
    reporting a negative delta."""
    fams: dict = {}
    for name, fam in cur.items():
        prev_fam = prev.get(name)
        prev_series = prev_fam["series"] if prev_fam else {}
        kind = fam["kind"]
        rows: List[dict] = []
        for key, val in fam["series"].items():
            labels = dict(zip(fam["labelnames"], key))
            if kind == "counter":
                d = val - prev_series.get(key, 0.0)
                if d <= 0:
                    continue
                rows.append({"labels": labels, "delta": round(d, 6),
                             "rate": round(d / dur, 6)})
            elif kind == "gauge":
                rows.append({"labels": labels, "value": round(val, 6)})
            else:  # histogram
                counts, hsum, hcount = val
                pc, psum, pcount = prev_series.get(
                    key, ((0,) * len(counts), 0.0, 0))
                d_count = hcount - pcount
                if d_count <= 0 or len(pc) != len(counts):
                    continue
                d_buckets = [a - b for a, b in zip(counts, pc)]
                row = {"labels": labels, "count": d_count,
                       "sum": round(hsum - psum, 6),
                       "buckets": d_buckets}
                for q, lab in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    v = bucket_quantile(fam["buckets"] or (), d_buckets, q)
                    if v is not None:
                        row[lab] = round(v, 6)
                rows.append(row)
        if rows:
            entry: dict = {"kind": kind, "series": rows}
            if kind == "histogram" and fam["buckets"]:
                entry["le"] = list(fam["buckets"])
            fams[name] = entry
    return {"t": t, "dur": round(dur, 3), "families": fams}


class _Resolution:
    __slots__ = ("step_s", "slots", "frames", "last_boundary", "last_cum")

    def __init__(self, step_s: float, slots: int) -> None:
        self.step_s = float(step_s)
        self.slots = int(slots)
        self.frames: collections.deque = collections.deque(
            maxlen=max(1, int(slots)))
        self.last_boundary: Optional[float] = None
        self.last_cum: Optional[dict] = None


class TimelineStore:
    """Bounded in-process time-series store over registry samples.

    ``tick()`` (normally from the ticker thread, explicitly in tests)
    takes one cumulative sample and emits a frame into every resolution
    whose wall-clock boundary has passed — each resolution keeps its
    own last-cumulative snapshot, so a coarse frame's deltas are exact
    (the sum of its fine windows), not a lossy re-fold."""

    def __init__(self, registries: Optional[Sequence[MetricsRegistry]]
                 = None, config: Optional[TimelineConfig] = None,
                 component: str = "replica") -> None:
        self.config = config or load_timeline_config()
        self.component = component
        self.registries: List[MetricsRegistry] = list(
            registries if registries is not None else [get_registry()])
        self._resolutions = [_Resolution(s, n)
                             for s, n in self.config.resolutions]
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self.ticks = 0
        # Called (outside the lock) after a tick that emitted at least
        # one finest-resolution frame — the anomaly watcher subscribes.
        self.on_frame: List[Callable[[], None]] = []
        reg = get_registry()
        self._m_ticks = reg.counter(
            "rtpu_timeline_ticks_total",
            "Timeline store sampling ticks.", ("component",))
        self._m_frames = reg.counter(
            "rtpu_timeline_frames_total",
            "Timeline frames emitted, by resolution step.",
            ("component", "step"))

    @property
    def step_s(self) -> float:
        """The finest resolution's step (the tick period)."""
        return self._resolutions[0].step_s

    # ── sampling ──────────────────────────────────────────────────────

    def tick(self, now: Optional[float] = None) -> bool:
        """Sample and emit due frames → True when a finest-resolution
        frame was emitted (the watcher's cue)."""
        now = time.time() if now is None else float(now)
        cum = _merged_sample(self.registries)
        emitted_finest = False
        with self._lock:
            self.ticks += 1
            for i, res in enumerate(self._resolutions):
                boundary = math.floor(now / res.step_s) * res.step_s
                if res.last_boundary is None:
                    res.last_boundary, res.last_cum = boundary, cum
                    continue
                if boundary <= res.last_boundary:
                    continue
                frame = _delta_frame(res.last_cum, cum, t=boundary,
                                     dur=boundary - res.last_boundary)
                res.frames.append(frame)
                res.last_boundary, res.last_cum = boundary, cum
                self._m_frames.labels(component=self.component,
                                      step=str(res.step_s)).inc()
                if i == 0:
                    emitted_finest = True
        self._m_ticks.labels(component=self.component).inc()
        if emitted_finest:
            for cb in list(self.on_frame):
                try:
                    cb()
                except Exception as e:
                    _log.error("timeline_frame_callback_failed",
                               error=f"{type(e).__name__}: {e}")
        return emitted_finest

    # ── query ─────────────────────────────────────────────────────────

    def _pick_resolution(self, step_s: Optional[float]) -> _Resolution:
        if step_s is None or step_s <= 0:
            return self._resolutions[0]
        chosen = self._resolutions[0]
        for res in self._resolutions:
            if res.step_s <= step_s:
                chosen = res
        return chosen

    def frames(self, step_s: Optional[float] = None) -> List[dict]:
        """Raw frames of the covering resolution, oldest first."""
        with self._lock:
            return list(self._pick_resolution(step_s).frames)

    def query(self, family: Optional[str] = None,
              window_s: Optional[float] = None,
              step_s: Optional[float] = None,
              partial: bool = False) -> dict:
        """The ``/api/timeline`` payload: frames of the resolution whose
        step best matches ``step_s`` (largest step ≤ requested; finest
        by default), trimmed to the trailing ``window_s``, families
        filtered by substring. ``partial=True`` appends the IN-PROGRESS
        window (delta since the last boundary, stamped ``partial``) —
        the recorder uses it so a bundle written moments after boot (or
        mid-window) still shows the activity that triggered it."""
        with self._lock:
            res = self._pick_resolution(step_s)
            frames = list(res.frames)
            if partial and res.last_cum is not None:
                now = time.time()
                if now - res.last_boundary > 0.001:
                    frame = _delta_frame(res.last_cum,
                                         _merged_sample(self.registries),
                                         t=now, dur=now - res.last_boundary)
                    frame["partial"] = True
                    frames.append(frame)
        if window_s is not None and window_s > 0 and frames:
            # Trailing window relative to the NEWEST frame, not the
            # wall clock — a stalled ticker's last data stays readable.
            cut = frames[-1]["t"] - window_s
            frames = [f for f in frames if f["t"] > cut]
        if family:
            frames = [{**f, "families": {n: v
                                         for n, v in f["families"].items()
                                         if family in n}}
                      for f in frames]
        return {"component": self.component, "step_s": res.step_s,
                "slots": res.slots, "frames": frames}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "component": self.component,
                "enabled": self.config.enabled,
                "ticks": self.ticks,
                "resolutions": [{"step_s": r.step_s, "slots": r.slots,
                                 "frames": len(r.frames)}
                                for r in self._resolutions],
            }

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self) -> threading.Event:
        """Tick on a daemon thread aligned to the finest step's
        wall-clock boundaries; returns the stop event. Idempotent."""
        if self._stop is not None:
            return self._stop
        self._stop = stop = threading.Event()
        step = self.step_s

        def run() -> None:
            # Baseline sample immediately, then one tick per boundary.
            try:
                self.tick()
            except Exception as e:
                _log.error("timeline_tick_failed",
                           error=f"{type(e).__name__}: {e}")
            while True:
                wait = step - (time.time() % step) + 0.02
                if stop.wait(wait):
                    return
                try:
                    self.tick()
                except Exception as e:
                    # One broken sample must not kill the ticker.
                    _log.error("timeline_tick_failed",
                               error=f"{type(e).__name__}: {e}")

        threading.Thread(target=run, daemon=True,
                         name=f"timeline-{self.component}").start()
        return stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None


# ── fleet rollup ─────────────────────────────────────────────────────


def merge_frames(frames: Sequence[dict]) -> Optional[dict]:
    """Merge same-slot frames from several replicas into one fleet
    frame: counter deltas/rates sum, gauges sum (`sources` counts the
    contributors), histogram buckets add element-wise and the
    percentiles recompute over the MERGED distribution (the only
    correct fleet percentile — averaging per-replica p95s is not)."""
    frames = [f for f in frames if f]
    if not frames:
        return None
    agg: Dict[str, dict] = {}
    for fr in frames:
        for name, fam in fr["families"].items():
            slot = agg.setdefault(name, {"kind": fam["kind"],
                                         "le": fam.get("le"),
                                         "series": {}})
            if slot.get("le") is None and fam.get("le") is not None:
                slot["le"] = fam["le"]
            for row in fam["series"]:
                key = tuple(sorted(row["labels"].items()))
                cur = slot["series"].get(key)
                if cur is None:
                    cur = slot["series"][key] = {
                        "labels": dict(row["labels"]), "sources": 0}
                cur["sources"] += 1
                if fam["kind"] == "counter":
                    cur["delta"] = cur.get("delta", 0.0) + row["delta"]
                    cur["rate"] = cur.get("rate", 0.0) + row["rate"]
                elif fam["kind"] == "gauge":
                    cur["value"] = cur.get("value", 0.0) + row["value"]
                else:
                    cur["count"] = cur.get("count", 0) + row["count"]
                    cur["sum"] = cur.get("sum", 0.0) + row["sum"]
                    buckets = cur.get("buckets")
                    if buckets is None:
                        cur["buckets"] = list(row["buckets"])
                    elif len(buckets) == len(row["buckets"]):
                        cur["buckets"] = [a + b for a, b in
                                          zip(buckets, row["buckets"])]
    fams: dict = {}
    for name, slot in agg.items():
        rows = []
        for _key, cur in sorted(slot["series"].items()):
            if slot["kind"] == "histogram" and slot.get("le"):
                for q, lab in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    v = bucket_quantile(slot["le"], cur.get("buckets", ()),
                                        q)
                    if v is not None:
                        cur[lab] = round(v, 6)
            rows.append(cur)
        entry: dict = {"kind": slot["kind"], "series": rows}
        if slot["kind"] == "histogram" and slot.get("le"):
            entry["le"] = slot["le"]
        fams[name] = entry
    return {"t": frames[0]["t"],
            "dur": max(f["dur"] for f in frames),
            "replicas": len(frames),
            "families": fams}


class FleetTimelineScraper:
    """Gateway-side fleet timeline: scrape each upstream's finest
    frames, accumulate bounded per-replica rings keyed by slot time,
    and answer per-replica / per-version / fleet-rollup queries.

    ``fetch_fn(path) → {rid: payload-or-{"error"}}`` is the gateway's
    existing replica-JSON fetcher; ``versions_fn() → {rid: version}``
    labels the per-version grouping (the gateway's append-only
    rid→version map). Frames align across replicas because every
    TimelineStore cuts windows at wall-clock multiples of the step."""

    def __init__(self, fetch_fn: Callable[[str], dict],
                 config: Optional[TimelineConfig] = None,
                 versions_fn: Optional[Callable[[], Dict[str, str]]]
                 = None) -> None:
        self.config = config or load_timeline_config()
        self._fetch = fetch_fn
        self._versions = versions_fn or (lambda: {})
        self.step_s = float(self.config.resolutions[0][0])
        self.slots = int(self.config.resolutions[0][1])
        self._lock = threading.Lock()
        # rid → OrderedDict[t → frame] (bounded to the finest ring).
        self._replicas: Dict[str, "collections.OrderedDict[float, dict]"] \
            = {}
        self._errors: Dict[str, str] = {}
        self._stop: Optional[threading.Event] = None
        self.scrapes = 0
        reg = get_registry()
        self._m_scrapes = reg.counter(
            "rtpu_timeline_scrapes_total",
            "Gateway fleet-timeline scrape attempts, by result.",
            ("result",))

    def scrape(self) -> None:
        """One pull of every replica's newest finest frames (a few
        windows of overlap — slots already seen dedupe by ``t``, so a
        missed scrape heals on the next one)."""
        window = self.step_s * 5
        path = (f"/api/timeline?step={self.step_s:g}"
                f"&window={window:g}")
        fetched = self._fetch(path)
        self.scrapes += 1
        with self._lock:
            for rid, payload in fetched.items():
                if not isinstance(payload, dict) or "frames" not in payload:
                    self._errors[rid] = str(
                        (payload or {}).get("error", "malformed"))
                    self._m_scrapes.labels(result="error").inc()
                    continue
                self._errors.pop(rid, None)
                ring = self._replicas.setdefault(
                    rid, collections.OrderedDict())
                for frame in payload["frames"]:
                    t = frame.get("t")
                    if t is None or t in ring:
                        continue
                    ring[t] = frame
                    while len(ring) > self.slots:
                        ring.popitem(last=False)
                self._m_scrapes.labels(result="ok").inc()

    # ── views ─────────────────────────────────────────────────────────

    @staticmethod
    def _trim(frames: List[dict], family: Optional[str],
              window_s: Optional[float]) -> List[dict]:
        if window_s is not None and window_s > 0 and frames:
            cut = frames[-1]["t"] - window_s
            frames = [f for f in frames if f["t"] > cut]
        if family:
            frames = [{**f, "families": {n: v
                                         for n, v in f["families"].items()
                                         if family in n}}
                      for f in frames]
        return frames

    def query(self, scope: str = "fleet", family: Optional[str] = None,
              window_s: Optional[float] = None) -> dict:
        """``scope`` ∈ fleet (merged rollup), replicas (per-rid),
        versions (merged per version label)."""
        with self._lock:
            per_rid = {rid: [ring[t] for t in sorted(ring)]
                       for rid, ring in self._replicas.items()}
            errors = dict(self._errors)
        out: dict = {"component": "gateway", "scope": scope,
                     "step_s": self.step_s, "replicas_seen":
                     sorted(per_rid), "errors": errors}
        if scope == "replicas":
            out["replicas"] = {
                rid: {"frames": self._trim(frames, family, window_s)}
                for rid, frames in per_rid.items()}
            return out
        if scope == "versions":
            versions = self._versions()
            groups: Dict[str, List[List[dict]]] = {}
            for rid, frames in per_rid.items():
                label = versions.get(rid) or "unversioned"
                groups.setdefault(label, []).append(frames)
            out["versions"] = {
                label: {"frames": self._trim(
                    self._merge_aligned(rings), family, window_s)}
                for label, rings in groups.items()}
            return out
        out["frames"] = self._trim(
            self._merge_aligned(list(per_rid.values())), family, window_s)
        return out

    @staticmethod
    def _merge_aligned(rings: List[List[dict]]) -> List[dict]:
        by_t: Dict[float, List[dict]] = {}
        for frames in rings:
            for frame in frames:
                by_t.setdefault(frame["t"], []).append(frame)
        return [m for t in sorted(by_t)
                for m in [merge_frames(by_t[t])] if m is not None]

    def snapshot(self) -> dict:
        with self._lock:
            return {"step_s": self.step_s, "slots": self.slots,
                    "scrapes": self.scrapes,
                    "replicas": {rid: len(ring)
                                 for rid, ring in self._replicas.items()},
                    "errors": dict(self._errors)}

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self) -> threading.Event:
        if self._stop is not None:
            return self._stop
        self._stop = stop = threading.Event()
        step = self.step_s

        def run() -> None:
            while not stop.wait(step / 2.0):
                try:
                    self.scrape()
                except Exception as e:
                    _log.error("timeline_scrape_failed",
                               error=f"{type(e).__name__}: {e}")

        threading.Thread(target=run, daemon=True,
                         name="timeline-fleet-scraper").start()
        return stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None


# ── anomaly watcher ──────────────────────────────────────────────────

# Request-latency histogram families the watcher judges, with the
# error-counter family that pairs with each (error rate = counter delta
# / histogram count delta over the same window).
_WATCHED_REQUESTS: Tuple[Tuple[str, str], ...] = (
    ("request_duration_seconds", "request_errors_total"),
    ("rtpu_gateway_request_seconds", "rtpu_gateway_request_errors_total"),
)
# (hits, misses) counter pairs for the cache-hit-rate collapse check.
_WATCHED_CACHES: Tuple[Tuple[str, str], ...] = (
    ("rtpu_cache_hits_total", "rtpu_cache_misses_total"),
    ("rtpu_route_cache_hits_total", "rtpu_route_cache_misses_total"),
)
_CACHE_STEP = 0.3  # absolute hit-rate drop that counts as a collapse


def _family_totals(frame: dict, family: str):
    """Family rolled up across its series within one frame →
    ``{"count", "sum", "buckets", "le", "delta"}`` (whichever apply)."""
    fam = frame["families"].get(family)
    if fam is None:
        return None
    out = {"count": 0, "sum": 0.0, "delta": 0.0, "buckets": None,
           "le": fam.get("le")}
    for row in fam["series"]:
        out["count"] += row.get("count", 0)
        out["sum"] += row.get("sum", 0.0)
        out["delta"] += row.get("delta", 0.0)
        b = row.get("buckets")
        if b is not None:
            if out["buckets"] is None:
                out["buckets"] = list(b)
            elif len(out["buckets"]) == len(b):
                out["buckets"] = [x + y for x, y in zip(out["buckets"], b)]
    return out


class AnomalyWatcher:
    """Newest finest window vs trailing baseline, four checks:

    - **latency shift** — merged-window p95 ≥ ``watch_latency_factor``
      × baseline p95 AND the shift ≥ ``watch_latency_floor_ms``;
    - **error-rate step** — newest error fraction ≥ baseline +
      ``watch_error_step``;
    - **throughput collapse** — newest event rate ≤
      ``watch_throughput_frac`` × baseline rate while the baseline was
      actually serving (≥ ``watch_min_rate`` events/s);
    - **cache-hit collapse** — hit rate drops ≥ 0.3 absolute.

    Each finding fires ONE flight-recorder bundle (per (kind, family),
    spaced ``watch_cooldown_s`` apart; the recorder's own rate limit
    also applies) whose manifest names the anomaly and whose
    ``timeline.json`` shows the history around it."""

    def __init__(self, store: TimelineStore,
                 config: Optional[TimelineConfig] = None,
                 recorder=None) -> None:
        self.store = store
        self.config = config or store.config
        self._recorder = recorder
        self._last_fired: Dict[Tuple[str, str], float] = {}
        self.history: collections.deque = collections.deque(maxlen=64)
        self._m_anomalies = get_registry().counter(
            "rtpu_timeline_anomalies_total",
            "Timeline anomalies detected, by kind.", ("component", "kind"))

    def attach(self) -> "AnomalyWatcher":
        """Subscribe to the store's frame emissions (the production
        wiring; tests call :meth:`check` directly)."""
        self.store.on_frame.append(self.check)
        return self

    # ── evaluation ────────────────────────────────────────────────────

    def check(self) -> List[dict]:
        cfg = self.config
        frames = self.store.frames()
        if len(frames) < cfg.watch_baseline_frames + 1:
            return []
        newest = frames[-1]
        baseline = frames[-(min(len(frames) - 1, 30) + 1):-1]
        findings: List[dict] = []
        for hist_family, err_family in _WATCHED_REQUESTS:
            findings.extend(self._check_requests(
                newest, baseline, hist_family, err_family))
        for hits_family, miss_family in _WATCHED_CACHES:
            f = self._check_cache(newest, baseline, hits_family,
                                  miss_family)
            if f is not None:
                findings.append(f)
        fired = [f for f in findings if self._fire(f)]
        return fired

    def _check_requests(self, newest, baseline, hist_family,
                        err_family) -> List[dict]:
        cfg = self.config
        new = _family_totals(newest, hist_family)
        base_frames = [_family_totals(f, hist_family) for f in baseline]
        base_frames = [b for b in base_frames if b is not None]
        out: List[dict] = []
        base_count = sum(b["count"] for b in base_frames)
        base_dur = sum(f["dur"] for f in baseline) or 1.0
        base_rate = base_count / base_dur
        new_dur = newest["dur"] or 1.0
        # Throughput collapse judges even an EMPTY newest window —
        # that's the collapse case.
        new_count = new["count"] if new is not None else 0
        if (base_rate >= cfg.watch_min_rate
                and new_count / new_dur <= cfg.watch_throughput_frac
                * base_rate):
            out.append({"kind": "throughput_collapse",
                        "family": hist_family,
                        "baseline_rate": round(base_rate, 3),
                        "rate": round(new_count / new_dur, 3)})
        if new is None or new["count"] < cfg.watch_min_count \
                or base_count < cfg.watch_min_count:
            return out
        le = new["le"] or next((b["le"] for b in base_frames if b["le"]),
                               None)
        if le and new["buckets"]:
            base_buckets = None
            for b in base_frames:
                if b["buckets"] is None:
                    continue
                if base_buckets is None:
                    base_buckets = list(b["buckets"])
                elif len(base_buckets) == len(b["buckets"]):
                    base_buckets = [x + y for x, y in
                                    zip(base_buckets, b["buckets"])]
            p95_new = bucket_quantile(le, new["buckets"], 0.95)
            p95_base = bucket_quantile(le, base_buckets or (), 0.95)
            if (p95_new is not None and p95_base is not None
                    and p95_new >= cfg.watch_latency_factor * p95_base
                    and (p95_new - p95_base) * 1000.0
                    >= cfg.watch_latency_floor_ms):
                out.append({"kind": "latency_shift", "family": hist_family,
                            "p95_s": round(p95_new, 4),
                            "baseline_p95_s": round(p95_base, 4)})
        new_err = _family_totals(newest, err_family)
        base_err = sum((_family_totals(f, err_family) or {"delta": 0.0})
                       ["delta"] for f in baseline)
        err_rate = (new_err["delta"] if new_err else 0.0) / new["count"]
        base_err_rate = base_err / base_count
        if err_rate >= base_err_rate + cfg.watch_error_step:
            out.append({"kind": "error_rate_step", "family": err_family,
                        "error_rate": round(err_rate, 4),
                        "baseline_error_rate": round(base_err_rate, 4)})
        return out

    def _check_cache(self, newest, baseline, hits_family,
                     miss_family) -> Optional[dict]:
        cfg = self.config

        def rate(frame) -> Optional[Tuple[float, float]]:
            h = _family_totals(frame, hits_family)
            m = _family_totals(frame, miss_family)
            total = (h["delta"] if h else 0.0) + (m["delta"] if m else 0.0)
            if total <= 0:
                return None
            return (h["delta"] if h else 0.0) / total, total

        new = rate(newest)
        if new is None or new[1] < cfg.watch_min_count:
            return None
        base_pairs = [r for r in (rate(f) for f in baseline)
                      if r is not None]
        base_total = sum(t for _r, t in base_pairs)
        if base_total < cfg.watch_min_count:
            return None
        base_rate = sum(r * t for r, t in base_pairs) / base_total
        if new[0] <= base_rate - _CACHE_STEP:
            return {"kind": "cache_hit_collapse", "family": hits_family,
                    "hit_rate": round(new[0], 4),
                    "baseline_hit_rate": round(base_rate, 4)}
        return None

    # ── firing ────────────────────────────────────────────────────────

    def _fire(self, finding: dict) -> bool:
        key = (finding["kind"], finding["family"])
        now = time.monotonic()
        last = self._last_fired.get(key)
        if last is not None and now - last < self.config.watch_cooldown_s:
            return False
        self._last_fired[key] = now
        self._m_anomalies.labels(component=self.store.component,
                                 kind=finding["kind"]).inc()
        record = {"ts": round(time.time(), 3),
                  "component": self.store.component, **finding}
        self.history.append(record)
        _log.warning("timeline_anomaly", **record)
        recorder = self._recorder
        if recorder is None:
            from routest_tpu_torch.obs.recorder import get_recorder

            recorder = get_recorder()
        recorder.trigger(f"anomaly_{finding['kind']}", record)
        return True

    def snapshot(self) -> dict:
        return {"enabled": self.config.watch,
                "cooldown_s": self.config.watch_cooldown_s,
                "recent": list(self.history)}
