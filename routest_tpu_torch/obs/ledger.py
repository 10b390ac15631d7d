"""Change ledger + incident correlation.

The timelines, the blackbox prober and the goodput watchdog give
*detection* — timelines, the blackbox prober, the
goodput watchdog — but attribution stayed human: a page bundle shows
WHEN latency shifted while model swaps, metric-epoch flips, rollouts,
autoscale actions, chaos injections, placement changes, and region
failovers are each metered in their own family with no unified record
to correlate against. This module closes that gap:

- :class:`ChangeLedger` — a bounded, process-wide ring every
  state-changing call site reports into via :func:`record_change`.
  Each event carries a registered ``kind`` (:data:`LEDGER_KINDS` — the
  rtpulint ``ledger-kind-*`` rules enforce the registry and
  ``docs/OBSERVABILITY.md`` both directions), a timestamp, and
  blast-radius labels (``replica``, ``version``, ``region``,
  ``bucket``) plus a small detail dict. Events roll into the
  ``rtpu_change_*`` families and are queryable with label filtering
  via ``GET /api/changes`` on every tier. When a bus is attached the
  ledger publishes locally-originated events on the ``rtpu.changes``
  channel and taps the same channel for foreign events, so every
  process in a region — and, through :class:`LedgerBridge`, every
  region — converges on one timeline of what changed.

- :func:`rank_suspects` — the correlation heuristic the flight
  recorder calls when a page fires: every ledger event inside the
  incident window is scored by **temporal proximity × blast-radius
  overlap** with the paging scope. A deploy on the offender-named
  replica implicates itself before a fleet-wide metric flip; an event
  scoped to a DIFFERENT replica/version/region is heavily penalized
  rather than excluded (a mislabeled page should still see it, ranked
  last). The ranking lands as ``suspects.json`` in the bundle and
  rolls up via ``GET /api/incidents``.

Hot-path discipline mirrors the goodput ledger: ``record()`` is one
deque append + two counter bumps under a lock; disabled
(``RTPU_LEDGER=0``) it is a single attribute check. Bus publishing
happens inline (change events are rare — human-scale, not
request-scale) and is fail-soft.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence

from routest_tpu_torch.core.config import LedgerConfig, load_ledger_config
from routest_tpu_torch.obs.registry import MetricsRegistry, get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.ledger")

# Every event kind a call site may record, with the operator-facing
# meaning. rtpulint's ``ledger-kind-unregistered`` rule rejects any
# ``record_change("...")`` call site whose kind is missing here, and
# ``ledger-kind-undocumented`` rejects kinds absent from
# docs/OBSERVABILITY.md — the same closed-registry discipline as
# metric families and chaos points.
LEDGER_KINDS: Dict[str, str] = {
    "model.swap": "Verified ETA-model hot-swap landed (generation "
                  "flipped after the divergence gate).",
    "model.road_swap": "Verified road-GNN hot-swap landed (edge-time "
                       "divergence gate passed).",
    "live.flip": "Live-metric customize cycle flipped a new metric "
                 "epoch into serving.",
    "live.customize_failed": "Live-metric customize cycle failed "
                             "(chaos or error); previous epoch kept "
                             "serving.",
    "rollout.phase": "Rollout state transition (canary / baking / "
                     "promoting / done / rolled_back / failed).",
    "autoscale.grow": "Autoscaler added replicas.",
    "autoscale.shrink": "Autoscaler drained replicas away.",
    "placement.apply": "Device placement plan chosen for the fleet "
                       "(chips carved into replica slices).",
    "chaos.arm": "Chaos engine armed with a fault spec.",
    "chaos.fire": "Chaos fault fired (first fire per rule, plus every "
                  "externally-actuated scenario).",
    "wire.enable": "Binary wire path negotiated on at boot.",
    "region.failover": "Geo-front marked a region down and began "
                       "failing its traffic over.",
    "region.kill": "Region killed (chaos scenario or admin action).",
    "region.rejoin": "Region back up; journal replay + catch-up "
                     "began.",
}

DEFAULT_CHANNEL = "rtpu.changes"

_SCOPE_KEYS = ("replica", "version", "region", "bucket")

# Paging-detail key aliases → canonical scope key (how a page's detail
# dict names its blast radius across the existing SLO/prober/watchdog
# surfaces).
_SCOPE_ALIASES = {
    "replica": "replica", "replica_id": "replica", "rid": "replica",
    "offender": "replica", "worst_replica": "replica",
    "version": "version", "offending_version": "version",
    "region": "region", "dead_region": "region",
    "bucket": "bucket", "program_bucket": "bucket",
}


def event_ts(rec) -> float:
    """Defensive sort key for merged event / incident lists: a foreign
    tier's payload may carry a ``ts`` that is missing or non-numeric,
    and one bad row must not 500 the whole merge — it sorts as 0.0
    (oldest) instead."""
    try:
        return float(rec.get("ts") or 0.0)
    except (AttributeError, TypeError, ValueError):
        return 0.0


def replica_label() -> str:
    """This process's identity on ledger events: host:port under a
    fleet supervisor (which sets ``PORT`` per replica), host:pid
    otherwise — the same convention as the goodput ledger."""
    return f"{socket.gethostname()}:{os.environ.get('PORT') or os.getpid()}"


class ChangeLedger:
    """Bounded ring of state-change events with label-filtered query,
    registry export, and optional bus fan-out. One instance per
    process (:func:`get_change_ledger`); tests construct their own
    against a private registry."""

    def __init__(self, config: Optional[LedgerConfig] = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.config = config if config is not None else load_ledger_config()
        self.enabled = self.config.enabled
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._m_events = reg.counter(
            "rtpu_change_events_total",
            "State-change events recorded in the change ledger, by "
            "kind and origin (local / bus).", ("kind", "origin"))
        self._m_last = reg.gauge(
            "rtpu_change_last_unix",
            "Unix time of the newest ledger event, by kind.", ("kind",))
        self._m_published = reg.counter(
            "rtpu_change_published_total",
            "Locally-originated change events published on the "
            "changes channel.")
        self._m_dropped = reg.counter(
            "rtpu_change_dropped_total",
            "Change events the ledger dropped, by reason "
            "(publish_error / malformed / duplicate).", ("reason",))
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(1, int(self.config.capacity)))
        # Default blast-radius context merged into records that don't
        # name their own (set once at boot by the embedding tier).
        self._context: Dict[str, str] = {}
        if self.config.region:
            self._context["region"] = self.config.region
        self._seq = 0
        self._source = f"{replica_label()}/{os.getpid()}"
        self._bus = None
        self._tap_stop: Optional[threading.Event] = None
        # Bounded recently-seen event ids (duplicate suppression for
        # redelivering buses / multi-path rings).
        self._seen: collections.OrderedDict = collections.OrderedDict()

    # ── recording ─────────────────────────────────────────────────────

    def set_context(self, **labels: Optional[str]) -> None:
        """Install default blast-radius labels (replica / version /
        region) stamped onto every locally-recorded event that doesn't
        carry its own."""
        with self._lock:
            for key, val in labels.items():
                if key not in _SCOPE_KEYS:
                    raise ValueError(f"unknown ledger context key {key!r}")
                if val is None:
                    self._context.pop(key, None)
                else:
                    self._context[key] = str(val)

    def record(self, kind: str, *, replica: Optional[str] = None,
               version: Optional[str] = None,
               region: Optional[str] = None,
               bucket: Optional[str] = None,
               detail: Optional[dict] = None,
               ts: Optional[float] = None) -> Optional[dict]:
        """One state change → ring + metrics + (if attached) bus.
        Unknown kinds are recorded anyway — a newer remote process may
        know kinds this one doesn't; the static gate is rtpulint's."""
        if not self.enabled:
            return None
        rec: Dict[str, object] = {
            "kind": str(kind),
            "ts": round(time.time() if ts is None else float(ts), 3),
        }
        explicit = {"replica": replica, "version": version,
                    "region": region, "bucket": bucket}
        with self._lock:
            for key in _SCOPE_KEYS:
                val = explicit[key]
                if val is None:
                    val = self._context.get(key)
                if val is not None:
                    rec[key] = str(val)
            if detail:
                rec["detail"] = dict(detail)
            self._seq += 1
            rec["id"] = f"{self._source}:{self._seq}"
            self._events.append(rec)
            bus = self._bus
        self._m_events.labels(kind=rec["kind"], origin="local").inc()
        self._m_last.labels(kind=rec["kind"]).set(rec["ts"])
        if bus is not None and self.config.publish:
            # No origin_region stamp here — the ProbeBridge discipline
            # puts it on FIRST bridge crossing (LedgerBridge.handle):
            # a region's own outbound bridge must see local originals
            # untagged, or it drops every one of them as a "loop" and
            # nothing ever replicates. The event's ``region`` label
            # (blast radius) is unrelated to ring routing.
            try:
                bus.publish(self.config.channel, {"change": rec})
                self._m_published.inc()
            except Exception as e:
                # Degraded-mode buses buffer internally; one that
                # raises has no replay for this event — count it.
                self._m_dropped.labels(reason="publish_error").inc()
                _log.warning("change_publish_failed", kind=rec["kind"],
                             error=f"{type(e).__name__}: {e}")
        return rec

    def ingest(self, event) -> bool:
        """One bus event → ring (origin ``bus``); duplicate and
        self-originated events drop. Public so tests can drive the
        tap decision without a bus round trip."""
        if not isinstance(event, dict) or "change" not in event:
            self._m_dropped.labels(reason="malformed").inc()
            return False
        rec = event["change"]
        # ``ts`` must be numeric BEFORE the record is admitted: the
        # metrics below and every downstream merge sort float() it, so
        # a string ts appended here would detonate later, far from the
        # bad frame.
        if not isinstance(rec, dict) \
                or not isinstance(rec.get("kind"), str) \
                or not isinstance(rec.get("ts"), (int, float)) \
                or isinstance(rec.get("ts"), bool):
            self._m_dropped.labels(reason="malformed").inc()
            return False
        eid = rec.get("id")
        with self._lock:
            if isinstance(eid, str):
                if eid.startswith(self._source + ":") \
                        or eid in self._seen:
                    dup = True
                else:
                    dup = False
                    self._seen[eid] = None
                    while len(self._seen) > 2048:
                        self._seen.popitem(last=False)
            else:
                dup = False
            if not dup:
                self._events.append(dict(rec))
        if dup:
            self._m_dropped.labels(reason="duplicate").inc()
            return False
        self._m_events.labels(kind=str(rec["kind"]), origin="bus").inc()
        self._m_last.labels(kind=str(rec["kind"])).set(float(rec["ts"]))
        return True

    # ── bus fan-out ───────────────────────────────────────────────────

    def attach_bus(self, bus) -> None:
        """Publish locally-recorded events on ``config.channel`` AND
        start a daemon tap ingesting foreign events from the same
        channel (loop-safe: own events drop by source id, ring
        duplicates by event id). Idempotent."""
        def run(stop: threading.Event) -> None:
            backoff = 0.2
            while not stop.is_set():
                try:
                    sub = bus.subscribe(self.config.channel)
                except Exception as e:
                    _log.warning("change_tap_subscribe_failed",
                                 error=f"{type(e).__name__}: {e}")
                    if stop.wait(backoff):
                        return
                    backoff = min(backoff * 2, 5.0)
                    continue
                backoff = 0.2
                try:
                    while not stop.is_set():
                        data = sub.get(timeout=0.5)
                        if data is not None:
                            # One malformed frame must not kill the
                            # tap — ingest() rejects bad shapes, but a
                            # frame that still raises (hostile nesting,
                            # broken bus decode) only costs itself.
                            try:
                                self.ingest(data)
                            except Exception as e:
                                self._m_dropped.labels(
                                    reason="malformed").inc()
                                _log.warning(
                                    "change_tap_ingest_failed",
                                    error=f"{type(e).__name__}: {e}")
                        elif getattr(sub, "closed", False):
                            _log.warning("change_tap_closed")
                            break
                finally:
                    try:
                        sub.close()
                    except OSError:
                        _log.debug("change_tap_close_failed")

        # Check / stop-swap / start as ONE critical section: two
        # concurrent attach_bus calls (or attach racing stop) must not
        # start two taps on the same channel or orphan a stop event.
        with self._lock:
            if bus is None:
                self._bus = None
                return
            if self._bus is bus and self._tap_stop is not None:
                return
            self._bus = bus
            if self._tap_stop is not None:
                self._tap_stop.set()
            self._tap_stop = stop = threading.Event()
            threading.Thread(target=run, args=(stop,), daemon=True,
                             name="change-ledger-tap").start()

    def stop(self) -> None:
        with self._lock:
            if self._tap_stop is not None:
                self._tap_stop.set()
                self._tap_stop = None

    # ── query ─────────────────────────────────────────────────────────

    def events(self) -> List[dict]:
        """Every retained event, oldest first."""
        with self._lock:
            return [dict(r) for r in self._events]

    def query(self, kind: Optional[str] = None,
              replica: Optional[str] = None,
              version: Optional[str] = None,
              region: Optional[str] = None,
              bucket: Optional[str] = None,
              since: Optional[float] = None,
              limit: Optional[int] = None) -> dict:
        """The ``/api/changes`` payload: newest-first events filtered
        by kind substring + exact blast-radius labels + ``since``
        timestamp, capped at ``limit``."""
        wanted = {"replica": replica, "version": version,
                  "region": region, "bucket": bucket}
        out: List[dict] = []
        for rec in reversed(self.events()):
            if kind and kind not in str(rec.get("kind", "")):
                continue
            if since is not None and rec["ts"] <= since:
                continue
            if any(val is not None and rec.get(key) != val
                   for key, val in wanted.items()):
                continue
            out.append(rec)
            if limit is not None and len(out) >= limit:
                break
        return {"enabled": self.enabled, "count": len(out),
                "events": out}

    def snapshot(self) -> dict:
        events = self.events()
        kinds: Dict[str, int] = {}
        for rec in events:
            k = str(rec.get("kind"))
            kinds[k] = kinds.get(k, 0) + 1
        return {"enabled": self.enabled,
                "capacity": int(self.config.capacity),
                "events": len(events),
                "kinds": kinds,
                "newest_ts": events[-1]["ts"] if events else None,
                "context": dict(self._context)}


# ── suspect ranking ──────────────────────────────────────────────────


def scope_from_detail(detail) -> Dict[str, str]:
    """Extract the paging blast radius from a trigger's detail dict:
    canonical keys (and their aliases across the SLO / prober /
    watchdog surfaces), one level of nested dicts included — e.g. a
    probe verdict's ``{"offender": {"replica": ...}}``."""
    scope: Dict[str, str] = {}

    def fold(d) -> None:
        if not isinstance(d, dict):
            return
        for key, val in d.items():
            canon = _SCOPE_ALIASES.get(key)
            if canon is not None and isinstance(val, (str, int)) \
                    and canon not in scope:
                scope[canon] = str(val)
            elif isinstance(val, dict):
                fold(val)

    fold(detail)
    return scope


def rank_suspects(events: Sequence[dict], now: float,
                  scope: Optional[Dict[str, str]] = None,
                  window_s: float = 900.0,
                  limit: int = 5) -> List[dict]:
    """Score ledger events inside ``(now - window_s, now]`` by
    temporal proximity × blast-radius overlap with ``scope``:

    - proximity = ``1 - age/window`` — the change nearest the page
      wins ties;
    - every scope label the event MATCHES adds 1.0 to a 0.25 base
      (so fleet-wide events with no labels still rank — just below
      anything that names the paging scope);
    - a label the event carries that CONTRADICTS the scope multiplies
      the score by 0.1 per mismatch — another replica's deploy never
      outranks the offender's own, but stays visible at the bottom.

    Events outside the window never rank. Returns scored entries,
    best first."""
    scope = scope or {}
    out: List[dict] = []
    for rec in events:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        # Clamp sub-second negative ages: record() rounds timestamps to
        # 3 decimals, which can land microseconds AFTER a ``now`` taken
        # in the same instant — a just-recorded change must still rank.
        age = max(0.0, now - float(ts))
        if now - float(ts) < -1.0 or age >= window_s:
            continue
        proximity = max(0.0, 1.0 - age / window_s)
        matched: List[str] = []
        mismatched: List[str] = []
        for key in _SCOPE_KEYS:
            want = scope.get(key)
            have = rec.get(key)
            if want is None or have is None:
                continue
            if str(have) == str(want):
                matched.append(key)
            else:
                mismatched.append(key)
        score = proximity * (0.25 + float(len(matched)))
        score *= 0.1 ** len(mismatched)
        out.append({"score": round(score, 6),
                    "proximity": round(proximity, 4),
                    "matched": matched,
                    "mismatched": mismatched,
                    "age_s": round(age, 3),
                    "event": dict(rec)})
    out.sort(key=lambda s: (-s["score"], s["age_s"]))
    return out[:max(1, int(limit))]


# ── cross-region bridge ──────────────────────────────────────────────


class LedgerBridge:
    """One direction of cross-region change replication on the
    ``rtpu.changes`` channel — the ProbeBridge discipline (stamp
    origin on first crossing, drop frames stamped with either
    endpoint) applied to ledger events, so an A→B→A ring forwards
    each change exactly once per foreign region."""

    def __init__(self, src_region: str, dst_region: str,
                 src_bus, dst_bus,
                 channel: str = DEFAULT_CHANNEL) -> None:
        if src_region == dst_region:
            raise ValueError("bridge endpoints must be distinct regions")
        self.src_region = src_region
        self.dst_region = dst_region
        self._src_bus = src_bus
        self._dst_bus = dst_bus
        self.channel = channel
        self.forwarded = 0
        self.dropped = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._m_forwarded = reg.counter(
            "rtpu_change_bridge_forwarded_total",
            "Change events republished across regions, by direction.",
            ("src", "dst"))
        self._m_dropped = reg.counter(
            "rtpu_change_bridge_dropped_total",
            "Change events the bridge dropped, by direction and "
            "reason (loop / malformed / publish_error).",
            ("src", "dst", "reason"))

    def handle(self, event) -> bool:
        """One event → tag, suppress, or forward; True = republished."""
        labels = {"src": self.src_region, "dst": self.dst_region}
        if not isinstance(event, dict) or "change" not in event:
            self._m_dropped.labels(reason="malformed", **labels).inc()
            self.dropped += 1
            return False
        origin = event.get("origin_region")
        if origin in (self.src_region, self.dst_region):
            self._m_dropped.labels(reason="loop", **labels).inc()
            self.dropped += 1
            return False
        out = dict(event)
        if origin is None:
            out["origin_region"] = self.src_region
        try:
            self._dst_bus.publish(self.channel, out)
        except Exception:
            self._m_dropped.labels(reason="publish_error",
                                   **labels).inc()
            self.dropped += 1
            return False
        self.forwarded += 1
        self._m_forwarded.labels(**labels).inc()
        return True

    def _run(self) -> None:
        backoff = 0.2
        while not self._stop.is_set():
            try:
                sub = self._src_bus.subscribe(self.channel)
            except Exception as e:
                _log.warning("ledger_bridge_subscribe_failed",
                             src=self.src_region, dst=self.dst_region,
                             error=f"{type(e).__name__}: {e}")
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 5.0)
                continue
            backoff = 0.2
            try:
                while not self._stop.is_set():
                    data = sub.get(timeout=0.5)
                    if data is not None:
                        self.handle(data)
                    elif getattr(sub, "closed", False):
                        _log.warning("ledger_bridge_closed",
                                     src=self.src_region,
                                     dst=self.dst_region)
                        break
            finally:
                try:
                    sub.close()
                except OSError:
                    _log.debug("ledger_bridge_close_failed",
                               src=self.src_region,
                               dst=self.dst_region)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ledger-bridge-{self.src_region}-{self.dst_region}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def snapshot(self) -> dict:
        return {"src": self.src_region, "dst": self.dst_region,
                "channel": self.channel, "forwarded": self.forwarded,
                "dropped": self.dropped,
                "running": self._thread is not None
                and self._thread.is_alive()}


# ── process-wide instance ────────────────────────────────────────────

_ledger: Optional[ChangeLedger] = None
_ledger_lock = threading.Lock()


def get_change_ledger() -> ChangeLedger:
    """The process-wide change ledger (lazily built from env config)."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = ChangeLedger()
    return _ledger


def configure_change_ledger(ledger: Optional[ChangeLedger]
                            ) -> Optional[ChangeLedger]:
    """Install (or, with ``None``, reset) the process-wide ledger —
    tests and benches swap in instances bound to private registries."""
    global _ledger
    with _ledger_lock:
        prev, _ledger = _ledger, ledger
    return prev


def record_change(kind: str, **kwargs) -> Optional[dict]:
    """The standard call-site form (rtpulint's ``ledger-kind-*`` rules
    key on this name): record one state change on the process ledger.
    Fail-soft — instrumentation must never take down the path it
    observes."""
    try:
        return get_change_ledger().record(kind, **kwargs)
    except Exception as e:
        _log.warning("record_change_failed", kind=kind,
                     error=f"{type(e).__name__}: {e}")
        return None
