"""SLO engine: multi-window burn-rate alerting over registry rollups.

The methodology is the Google SRE workbook's "multiwindow, multi-burn-
rate alerts" (ch. 5): an objective (availability, or fraction of
requests under a latency threshold) defines an error budget
``1 - target``; the *burn rate* is the observed bad-event rate divided
by that budget. An alert pages only when the burn rate exceeds the
page threshold on BOTH a fast window (~5 min — is it happening *now*?)
and a slow window (~1 h — is it *sustained*?), which keeps pages fast
on real outages and quiet on blips.

No new time-series store: every source is a **rollup over the existing
registry counters/histograms**. The engine ticks on a daemon thread,
sampling each objective's cumulative ``(total, bad)`` into a bounded
ring of ``(t, total, bad)`` samples; a windowed rate is the delta
between the newest sample and the one at the window's left edge. With
less history than the slow window, the slow burn is the since-start
rate — the standard cold-start behavior (conservative: a fresh process
pages only on evidence it actually has).

Latency objectives count "good" as observations at or under the
threshold, snapped UP to the histogram's covering log bucket (the
engine documents the snapped value in its snapshot) — bucket math,
identical to what ``histogram_quantile`` consumers already accept.

States: ``ok → warn → page`` (and back; leaving ``page`` requires the
fast burn to drop, which it does within one fast window of the outage
ending). Every transition logs, counts
``rtpu_slo_transitions_total{slo,to}``, and an edge INTO ``page`` fires
the engine's ``on_page`` callbacks — the flight recorder subscribes,
so a page produces a postmortem bundle with the offending traces still
in the rings.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from routest_tpu_torch.core.config import SloConfig, load_slo_config
from routest_tpu_torch.obs.registry import Histogram, MetricsRegistry, get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.slo")

OK, WARN, PAGE = "ok", "warn", "page"
_LEVELS = {OK: 0, WARN: 1, PAGE: 2}

# (cumulative_total, cumulative_bad) — monotone non-decreasing.
Source = Callable[[], Tuple[float, float]]


class SloObjective:
    """One objective: a name, a target, and the source that rolls its
    cumulative (total, bad) counts out of a registry."""

    __slots__ = ("name", "kind", "target", "source", "detail")

    def __init__(self, name: str, kind: str, target: float,
                 source: Source, detail: Optional[dict] = None) -> None:
        if not (0.0 < target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.name = name
        self.kind = kind              # "availability" | "latency" | ...
        self.target = target
        self.source = source
        self.detail = detail or {}    # route, threshold — for /api/slo


class _Track:
    """Per-objective ring of (t, total, bad) samples + alert state."""

    __slots__ = ("objective", "ts", "totals", "bads", "state",
                 "last_transition_unix", "burn_fast", "burn_slow",
                 "budget_remaining")

    def __init__(self, objective: SloObjective) -> None:
        self.objective = objective
        self.ts: List[float] = []
        self.totals: List[float] = []
        self.bads: List[float] = []
        self.state = OK
        self.last_transition_unix: Optional[float] = None
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.budget_remaining = 1.0

    def append(self, now: float, total: float, bad: float,
               horizon_s: float) -> None:
        self.ts.append(now)
        self.totals.append(total)
        self.bads.append(bad)
        # Prune beyond the slow window (keep one sample outside it so
        # the slow delta spans the FULL window, not slightly less).
        cut = bisect.bisect_left(self.ts, now - horizon_s) - 1
        if cut > 0:
            del self.ts[:cut]
            del self.totals[:cut]
            del self.bads[:cut]

    def rate_over(self, window_s: float) -> Optional[float]:
        """Bad-event rate over the trailing window: delta(bad) /
        delta(total) between the newest sample and the one at (or just
        before) the window's left edge. None when no events happened in
        the window — "no data", distinct from "0% errors"."""
        if len(self.ts) < 2:
            return None
        now = self.ts[-1]
        i = bisect.bisect_right(self.ts, now - window_s) - 1
        if i < 0:
            i = 0
        d_total = self.totals[-1] - self.totals[i]
        d_bad = self.bads[-1] - self.bads[i]
        if d_total <= 0:
            return None
        return max(0.0, min(1.0, d_bad / d_total))


def histogram_family_rollup(registry: MetricsRegistry, family: str,
                            route_substr: str,
                            threshold_s: Optional[float] = None,
                            route_label: str = "route"):
    """→ (total, under_threshold_or_None) summed over every series of
    ``family`` whose route label contains ``route_substr``. With a
    threshold, "under" counts observations ≤ the covering log bucket."""
    m = registry.get(family)
    if m is None:
        return 0.0, (0.0 if threshold_s is not None else None)
    try:
        li = m.labelnames.index(route_label)
    except ValueError:
        li = None
    total = under = 0.0
    for key, child in m.items():
        if li is not None and route_substr not in key[li]:
            continue
        if not isinstance(child, Histogram):
            continue
        total += child.count
        if threshold_s is not None:
            cum = child.cumulative()
            under += next((c for bound, c in cum if bound >= threshold_s),
                          cum[-1][1])
    return total, (under if threshold_s is not None else None)


def snap_threshold(threshold_s: float,
                   buckets: Sequence[float]) -> float:
    """The bucket bound a latency threshold actually evaluates at."""
    return next((b for b in buckets if b >= threshold_s),
                buckets[-1] if buckets else threshold_s)


def route_availability_source(registry: MetricsRegistry, route_substr: str,
                              duration_family: str,
                              errors_family: str) -> Source:
    """Availability over per-route request families: total = histogram
    counts, bad = the matching error counters (status ≥ 500)."""

    def read() -> Tuple[float, float]:
        total, _ = histogram_family_rollup(registry, duration_family,
                                           route_substr)
        bad = 0.0
        m = registry.get(errors_family)
        if m is not None:
            try:
                li = m.labelnames.index("route")
            except ValueError:
                li = None
            for key, child in m.items():
                if li is None or route_substr in key[li]:
                    bad += child.value
        return total, min(bad, total)

    return read


def route_latency_source(registry: MetricsRegistry, route_substr: str,
                         threshold_s: float,
                         duration_family: str) -> Source:
    """Latency compliance: bad = observations over the (bucket-snapped)
    threshold."""

    def read() -> Tuple[float, float]:
        total, under = histogram_family_rollup(
            registry, duration_family, route_substr,
            threshold_s=threshold_s)
        return total, max(0.0, total - (under or 0.0))

    return read


def counter_ratio_source(registry: MetricsRegistry, total_family: str,
                         bad_families: Sequence[str]) -> Source:
    """Dependency availability from registry families: total = the
    operation count (histogram counts or counter values), bad = the sum
    of the failure families (e.g. store errors AND journaled writes —
    a breaker-open write "succeeds" locally without erroring, yet burns
    the dependency's budget). Retries can fail more than once per
    operation, so bad is clamped to total — a saturated ratio, not a
    >100% rate."""

    def _sum(family: str) -> float:
        m = registry.get(family)
        if m is None:
            return 0.0
        out = 0.0
        for _key, child in m.items():
            out += child.count if isinstance(child, Histogram) \
                else child.value
        return out

    def read() -> Tuple[float, float]:
        total = _sum(total_family)
        bad = sum(_sum(f) for f in bad_families)
        return max(total, bad), min(bad, max(total, bad))

    return read


def parse_objective_spec(spec: str) -> List[dict]:
    """``RTPU_SLO_OBJECTIVES`` grammar → [{route, availability,
    latency_ms, latency_target}]. Malformed tokens are skipped with a
    logged warning (ops knob: a typo degrades, never crashes)."""
    out: List[dict] = []
    for tok in (spec or "").split(";"):
        tok = tok.strip()
        if not tok:
            continue
        route, _, params = tok.partition(":")
        route = route.strip()
        if not route:
            _log.warning("slo_spec_malformed", token=tok)
            continue
        obj = {"route": route, "availability": 0.999,
               "latency_ms": None, "latency_target": 0.99}
        ok = True
        for kv in params.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep or key not in ("availability", "latency_ms",
                                      "latency_target"):
                ok = False
                break
            try:
                obj[key] = float(val)
            except ValueError:
                ok = False
                break
        if not ok:
            _log.warning("slo_spec_malformed", token=tok)
            continue
        out.append(obj)
    return out


class SloEngine:
    """Evaluates a set of objectives on a tick; owns the alert states.

    ``component`` labels this engine's metric series (one process can
    host a gateway engine and replica engines in tests). Metric gauges
    land in ``metrics_registry`` (default: the process registry, so
    both tiers' ``/api/metrics`` expose ``rtpu_slo_*``)."""

    def __init__(self, config: Optional[SloConfig] = None,
                 component: str = "replica",
                 metrics_registry: Optional[MetricsRegistry] = None) -> None:
        self.config = config or load_slo_config()
        self.component = component
        self._tracks: Dict[str, _Track] = {}
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self.on_page: List[Callable[[str, dict], None]] = []
        # Fired on any UPWARD transition (ok→warn, warn→page, ok→page):
        # the earliest evidence edge — the triggered profiler arms here
        # so the capture brackets the incident's onset, not its
        # aftermath. Callbacks get (slo_name, detail) like on_page.
        self.on_warn: List[Callable[[str, dict], None]] = []
        reg = metrics_registry if metrics_registry is not None \
            else get_registry()
        labels = ("component", "slo")
        self._m_state = reg.gauge(
            "rtpu_slo_alert_state",
            "Alert state per objective: 0 ok, 1 warn, 2 page.", labels)
        self._m_burn = reg.gauge(
            "rtpu_slo_burn_rate",
            "Error-budget burn rate per objective and window.",
            labels + ("window",))
        self._m_budget = reg.gauge(
            "rtpu_slo_error_budget_remaining",
            "Fraction of the slow-window error budget left (can go "
            "negative: budget overspent).", labels)
        self._m_transitions = reg.counter(
            "rtpu_slo_transitions_total",
            "Alert state transitions, by destination state.",
            labels + ("to",))

    # ── objectives ────────────────────────────────────────────────────

    def add_objective(self, objective: SloObjective) -> None:
        with self._lock:
            if objective.name in self._tracks:
                raise ValueError(f"duplicate objective {objective.name!r}")
            self._tracks[objective.name] = _Track(objective)

    def add_route_objectives(self, registry: MetricsRegistry,
                             duration_family: str, errors_family: str,
                             spec: Optional[str] = None,
                             defaults: Optional[List[dict]] = None) -> None:
        """Declare availability/latency objectives for each route in
        the spec (or ``defaults`` when the spec is empty) against the
        given per-route request families."""
        objs = parse_objective_spec(spec if spec is not None
                                    else self.config.objectives)
        if not objs:
            objs = defaults or []
        for obj in objs:
            route = obj["route"]
            self.add_objective(SloObjective(
                f"availability:{route}", "availability",
                obj["availability"],
                route_availability_source(registry, route,
                                          duration_family, errors_family),
                detail={"route": route}))
            if obj.get("latency_ms"):
                threshold_s = obj["latency_ms"] / 1000.0
                self.add_objective(SloObjective(
                    f"latency:{route}", "latency", obj["latency_target"],
                    route_latency_source(registry, route, threshold_s,
                                         duration_family),
                    detail={"route": route,
                            "threshold_ms": obj["latency_ms"]}))

    # ── evaluation ────────────────────────────────────────────────────

    def tick(self, now: Optional[float] = None) -> None:
        """Sample every source, recompute burns, run the state machine,
        fire page edges. Source failures log loudly and skip the
        objective this tick — a broken rollup must not kill the ticker."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        paged: List[Tuple[str, dict]] = []
        warned: List[Tuple[str, dict]] = []
        with self._lock:
            tracks = list(self._tracks.values())
        for track in tracks:
            try:
                total, bad = track.objective.source()
            except Exception as e:
                _log.error("slo_source_failed", slo=track.objective.name,
                           error=f"{type(e).__name__}: {e}")
                continue
            with self._lock:
                track.append(now, float(total), float(bad),
                             cfg.slow_window_s + 2 * cfg.tick_s)
                edge = self._evaluate_locked(track)
            if edge is not None:
                upward, level, name, detail = edge
                if upward:
                    warned.append((name, detail))
                if level == PAGE:
                    paged.append((name, detail))
        for name, detail in warned:
            for cb in list(self.on_warn):
                try:
                    cb(name, detail)
                except Exception as e:
                    _log.error("slo_warn_callback_failed", slo=name,
                               error=f"{type(e).__name__}: {e}")
        for name, detail in paged:
            for cb in list(self.on_page):
                try:
                    cb(name, detail)
                except Exception as e:
                    _log.error("slo_page_callback_failed", slo=name,
                               error=f"{type(e).__name__}: {e}")

    def _evaluate_locked(self, track: _Track
                         ) -> Optional[Tuple[bool, str, str, dict]]:
        """→ None (no transition) or ``(upward, level, name, detail)``."""
        cfg = self.config
        budget = 1.0 - track.objective.target
        rate_fast = track.rate_over(cfg.fast_window_s)
        rate_slow = track.rate_over(cfg.slow_window_s)
        track.burn_fast = (rate_fast or 0.0) / budget
        track.burn_slow = (rate_slow or 0.0) / budget
        # A burn of exactly 1 over the slow window spends exactly that
        # window's budget; remaining goes negative when overspent.
        track.budget_remaining = 1.0 - track.burn_slow
        if track.burn_fast >= cfg.page_burn and \
                track.burn_slow >= cfg.page_burn:
            level = PAGE
        elif track.burn_fast >= cfg.warn_burn and \
                track.burn_slow >= cfg.warn_burn:
            level = WARN
        else:
            level = OK
        name = track.objective.name
        labels = {"component": self.component, "slo": name}
        self._m_state.labels(**labels).set(_LEVELS[level])
        self._m_burn.labels(**labels, window="fast").set(
            round(track.burn_fast, 4))
        self._m_burn.labels(**labels, window="slow").set(
            round(track.burn_slow, 4))
        self._m_budget.labels(**labels).set(round(track.budget_remaining, 4))
        if level == track.state:
            return None
        previous, track.state = track.state, level
        track.last_transition_unix = time.time()
        self._m_transitions.labels(**labels, to=level).inc()
        detail = {
            "component": self.component, "from": previous, "to": level,
            "burn_fast": round(track.burn_fast, 3),
            "burn_slow": round(track.burn_slow, 3),
            "target": track.objective.target, "kind": track.objective.kind,
            **track.objective.detail,
        }
        upward = _LEVELS[level] > _LEVELS[previous]
        log = _log.warning if upward else _log.info
        log("slo_transition", slo=name, **detail)
        return upward, level, name, detail

    # ── lifecycle + export ────────────────────────────────────────────

    def start(self) -> threading.Event:
        """Tick on a daemon thread every ``tick_s``; returns the stop
        event. Idempotent — a second start returns the live event."""
        if self._stop is not None:
            return self._stop
        self._stop = stop = threading.Event()

        def run() -> None:
            while not stop.wait(self.config.tick_s):
                self.tick()

        threading.Thread(target=run, daemon=True,
                         name=f"slo-{self.component}").start()
        return stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def worst_state(self) -> str:
        with self._lock:
            states = [t.state for t in self._tracks.values()]
        return max(states, key=_LEVELS.get, default=OK)

    def snapshot(self) -> dict:
        """The ``/api/slo`` payload: config + per-objective state."""
        cfg = self.config
        with self._lock:
            objectives = {}
            for name, t in sorted(self._tracks.items()):
                total = t.totals[-1] if t.totals else 0.0
                bad = t.bads[-1] if t.bads else 0.0
                objectives[name] = {
                    "kind": t.objective.kind,
                    "target": t.objective.target,
                    "state": t.state,
                    "burn_fast": round(t.burn_fast, 4),
                    "burn_slow": round(t.burn_slow, 4),
                    "error_budget_remaining": round(t.budget_remaining, 4),
                    "total": total,
                    "bad": bad,
                    "last_transition_unix": t.last_transition_unix,
                    **t.objective.detail,
                }
        return {
            "component": self.component,
            "enabled": cfg.enabled,
            "state": max((o["state"] for o in objectives.values()),
                         key=_LEVELS.get, default=OK),
            "windows": {"fast_s": cfg.fast_window_s,
                        "slow_s": cfg.slow_window_s,
                        "tick_s": cfg.tick_s},
            "thresholds": {"page_burn": cfg.page_burn,
                           "warn_burn": cfg.warn_burn},
            "objectives": objectives,
        }


# Built-in default objectives for the replica tier (spec empty). The
# latency thresholds snap up to registry log buckets; they are chosen
# for the 1-core CI host — real deployments override via
# RTPU_SLO_OBJECTIVES.
REPLICA_DEFAULT_OBJECTIVES = [
    {"route": "/api/predict_eta", "availability": 0.999,
     "latency_ms": 1000.0, "latency_target": 0.95},
    {"route": "/api/optimize_route", "availability": 0.99,
     "latency_ms": 5000.0, "latency_target": 0.95},
    {"route": "/api/dispatch", "availability": 0.99,
     "latency_ms": 5000.0, "latency_target": 0.95},
]

GATEWAY_DEFAULT_OBJECTIVES = [
    {"route": "", "availability": 0.999,   # "" matches every route
     "latency_ms": 2500.0, "latency_target": 0.95},
]


def build_replica_engine(stats_registry: MetricsRegistry,
                         config: Optional[SloConfig] = None) -> SloEngine:
    """The serving App's engine: per-route objectives over its private
    ``RequestStats`` registry plus a store-dependency availability
    objective over the process registry's resilience counters."""
    engine = SloEngine(config=config, component="replica")
    engine.add_route_objectives(
        stats_registry, "request_duration_seconds", "request_errors_total",
        defaults=REPLICA_DEFAULT_OBJECTIVES)
    if not engine.config.objectives:
        engine.add_objective(SloObjective(
            "availability:store", "dependency", 0.99,
            counter_ratio_source(get_registry(), "rtpu_store_op_seconds",
                                 ("rtpu_store_errors_total",
                                  "rtpu_store_journal_writes_total")),
            detail={"dependency": "store"}))
    return engine


def build_gateway_engine(config: Optional[SloConfig] = None) -> SloEngine:
    """The gateway's engine over its per-route process-registry
    families (``rtpu_gateway_request_seconds`` / ``_errors_total``)."""
    engine = SloEngine(config=config, component="gateway")
    engine.add_route_objectives(
        get_registry(), "rtpu_gateway_request_seconds",
        "rtpu_gateway_request_errors_total",
        defaults=GATEWAY_DEFAULT_OBJECTIVES)
    return engine


# ── correctness SLOs over blackbox-probe verdicts ────────────────────

def probe_verdict_source(registry: MetricsRegistry, probe: str) -> Source:
    """(total, bad) over ``rtpu_probe_checks_total`` for one probe
    kind: total = every verdict, bad = every non-``pass`` verdict
    (divergent, skew, unreachable — to the correctness objective they
    are one thing: the system could not prove its answer right)."""

    def read() -> Tuple[float, float]:
        m = registry.get("rtpu_probe_checks_total")
        if m is None:
            return 0.0, 0.0
        pi = m.labelnames.index("probe")
        vi = m.labelnames.index("verdict")
        total = bad = 0.0
        for key, child in m.items():
            if key[pi] != probe:
                continue
            total += child.value
            if key[vi] != "pass":
                bad += child.value
        return total, bad

    return read


def build_prober_engine(prober_config, kinds: Sequence[str],
                        registry: Optional[MetricsRegistry] = None
                        ) -> SloEngine:
    """The blackbox prober's dedicated engine (component ``prober``):
    one ``correctness:<kind>`` objective per armed probe kind, over
    probe-scale windows (probes run at ~0.2/s; judging them on the
    user-traffic windows would take an hour of evidence to page). The
    engine is ticked by the probe loop itself — no second ticker —
    and its page edges ship the ``correctness_page`` evidence bundle.
    Kept here so every burn-rate objective in the system is declared
    through one module, whatever it measures."""
    reg = registry if registry is not None else get_registry()
    cfg = SloConfig(
        enabled=True, tick_s=0.0,
        fast_window_s=prober_config.fast_window_s,
        slow_window_s=prober_config.slow_window_s,
        page_burn=SloConfig.page_burn, warn_burn=SloConfig.warn_burn)
    engine = SloEngine(config=cfg, component="prober")
    for kind in kinds:
        engine.add_objective(SloObjective(
            f"correctness:{kind}", "correctness",
            prober_config.slo_target,
            probe_verdict_source(reg, kind),
            detail={"probe": kind}))
    return engine


# ── efficiency SLOs over goodput-watchdog verdicts ───────────────────

def efficiency_verdict_source(registry: MetricsRegistry,
                              check: str) -> Source:
    """(total, bad) over ``rtpu_efficiency_checks_total`` for one check
    family: the bare check name (``throughput``) or any of its
    per-program children (``padding:<program>``). Bad = every
    non-``pass`` verdict (shortfall, waste)."""

    def read() -> Tuple[float, float]:
        m = registry.get("rtpu_efficiency_checks_total")
        if m is None:
            return 0.0, 0.0
        ci = m.labelnames.index("check")
        vi = m.labelnames.index("verdict")
        total = bad = 0.0
        for key, child in m.items():
            if key[ci] != check and not key[ci].startswith(check + ":"):
                continue
            total += child.value
            if key[vi] != "pass":
                bad += child.value
        return total, bad

    return read


def build_efficiency_engine(eff_config,
                            registry: Optional[MetricsRegistry] = None
                            ) -> SloEngine:
    """The goodput watchdog's dedicated engine (component
    ``efficiency``): one objective per check family — sustained
    throughput shortfall vs the pinned curve, and padding waste past
    threshold — over watchdog-scale windows (the watchdog ticks at
    ~0.2/s like the prober; user-traffic windows would take an hour of
    evidence to page). Ticked by the watchdog loop itself; its page
    edges ship the ``efficiency_page`` expected-vs-measured bundle.
    Kept here so every burn-rate objective in the system is declared
    through one module, whatever it measures."""
    reg = registry if registry is not None else get_registry()
    cfg = SloConfig(
        enabled=True, tick_s=0.0,
        fast_window_s=eff_config.fast_window_s,
        slow_window_s=eff_config.slow_window_s,
        page_burn=SloConfig.page_burn, warn_burn=SloConfig.warn_burn)
    engine = SloEngine(config=cfg, component="efficiency")
    for check in ("throughput", "padding"):
        engine.add_objective(SloObjective(
            f"efficiency:{check}", "efficiency",
            eff_config.slo_target,
            efficiency_verdict_source(reg, check),
            detail={"check": check}))
    return engine
