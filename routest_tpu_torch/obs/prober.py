"""In-fleet blackbox prober: the system continuously checks its own answers.

The counterpart of ``routest_tpu/obs/prober.py``; probe bodies and wire
frames are byte-identical to the JAX package's, and the golden rows are
the port's own ``serve/ml_service.golden_batch()`` (on a card the
replicas score them through ``ops/csrc/fused_eta.cu``).

Everything observability built so far (metrics, SLOs, timelines,
traces) watches how the system *behaves* — nothing in production
watches whether its answers are *right*. Oracle parity lives in
benches, golden-batch verification fires once per model swap, and a
replica serving a stale metric epoch, a silently-skewed device, or a
divergent model that landed around the swap gate answers confident
200s forever. This module is the active-monitoring counterpart to the
SLO engine: low-rate synthetic requests through the REAL
gateway→replica path, judged against pinned/oracle expectations, with
the verdicts rolled into a first-class **correctness SLO** whose page
ships a flight-recorder bundle embedding the offending probe.

Probe kinds:

- **golden** — the golden ETA batch (the verified-swap gate's own
  rows, as an HTTP body) via the gateway, compared against pinned
  expected quantile bands. Tolerance defaults to the swap gate's
  margin (``RTPU_SWAP_MAX_DIV``): a model the gate would accept never
  trips the prober; one past the gate's tolerance always does. A
  passing probe re-pins (so verified swaps ratchet the expectation
  forward); a point↔quantile shape change re-arms (the gate treats it
  as a deliberate structural change, and so does the prober).
- **route** / **matrix** — ``request_route`` / ``travel_matrix`` on a
  pinned probe subgraph (``RTPU_PROBER_ROUTES`` OD pairs). Expected
  answers come from a scipy Dijkstra oracle over the replica's own
  ``/api/debug/probe_subgraph`` topology export, computed once at arm
  time and **re-derived on every metric-epoch flip** from the
  ``/api/live?metric=1`` export — the live loop's invariant (served duration
  ≡ scipy on the exported metric) made a continuously-checked one.
  Without a road graph / live metric the probes degrade to
  pinned-answer self-consistency, re-armed per epoch flip.
- **fanout** — the SAME golden request to every replica directly,
  comparing answers (vs the pinned bands), model identity
  (``/api/version`` fingerprint), and metric epoch (``/api/live``).
  Cross-replica skew — the failure rollouts and multi-region
  replication create — must persist ``skew_after`` consecutive rounds
  before the verdict, so a flip or verified swap propagating through
  the fleet is a transient, never a page; epoch lag only counts at
  ``epoch_gap`` or more, because staggered customize timers keep a
  healthy fleet at gap ≤ 1 forever.

Probe traffic carries ``X-RTPU-Probe: <kind>`` and is EXCLUDED from
every user-facing request-stat/SLO family before the rollup (gateway
and replica both) — synthetic load can never burn user error budget —
landing instead in its own ``rtpu_probe_*`` families, which feed the
metric timeline like any other registry family. Any non-pass verdict is
re-probed once before it is recorded (a single timeout blip under load
must not page a low-rate SLO); a fully unreachable fleet backs the
probe interval off exponentially to ``backoff_cap_s``.

Verdicts: ``pass`` / ``divergent`` (answer beyond tolerance) /
``skew`` (cross-replica mismatch persisting) / ``unreachable``. The
dedicated burn-rate engine (``obs/slo.py:build_prober_engine``,
component ``prober``) pages on sustained non-pass fractions; the page
writes a ``correctness_page`` bundle whose ``probe_evidence.json``
embeds the offending probe request, served answer, oracle/pinned
answer, divergence, and the replica(s) it names — and the probe's
trace is tail-retained (``tail: probe``) when tail sampling is armed.
"""

from __future__ import annotations

import collections
import datetime as dt
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from routest_tpu_torch.core.config import ProberConfig, load_prober_config
from routest_tpu_torch.obs.registry import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.prober")

PROBE_HEADER = "X-RTPU-Probe"

PASS, DIVERGENT, SKEW, UNREACHABLE = ("pass", "divergent", "skew",
                                      "unreachable")

# Divergence magnitudes span ETA minutes (can be ~1e6 for a corrupted
# export) and relative route errors (~1e-6): log-decade buckets.
_DIVERGENCE_BUCKETS = tuple(10.0 ** e for e in range(-6, 7))

# Snapped-waypoint walking legs are priced at the car profile speed —
# the same constant the road router's duration tables use.
_CAR_SPEED_MPS = 8.3


def golden_probe_body() -> dict:
    """The golden ETA batch as an HTTP ``/api/predict_eta_batch`` body:
    every weather×traffic pair twice with weekday/hour/distance/age
    swept — the HTTP twin of ``ml_service.golden_batch`` (same sweep
    recipe), with explicit ISO pickup instants because
    ``pickup_time=None`` would feature-encode *now* and break
    determinism across probes."""
    from routest_tpu_torch.data.features import (TRAFFIC_CATEGORIES,
                                           WEATHER_CATEGORIES)

    combos = [(w, t) for w in WEATHER_CATEGORIES
              for t in TRAFFIC_CATEGORIES]
    n = 2 * len(combos)
    base = dt.datetime(2026, 1, 5, 0, 0)      # a Monday, hour 0
    return {
        "weather": [w for w, _ in combos] * 2,
        "traffic": [t for _, t in combos] * 2,
        "distance_m": [500.0 + (i % 12) * 2500.0 for i in range(n)],
        "driver_age": [20.0 + (i % 8) * 5.0 for i in range(n)],
        "pickup_time": [
            (base + dt.timedelta(days=i % 7, hours=(7 * i) % 24))
            .isoformat() for i in range(n)],
    }


def golden_wire_frame() -> bytes:
    """The golden batch as a binary wire frame (docs/API.md "Binary
    wire format"): the SAME rows as :func:`golden_probe_body`,
    featurized client-side with the server's own ``encode_requests`` —
    so the wire parity probe offers bit-identical model inputs over
    both content-types."""
    from routest_tpu_torch.data.features import encode_requests
    from routest_tpu_torch.serve.wirecodec import encode_eta_request

    body = golden_probe_body()
    pickups = [dt.datetime.fromisoformat(p) for p in body["pickup_time"]]
    features = encode_requests(
        weather=body["weather"], traffic=body["traffic"],
        weekday=[p.weekday() for p in pickups],
        hour=[p.hour for p in pickups],
        distance_km=[d / 1000.0 for d in body["distance_m"]],
        driver_age=body["driver_age"])
    pickup_ms = np.asarray(
        [np.datetime64(p, "ms") for p in body["pickup_time"]],
        "datetime64[ms]").astype(np.int64)
    return encode_eta_request(np.asarray(features, np.float32), pickup_ms)


def eta_columns(payload: dict) -> Dict[str, np.ndarray]:
    """The comparable numeric columns of a batch-predict answer: the
    median plus every quantile band, as float arrays (nulls → NaN, so
    a non-finite served row reads as divergent, never as equal)."""
    out: Dict[str, np.ndarray] = {}
    for key, val in payload.items():
        if key != "eta_minutes_ml" and \
                not key.startswith("eta_minutes_ml_"):
            continue
        if not isinstance(val, list):
            continue
        out[key] = np.asarray(
            [v if isinstance(v, (int, float)) else np.nan for v in val],
            np.float64)
    return out


def eta_divergence(expected: Dict[str, np.ndarray],
                   got: Dict[str, np.ndarray]) -> Optional[float]:
    """Median absolute divergence (minutes) over the SHARED columns;
    None when no column is shared (a point↔quantile structural change
    — the swap gate deliberately skips that compare, and so does the
    prober: the caller re-arms). NaN anywhere → inf (non-finite served
    answers are maximally divergent)."""
    shared = [k for k in expected if k in got
              and len(expected[k]) == len(got[k])]
    if not shared:
        return None
    diffs = np.concatenate([np.abs(expected[k] - got[k]) for k in shared])
    if not np.isfinite(diffs).all():
        return float("inf")
    return float(np.median(diffs))


def parse_probe_routes(spec: str) -> List[Tuple[float, float]]:
    """``RTPU_PROBER_ROUTES`` grammar: ``lat,lon|lat,lon[|…]`` —
    waypoints separated by ``|`` (``;`` tolerated). Malformed tokens
    are skipped with a logged warning (ops knob: a typo disarms the
    route probes, never crashes the gateway)."""
    out: List[Tuple[float, float]] = []
    for tok in spec.replace(";", "|").split("|"):
        tok = tok.strip()
        if not tok:
            continue
        lat, sep, lon = tok.partition(",")
        try:
            if not sep:
                raise ValueError(tok)
            out.append((float(lat), float(lon)))
        except ValueError:
            _log.warning("prober_routes_malformed", token=tok)
    return out


class ProbeUnreachable(Exception):
    """Transport failure / non-2xx from a probe request."""


def _http_json(method: str, url: str, body: Optional[dict],
               timeout: float, probe: str) -> Tuple[dict, Dict[str, str]]:
    """One tagged probe exchange → (parsed JSON, response headers).
    Raises :class:`ProbeUnreachable` on transport errors, non-2xx, or
    an unparsable body — to a blackbox prober those are one verdict."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", PROBE_HEADER: probe})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = json.loads(resp.read())
            headers = {k.lower(): v for k, v in resp.getheaders()}
    except (urllib.error.URLError, OSError, ValueError) as e:
        # HTTPError is a URLError subclass: 4xx/5xx land here too.
        raise ProbeUnreachable(f"{type(e).__name__}: {e}") from e
    if not isinstance(payload, dict):
        raise ProbeUnreachable("non-object response body")
    return payload, headers


def _http_wire(url: str, frame: bytes, timeout: float,
               probe: str) -> Tuple[bytes, Dict[str, str]]:
    """One tagged binary-wire probe exchange → (raw frame bytes,
    response headers). Same one-verdict rule as :func:`_http_json`:
    transport errors and non-2xx (including 415 from a wire-disabled
    replica) are :class:`ProbeUnreachable`."""
    req = urllib.request.Request(
        url, data=frame, method="POST",
        headers={"Content-Type": "application/x-rtpu-wire",
                 PROBE_HEADER: probe})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            headers = {k.lower(): v for k, v in resp.getheaders()}
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise ProbeUnreachable(f"{type(e).__name__}: {e}") from e
    return raw, headers


class SubgraphOracle:
    """scipy Dijkstra oracle over the pinned probe subgraph.

    Topology comes from a replica's ``/api/debug/probe_subgraph``
    export (senders/receivers in graph edge order + the probe
    waypoints' snapped node indices and snap distances), fetched once
    at arm time. Expected durations are derived from the
    ``/api/live?metric=1`` export — the replica's own serving metric —
    and cached per metric epoch, so every legitimate flip re-derives
    the oracle instead of paging. Served durations then satisfy
    ``served ≡ dijkstra(exported metric) + snap legs`` by the live
    router's construction; the prober compares at ``route_tolerance_rel``."""

    KEEP_EPOCHS = 3

    def __init__(self, waypoints: Sequence[Tuple[float, float]],
                 timeout_s: float = 30.0) -> None:
        self.waypoints = list(waypoints)
        self.timeout_s = timeout_s
        self._topo: Optional[dict] = None
        self._by_epoch: "collections.OrderedDict[int, np.ndarray]" = \
            collections.OrderedDict()
        self._m_rederive = get_registry().counter(
            "rtpu_probe_oracle_rederivations_total",
            "Probe-oracle answer derivations, one per observed metric "
            "epoch (arm time included).")

    @property
    def armed(self) -> bool:
        return self._topo is not None

    def arm(self, base: str) -> bool:
        """Fetch the subgraph topology from ``base`` (a replica).
        False when the replica serves no road graph or the graph is
        over the export bound — route probes then run pinned-mode."""
        if self._topo is not None:
            return True
        query = "&".join(f"wp={lat:.7f},{lon:.7f}"
                         for lat, lon in self.waypoints)
        try:
            payload, _ = _http_json(
                "GET", f"{base}/api/debug/probe_subgraph?{query}", None,
                self.timeout_s, probe="oracle")
        except ProbeUnreachable as e:
            _log.info("probe_subgraph_unavailable", base=base,
                      error=str(e))
            return False
        if payload.get("error") or "senders" not in payload:
            _log.info("probe_subgraph_refused", base=base,
                      error=payload.get("error"))
            return False
        self._topo = {
            "n_nodes": int(payload["nodes"]),
            "senders": np.asarray(payload["senders"], np.int64),
            "receivers": np.asarray(payload["receivers"], np.int64),
            "snapped": np.asarray(payload["snapped"], np.int64),
            "snap_m": np.asarray(payload["snap_m"], np.float64),
        }
        _log.info("probe_oracle_armed", base=base,
                  nodes=self._topo["n_nodes"],
                  edges=len(self._topo["senders"]),
                  waypoints=len(self.waypoints))
        return True

    def refresh(self, base: str) -> Optional[int]:
        """Ensure the oracle has answers for ``base``'s CURRENT metric
        epoch (epoch-consistent fetch: metric and epoch re-read until
        they agree). Returns the epoch, or None when the live metric
        is not exported (live traffic off)."""
        if self._topo is None:
            return None
        # Cheap epoch peek first: the full metric export is tens of
        # thousands of floats, and paying it every probe round (vs
        # only on a flip) was a measured p95 tax on small hosts.
        try:
            peek, _ = _http_json("GET", f"{base}/api/live", None,
                                 self.timeout_s, probe="oracle")
        except ProbeUnreachable:
            return None
        if not peek.get("enabled", True):
            return None
        peek_epoch = peek.get("epoch")
        if isinstance(peek_epoch, int) and peek_epoch in self._by_epoch:
            self._by_epoch.move_to_end(peek_epoch)
            return peek_epoch
        for _attempt in range(3):
            try:
                live, _ = _http_json("GET", f"{base}/api/live?metric=1",
                                     None, self.timeout_s, probe="oracle")
                if not live.get("enabled", True) or \
                        "edge_time_s" not in live:
                    return None
                epoch = int(live.get("epoch", 0))
                check, _ = _http_json("GET", f"{base}/api/live", None,
                                      self.timeout_s, probe="oracle")
            except ProbeUnreachable:
                return None
            if int(check.get("epoch", 0)) != epoch:
                continue            # flipped mid-fetch: retry
            if epoch in self._by_epoch:
                self._by_epoch.move_to_end(epoch)
                return epoch
            metric = np.asarray(live["edge_time_s"], np.float64)
            self._by_epoch[epoch] = self._solve(metric)
            self._m_rederive.inc()
            while len(self._by_epoch) > self.KEEP_EPOCHS:
                self._by_epoch.popitem(last=False)
            _log.info("probe_oracle_rederived", epoch=epoch,
                      edges=len(metric))
            return epoch
        return None

    def _solve(self, metric: np.ndarray) -> np.ndarray:
        """All-pairs durations between the probe waypoints on the
        exported metric: dijkstra between snapped nodes plus the two
        snap legs at the car profile speed."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import dijkstra

        topo = self._topo
        adj = sp.coo_matrix(
            (metric, (topo["senders"], topo["receivers"])),
            shape=(topo["n_nodes"], topo["n_nodes"])).tocsr()
        snapped = topo["snapped"]
        dist = dijkstra(adj, directed=True, indices=snapped)
        node_s = dist[:, snapped]
        snap_s = topo["snap_m"] / _CAR_SPEED_MPS
        return node_s + snap_s[:, None] + snap_s[None, :]

    def candidates(self) -> List[Tuple[int, np.ndarray]]:
        """(epoch, durations) for the retained epochs, newest first —
        a probe answered by a replica one flip behind compares against
        the previous epoch's oracle, not a page."""
        return list(reversed(list(self._by_epoch.items())))


class BlackboxProber:
    """The probing loop: one daemon thread, one round per interval.

    ``gateway_base`` is the fleet's own listen address (probes take the
    real client path: admission, routing, hedging); ``targets_fn``
    yields the live ``(rid, base)`` replica set for the fan-out probe.
    The verdict counters feed a dedicated burn-rate engine (component
    ``prober``) whose page edge writes the ``correctness_page``
    evidence bundle."""

    def __init__(self, config: Optional[ProberConfig] = None,
                 gateway_base: str = "",
                 targets_fn: Optional[Callable[[], List[Tuple[str, str]]]]
                 = None,
                 recorder=None,
                 oracle: Optional[SubgraphOracle] = None) -> None:
        self.config = config or load_prober_config()
        self.gateway_base = gateway_base.rstrip("/")
        self.targets_fn = targets_fn or (lambda: [])
        if recorder is None:
            from routest_tpu_torch.obs.recorder import get_recorder

            recorder = get_recorder()
        self._recorder = recorder
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self.route_waypoints = parse_probe_routes(self.config.routes)
        self.oracle = oracle
        if self.oracle is None and len(self.route_waypoints) >= 2:
            self.oracle = SubgraphOracle(self.route_waypoints,
                                         timeout_s=self.config.timeout_s)
        self.kinds = ["golden", "fanout", "dispatch"]
        if len(self.route_waypoints) >= 2:
            self.kinds += ["route", "matrix"]
        # Wire parity probe (docs/API.md "Binary wire format"): armed
        # only when the fleet actually serves the binary format. Its
        # ``correctness:wire`` SLO lives in the prober's dedicated
        # engine like every other kind — never in the user SLO
        # families.
        from routest_tpu_torch.core.config import load_wire_config

        if load_wire_config().enabled:
            self.kinds.append("wire")
        # Pinned expectations (None = arming). golden: {col: vec};
        # route: float seconds; matrix: ndarray. Pinned-mode route
        # answers re-arm on metric-epoch flips (_pin_epoch tracks the
        # fleet-max epoch the pin was taken at).
        self._pins: Dict[str, object] = {}
        self._pin_epoch: Optional[int] = None
        self._rounds = 0
        self._interval = max(0.2, self.config.interval_s)
        # Fan-out skew debounce: dimension -> consecutive rounds with
        # offenders (and who they were).
        self._skew_rounds: Dict[str, int] = {}
        self._skew_offenders: Dict[str, List[str]] = {}
        self._state: Dict[str, dict] = {}
        self._failures: collections.deque = collections.deque(
            maxlen=max(1, self.config.failures_kept))
        self.eta_tolerance = self.config.eta_tolerance
        if self.eta_tolerance <= 0:
            from routest_tpu_torch.core.config import load_config

            self.eta_tolerance = \
                load_config().serve.swap_max_divergence or 240.0
        reg = get_registry()
        self._m_checks = reg.counter(
            "rtpu_probe_checks_total",
            "Blackbox probe verdicts, by probe kind and verdict.",
            ("probe", "verdict"))
        self._m_divergence = reg.histogram(
            "rtpu_probe_divergence",
            "Observed probe divergence (golden/fanout: minutes; "
            "route/matrix: relative error), by probe kind.",
            ("probe",), buckets=_DIVERGENCE_BUCKETS)
        self._m_skew = reg.gauge(
            "rtpu_probe_replica_skew",
            "1 while the fan-out probe names this replica an offender "
            "on the given dimension (answer/model/epoch), else 0.",
            ("replica", "dimension"))
        self._m_rounds = reg.counter(
            "rtpu_probe_rounds_total", "Probe rounds completed.")
        self._m_interval = reg.gauge(
            "rtpu_probe_interval_seconds",
            "Current probe interval (rises under backoff when the "
            "whole fleet is unreachable).")
        self._m_interval.set(self._interval)
        # The correctness SLO: a dedicated engine over the verdict
        # counters, ticked by the probe loop itself (probe-scale
        # windows; the user-facing engines are untouched).
        from routest_tpu_torch.obs.slo import build_prober_engine

        self.slo = build_prober_engine(self.config, self.kinds)
        self.slo.on_page.append(self._on_correctness_page)
        register = getattr(self._recorder, "register_slo_engine", None)
        if register is not None:
            register(self.slo)

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self) -> threading.Event:
        if self._stop is not None:
            return self._stop
        self._stop = stop = threading.Event()

        def run() -> None:
            while not stop.wait(self._interval):
                try:
                    self.probe_round()
                except Exception as e:  # never kill the prober loop
                    _log.error("probe_round_failed",
                               error=f"{type(e).__name__}: {e}")

        threading.Thread(target=run, daemon=True,
                         name="blackbox-prober").start()
        _log.info("prober_started", gateway=self.gateway_base,
                  kinds=self.kinds, interval_s=self.config.interval_s,
                  eta_tolerance_min=self.eta_tolerance)
        return stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    # ── the round ─────────────────────────────────────────────────────

    def probe_round(self) -> Dict[str, str]:
        """One synchronous round of every armed probe kind (tests call
        this directly). Returns {kind: verdict}."""
        verdicts: Dict[str, str] = {}
        targets = list(self.targets_fn() or [])
        if self.oracle is not None and not self.oracle.armed:
            for _rid, base in targets:
                if self.oracle.arm(base):
                    break
        verdicts["golden"] = self._checked("golden", self._probe_golden)
        if "route" in self.kinds:
            verdicts["route"] = self._checked(
                "route", lambda: self._probe_route(targets))
        if "matrix" in self.kinds:
            verdicts["matrix"] = self._checked(
                "matrix", lambda: self._probe_matrix(targets))
        if self._dispatch_armed():
            verdicts["dispatch"] = self._checked("dispatch",
                                                 self._probe_dispatch)
        if "wire" in self.kinds:
            verdicts["wire"] = self._checked("wire", self._probe_wire)
        verdicts["fanout"] = self._checked(
            "fanout", lambda: self._probe_fanout(targets))
        self._rounds += 1
        self._m_rounds.inc()
        # Backoff: a round in which NOTHING answered (fleet down)
        # doubles the interval up to the cap; any success resets it.
        if all(v == UNREACHABLE for v in verdicts.values()):
            self._interval = min(self.config.backoff_cap_s,
                                 self._interval * 2)
        else:
            self._interval = max(0.2, self.config.interval_s)
        self._m_interval.set(self._interval)
        self.slo.tick()
        return verdicts

    def _checked(self, kind: str,
                 fn: Callable[[], Tuple[str, Optional[dict]]]) -> str:
        """Run one probe; any non-pass verdict is re-probed once before
        it is recorded — a single timeout/blip under load must not
        start burning a low-rate SLO's budget."""
        verdict, evidence = fn()
        if verdict != PASS:
            verdict, evidence = fn()
        self._record(kind, verdict, evidence)
        return verdict

    def _record(self, kind: str, verdict: str,
                evidence: Optional[dict]) -> None:
        self._m_checks.labels(probe=kind, verdict=verdict).inc()
        if evidence and evidence.get("divergence") is not None \
                and np.isfinite(evidence["divergence"]):
            self._m_divergence.labels(probe=kind).observe(
                float(evidence["divergence"]))
        entry = {"verdict": verdict, "unix": round(time.time(), 3)}
        if evidence:
            entry.update(evidence)
        with self._lock:
            self._state[kind] = entry
            if verdict != PASS:
                self._failures.append({"probe": kind, **entry})
        if verdict != PASS:
            _log.warning("probe_failed", probe=kind, verdict=verdict,
                         **{k: v for k, v in (evidence or {}).items()
                            if k in ("divergence", "tolerance",
                                     "replicas", "error")})

    # ── golden (gateway path) ─────────────────────────────────────────

    def _score_golden(self, base: str, probe: str
                      ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
        body = golden_probe_body()
        payload, headers = _http_json(
            "POST", f"{base}/api/predict_eta_batch", body,
            self.config.timeout_s, probe=probe)
        cols = eta_columns(payload)
        if not cols:
            raise ProbeUnreachable("answer carries no ETA columns")
        return cols, headers

    def _probe_golden(self) -> Tuple[str, Optional[dict]]:
        try:
            got, headers = self._score_golden(self.gateway_base, "golden")
        except ProbeUnreachable as e:
            return UNREACHABLE, {"error": str(e)}
        expected = self._pins.get("golden")
        evidence = {"trace_id": headers.get("x-trace-id")}
        # Which replica answered (the gateway stamps it): a divergent
        # gateway-path verdict names its server.
        replica = headers.get("x-rtpu-replica")
        if replica:
            evidence["replica"] = replica
        if expected is not None:
            div = eta_divergence(expected, got)
            if div is not None:
                evidence.update({
                    "divergence": round(div, 4),
                    "tolerance": self.eta_tolerance,
                    "request": "golden_probe_body()",
                    "served": {k: np.round(v, 4).tolist()
                               for k, v in got.items()},
                    "expected": {k: np.round(v, 4).tolist()
                                 for k, v in expected.items()},
                })
                if div > self.eta_tolerance:
                    if replica:
                        evidence["replicas"] = [replica]
                    return DIVERGENT, evidence
            # else: structural shape change (point↔quantile) — re-arm.
        self._pins["golden"] = got
        return PASS, evidence

    # ── wire parity (both content-types, compared bitwise) ────────────

    def _probe_wire(self) -> Tuple[str, Optional[dict]]:
        """Send the golden batch over BOTH content-types through the
        gateway and compare the answers bitwise (tolerance 0.0 — the
        wire format's contract is exact parity with JSON, not
        closeness). Columns compared: rounded minutes, every quantile
        band, and the completion timestamps. Any divergence pages
        ``correctness:wire``."""
        from routest_tpu_torch.serve.wirecodec import WireError, \
            decode_eta_response

        url = f"{self.gateway_base}/api/predict_eta_batch"
        try:
            json_payload, headers = _http_json(
                "POST", url, golden_probe_body(),
                self.config.timeout_s, probe="wire")
            raw, wire_headers = _http_wire(
                url, golden_wire_frame(), self.config.timeout_s,
                probe="wire")
        except ProbeUnreachable as e:
            return UNREACHABLE, {"error": str(e)}
        evidence: dict = {
            "trace_id": headers.get("x-trace-id"),
            "request": "golden_probe_body() over both content-types",
        }
        replicas = sorted({r for r in (headers.get("x-rtpu-replica"),
                                       wire_headers.get("x-rtpu-replica"))
                           if r})
        if replicas:
            evidence["replicas"] = replicas
        try:
            wire = decode_eta_response(raw)
        except WireError as e:
            # A 200 carrying an undecodable frame is a correctness
            # defect of the wire path itself, not a transport blip.
            evidence["error"] = f"undecodable wire response: {e}"
            return DIVERGENT, evidence
        minutes = np.asarray(wire["minutes"], np.float64)
        finite = np.isfinite(minutes)
        wire_cols = {"eta_minutes_ml":
                     np.where(finite, np.round(minutes, 4), np.nan)}
        for level, vals in wire["bands"].items():
            vals = np.asarray(vals, np.float64)
            ok = finite & np.isfinite(vals)
            wire_cols[f"eta_minutes_ml_{level}"] = \
                np.where(ok, np.round(vals, 4), np.nan)
        json_cols = eta_columns(json_payload)
        mismatched: List[str] = []
        worst = 0.0
        for key in sorted(set(json_cols) | set(wire_cols)):
            a, b = json_cols.get(key), wire_cols.get(key)
            if a is None or b is None or a.shape != b.shape:
                mismatched.append(key)
                worst = float("inf")
                continue
            same = (a == b) | (np.isnan(a) & np.isnan(b))
            if not bool(same.all()):
                mismatched.append(key)
                diffs = np.abs(a - b)[~same]
                gap = float(np.max(diffs)) if np.isfinite(diffs).all() \
                    else float("inf")
                worst = max(worst, gap)
        # Completion instants: the wire epoch-ms column rendered at
        # second precision must match the JSON ISO strings exactly
        # (same float64 truncation by construction).
        iso_all = np.datetime_as_string(
            np.asarray(wire["completion_ms"],
                       np.int64).astype("datetime64[ms]"), unit="s")
        wire_iso = [str(s) if ok else None
                    for s, ok in zip(iso_all, finite)]
        json_iso = json_payload.get("eta_completion_time_ml")
        if wire_iso != json_iso:
            mismatched.append("eta_completion_time_ml")
            worst = max(worst, float("inf"))
        if mismatched:
            evidence.update({
                "divergence": worst,
                "tolerance": 0.0,
                "columns": mismatched,
                "served_json": {k: v.tolist()
                                for k, v in json_cols.items()},
                "served_wire": {k: np.asarray(v).tolist()
                                for k, v in wire_cols.items()},
            })
            return DIVERGENT, evidence
        return PASS, evidence

    # ── route / matrix (oracle or pinned) ─────────────────────────────

    def _oracle_epoch(self, targets) -> Optional[int]:
        """Refresh the oracle at the freshest replica's epoch."""
        if self.oracle is None or not self.oracle.armed:
            return None
        best = None
        for _rid, base in targets:
            epoch = self.oracle.refresh(base)
            if epoch is not None and (best is None or epoch > best):
                best = epoch
        return best

    def _judge_scalar(self, kind: str, served: np.ndarray,
                      expect_fn: Callable[[np.ndarray], np.ndarray],
                      targets, headers: Dict[str, str],
                      request: dict) -> Tuple[str, Optional[dict]]:
        """Compare a served route/matrix answer against the oracle's
        per-epoch candidates (or the pinned answer), at the relative
        tolerance. ``expect_fn`` maps an oracle duration table to the
        served answer's shape."""
        tol = self.config.route_tolerance_rel
        evidence: dict = {"trace_id": headers.get("x-trace-id"),
                          "request": request,
                          "served": np.round(served, 2).tolist()}
        replica = headers.get("x-rtpu-replica")
        if replica:
            evidence["replica"] = replica
        self._oracle_epoch(targets)
        candidates: List[Tuple[Optional[int], np.ndarray]] = []
        if self.oracle is not None and self.oracle.armed:
            candidates = [(e, expect_fn(d))
                          for e, d in self.oracle.candidates()]
        if not candidates:
            # Pinned mode: self-consistency within a metric epoch,
            # re-armed when the fleet's epoch advances.
            fleet_epoch = self._fleet_epoch(targets)
            pinned = self._pins.get(kind)
            if pinned is None or fleet_epoch != self._pin_epoch:
                self._pins[kind] = served
                self._pin_epoch = fleet_epoch
                return PASS, evidence
            candidates = [(self._pin_epoch, pinned)]
        best = None
        for epoch, want in candidates:
            if np.shape(want) != np.shape(served):
                continue
            with np.errstate(invalid="ignore"):
                rel = np.abs(served - want) / np.maximum(np.abs(want), 1.0)
            rel = float(np.nanmax(rel)) if rel.size else 0.0
            if not np.isfinite(rel):
                rel = float("inf")
            if best is None or rel < best[0]:
                best = (rel, epoch, want)
        if best is None:
            return UNREACHABLE, {**evidence,
                                 "error": "no comparable oracle answer"}
        rel, epoch, want = best
        evidence.update({"divergence": round(rel, 6), "tolerance": tol,
                         "oracle": np.round(want, 2).tolist(),
                         "oracle_epoch": epoch})
        if rel > tol:
            if replica:
                evidence["replicas"] = [replica]
            return DIVERGENT, evidence
        if self.oracle is None or not self.oracle.armed:
            self._pins[kind] = served      # ratchet the pin forward
        return PASS, evidence

    def _probe_route(self, targets) -> Tuple[str, Optional[dict]]:
        a, b = self.route_waypoints[0], self.route_waypoints[1]
        body = {
            "source_point": {"lat": a[0], "lon": a[1]},
            "destination_points": [{"lat": b[0], "lon": b[1],
                                    "payload": 1}],
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 1e9,
                               "maximum_distance": 1e9},
            "road_graph": True,
        }
        try:
            payload, headers = _http_json(
                "POST", f"{self.gateway_base}/api/request_route", body,
                self.config.timeout_s, probe="route")
        except ProbeUnreachable as e:
            return UNREACHABLE, {"error": str(e)}
        summary = (payload.get("properties") or {}).get("summary") or {}
        served = np.asarray(float(summary.get("duration") or np.nan))
        return self._judge_scalar(
            "route", served, lambda d: np.asarray(d[0, 1]), targets,
            headers, body)

    def _probe_matrix(self, targets) -> Tuple[str, Optional[dict]]:
        pts = self.route_waypoints
        body = {"points": [{"lat": lat, "lon": lon} for lat, lon in pts],
                "road_graph": True, "vehicle_type": "car"}
        try:
            payload, headers = _http_json(
                "POST", f"{self.gateway_base}/api/matrix", body,
                self.config.timeout_s, probe="matrix")
        except ProbeUnreachable as e:
            return UNREACHABLE, {"error": str(e)}
        rows = payload.get("durations_s")
        if not isinstance(rows, list):
            return UNREACHABLE, {"error": "no durations_s in answer"}
        served = np.asarray([[v if isinstance(v, (int, float)) else np.nan
                              for v in row] for row in rows], np.float64)
        # Off-diagonal only: the diagonal is definitionally 0 served-
        # side while the oracle's carries the doubled snap leg.
        mask = ~np.eye(len(pts), dtype=bool)

        def expect(d: np.ndarray) -> np.ndarray:
            return np.where(mask, d, 0.0)

        return self._judge_scalar(
            "matrix", np.where(mask, served, 0.0), expect, targets,
            headers, body)

    # ── dispatch (host-oracle plan parity) ────────────────────────────

    def _dispatch_armed(self) -> bool:
        """The dispatch probe only runs where dispatch serving is on:
        ``RTPU_DISPATCH=0`` is a deliberate deployment choice (the POST
        answers 503), and probing it anyway would feed sustained
        UNREACHABLE verdicts into the correctness SLO — paging on a
        disabled feature. A fleet that doesn't answer the state GET at
        all is a different story (it may simply be down), so the probe
        still runs and records what it sees."""
        try:
            state, _ = _http_json(
                "GET", f"{self.gateway_base}/api/dispatch", None,
                self.config.timeout_s, probe="dispatch")
        except ProbeUnreachable:
            return True
        return state.get("enabled") is not False

    def dispatch_probe_body(self) -> dict:
        """Seeded matrix-mode ``/api/dispatch`` body: the probe BRINGS
        the cost matrix, so the served plan must hold up against a host
        re-solve of the SAME matrix regardless of live metric state —
        the only check that catches a device solving over silently
        perturbed costs (chaos ``dispatch.solve``). Byte-stable across
        rounds (fixed seed): any divergence is the server's."""
        rng = np.random.default_rng(20260)
        n = 8
        pts = rng.random((n + 1, 2)) * 60.0
        m = np.round(np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)), 3)
        demands = rng.integers(1, 4, n)
        return {"matrix": m.tolist(),
                "demands": [float(d) for d in demands],
                "capacity": 6.0, "max_distance": 400.0}

    def _probe_dispatch(self) -> Tuple[str, Optional[dict]]:
        from routest_tpu_torch.dispatch import plan_cost
        from routest_tpu_torch.optimize.vrp import solve_host_dispatch

        body = self.dispatch_probe_body()
        try:
            payload, headers = _http_json(
                "POST", f"{self.gateway_base}/api/dispatch", body,
                self.config.timeout_s, probe="dispatch")
        except ProbeUnreachable as e:
            return UNREACHABLE, {"error": str(e)}
        plan = payload.get("plan")
        if not isinstance(plan, dict):
            return UNREACHABLE, {"error": "no plan in answer"}
        m = np.asarray(body["matrix"], np.float32)
        # The oracle solves on the host: the prober lives in the gateway
        # or front process, which holds no CUDA context, and an oracle
        # off the card is independent of the device it judges.
        oracle = solve_host_dispatch(
            m, np.asarray(body["demands"], np.float32),
            body["capacity"], body["max_distance"], device="cpu")
        expected = float(plan_cost(m, oracle))
        try:
            served = float(plan_cost(m, plan))
            served_stops = sorted(
                [int(i) for i in (plan.get("optimized_order") or [])]
                + [int(i) for i in (plan.get("spill_lane") or [])])
        except (TypeError, ValueError, IndexError):
            return UNREACHABLE, {"error": "malformed plan in answer"}
        oracle_stops = sorted(oracle["optimized_order"]
                              + oracle["spill_lane"])
        # Judged on COST under the true matrix, not on order bytes: a
        # different order at equal cost is an equally good plan, while
        # a skewed solve prices its plan over the wrong world and lands
        # measurably worse here.
        div = abs(served - expected) / max(abs(expected), 1e-9)
        tol = max(self.config.route_tolerance_rel, 1e-6)
        evidence = {"divergence": round(div, 6), "tolerance": tol,
                    "served_cost": round(served, 3),
                    "expected_cost": round(expected, 3),
                    "trace_id": headers.get("x-trace-id")}
        if served_stops != oracle_stops or div > tol:
            evidence["served_plan"] = plan.get("trips")
            evidence["expected_plan"] = oracle["trips"]
            return DIVERGENT, evidence
        return PASS, evidence

    # ── fan-out consistency ───────────────────────────────────────────

    def _fleet_epoch(self, targets) -> Optional[int]:
        best = None
        for _rid, base in targets:
            try:
                live, _ = _http_json("GET", f"{base}/api/live", None,
                                     self.config.timeout_s, probe="fanout")
            except ProbeUnreachable:
                continue
            if live.get("enabled") is False:
                continue
            epoch = live.get("epoch")
            if isinstance(epoch, int) and (best is None or epoch > best):
                best = epoch
        return best

    def _probe_fanout(self, targets) -> Tuple[str, Optional[dict]]:
        if not targets:
            return UNREACHABLE, {"error": "no replicas registered"}
        per: Dict[str, dict] = {}
        reached = 0
        for rid, base in targets:
            entry: dict = {}
            try:
                version, _ = _http_json("GET", f"{base}/api/version",
                                        None, self.config.timeout_s,
                                        probe="fanout")
                entry["fingerprint"] = \
                    (version.get("model") or {}).get("fingerprint")
                entry["generation"] = \
                    (version.get("model") or {}).get("generation")
                try:
                    live, _ = _http_json("GET", f"{base}/api/live", None,
                                         self.config.timeout_s,
                                         probe="fanout")
                    if live.get("enabled") is not False and \
                            isinstance(live.get("epoch"), int):
                        entry["epoch"] = live["epoch"]
                except ProbeUnreachable:
                    pass           # live surface down ≠ replica down
                got, ghdrs = self._score_golden(base, "fanout")
                entry["trace_id"] = ghdrs.get("x-trace-id")
                expected = self._pins.get("golden")
                if expected is not None:
                    div = eta_divergence(expected, got)
                    if div is not None:
                        entry["divergence"] = round(div, 4)
                        entry["served"] = {
                            k: np.round(v, 4).tolist()
                            for k, v in got.items()}
                reached += 1
            except ProbeUnreachable as e:
                entry["error"] = str(e)
            per[rid] = entry
        if reached == 0:
            return UNREACHABLE, {"error": "every replica unreachable",
                                 "replicas": sorted(per)}
        # Answer divergence names its replica immediately (no debounce:
        # an answer beyond the swap-gate margin is wrong NOW).
        divergent = sorted(
            rid for rid, e in per.items()
            if e.get("divergence") is not None
            and e["divergence"] > self.eta_tolerance)
        if divergent:
            worst = max(per[r]["divergence"] for r in divergent)
            expected = self._pins.get("golden") or {}
            return DIVERGENT, {
                "replicas": divergent,
                "divergence": worst,
                "tolerance": self.eta_tolerance,
                "request": "golden_probe_body()",
                "served": {r: per[r].get("served") for r in divergent},
                "expected": {k: np.round(v, 4).tolist()
                             for k, v in expected.items()},
                "per_replica": _thin(per),
            }
        # Skew dimensions, each debounced over skew_after rounds.
        offenders: Dict[str, List[str]] = {}
        if self.config.fanout_reach:
            # Reachability as a named dimension (cross-region mode): a
            # target that answered nothing while the rest of the
            # fan-out set did is an offender — at region scope that is
            # a dead region, and it must page BY NAME rather than ride
            # silently in the per-target evidence.
            unreached = sorted(r for r, e in per.items() if "error" in e)
            if unreached:
                offenders["reach"] = unreached
        epochs = {r: e["epoch"] for r, e in per.items() if "epoch" in e}
        if len(epochs) >= 2:
            top = max(epochs.values())
            lag = sorted(r for r, ep in epochs.items()
                         if top - ep >= self.config.epoch_gap)
            if lag:
                offenders["epoch"] = lag
        prints = {r: e["fingerprint"] for r, e in per.items()
                  if e.get("fingerprint")}
        if len(set(prints.values())) > 1:
            # The minority fingerprint(s) are the suspects; on a tie
            # every replica is listed (the evidence carries all of
            # them either way).
            counts: Dict[str, int] = {}
            for fp in prints.values():
                counts[fp] = counts.get(fp, 0) + 1
            majority = max(counts.values())
            off = sorted(r for r, fp in prints.items()
                         if counts[fp] < majority) or sorted(prints)
            offenders["model"] = off
        verdict = PASS
        evidence: dict = {"per_replica": _thin(per)}
        dims = ("epoch", "model", "reach") if self.config.fanout_reach \
            else ("epoch", "model")
        for dim in dims:
            if dim in offenders:
                self._skew_rounds[dim] = self._skew_rounds.get(dim, 0) + 1
                self._skew_offenders[dim] = offenders[dim]
            else:
                self._skew_rounds[dim] = 0
                self._skew_offenders[dim] = []
            persisted = self._skew_rounds[dim] >= self.config.skew_after
            for rid, _base in targets:
                self._m_skew.labels(replica=rid, dimension=dim).set(
                    1.0 if persisted and rid in offenders.get(dim, [])
                    else 0.0)
            if persisted:
                verdict = SKEW
                detail = {"epochs": epochs} if dim == "epoch" else \
                    {"errors": {r: per[r].get("error")
                                for r in offenders[dim]}} \
                    if dim == "reach" else {"fingerprints": prints}
                evidence.setdefault("dimensions", {})[dim] = {
                    "replicas": offenders[dim],
                    "rounds": self._skew_rounds[dim],
                    **detail,
                }
        if verdict == SKEW:
            evidence["replicas"] = sorted(
                {r for d in evidence["dimensions"].values()
                 for r in d["replicas"]})
            # The probe/oracle pair for a skew verdict: what each
            # replica SERVED (its epoch / model identity) vs what the
            # fleet consensus says it SHOULD be.
            evidence["request"] = ("fanout: GET /api/version + "
                                   "GET /api/live + golden_probe_body()")
            evidence["served"] = {
                rid: {k: e.get(k)
                      for k in ("epoch", "fingerprint", "generation")
                      if k in e}
                for rid, e in per.items()}
            expected: dict = {}
            if epochs:
                expected["epoch"] = max(epochs.values())
            if prints:
                expected["fingerprint"] = max(
                    set(prints.values()),
                    key=lambda fp: sum(1 for v in prints.values()
                                       if v == fp))
            evidence["expected"] = expected
        return verdict, evidence

    # ── correctness page → evidence bundle ────────────────────────────

    def _on_correctness_page(self, slo_name: str, detail: dict) -> None:
        kind = detail.get("probe")
        with self._lock:
            failures = [dict(f) for f in self._failures
                        if kind is None or f.get("probe") == kind][-5:]
        replicas = sorted({r for f in failures
                           for r in (f.get("replicas") or [])})
        bundle_detail = {"slo": slo_name, **detail}
        if replicas:
            bundle_detail["replicas"] = replicas
        evidence = {"probe": kind, "replicas": replicas,
                    "failures": failures,
                    "tolerance_eta_min": self.eta_tolerance,
                    "tolerance_route_rel": self.config.route_tolerance_rel}
        path = self._recorder.trigger(
            "correctness_page", bundle_detail, force=True,
            extra_files={"probe_evidence.json": json.dumps(
                evidence, indent=2, default=str)})
        _log.error("correctness_page", slo=slo_name, probe=kind,
                   replicas=replicas, bundle=path)

    # ── introspection ─────────────────────────────────────────────────

    def snapshot(self) -> dict:
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
            failures = [dict(f) for f in self._failures]
        return {
            "enabled": self.config.enabled,
            "kinds": self.kinds,
            "rounds": self._rounds,
            "interval_s": self._interval,
            "eta_tolerance_min": self.eta_tolerance,
            "route_tolerance_rel": self.config.route_tolerance_rel,
            "oracle_armed": bool(self.oracle is not None
                                 and self.oracle.armed),
            "probes": {k: {kk: vv for kk, vv in v.items()
                           if kk not in ("served", "expected", "oracle",
                                         "request")}
                       for k, v in state.items()},
            "recent_failures": len(failures),
            "slo": self.slo.snapshot(),
        }


def _thin(per: Dict[str, dict]) -> Dict[str, dict]:
    """Per-replica evidence without the bulky served vectors."""
    return {rid: {k: v for k, v in e.items() if k != "served"}
            for rid, e in per.items()}
