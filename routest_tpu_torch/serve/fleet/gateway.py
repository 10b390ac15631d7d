"""Health-aware HTTP gateway: routing, admission control, tail hedging.

The counterpart of ``routest_tpu/serve/fleet/gateway.py``, in front of
replicas of ``python -m routest_tpu_torch.serve``. Pure stdlib
(``http.server`` + ``http.client``), consistent with the serving
layer's no-framework bent. One handler thread per connection; every
proxied request flows through three stages:

1. **Admission** — a bounded queue: at most ``max_inflight`` requests
   proxy concurrently, at most ``queue_depth`` more wait, and a waiter
   whose deadline (``X-Deadline-Ms`` header, default
   ``FleetConfig.deadline_ms``) would pass sheds immediately. Shed =
   429 + ``Retry-After`` — overload degrades to fast rejections, never
   collapse (the Tail-at-Scale prescription).
2. **Routing** — capacity-weighted least-outstanding across replicas
   whose circuit breaker is closed: outstanding requests are
   normalized by each replica's advertised capacity units (its
   placement slice's chips / predicted throughput), so a 4-chip mesh
   replica draws ~4× the concurrent work of a 1-chip peer. ``eject_after`` consecutive failures
   (connect errors or 5xx) open a replica's breaker for ``cooldown_s``;
   after cooldown exactly one half-open probe request decides between
   close and re-open. Idempotent requests that die on a connection
   error retry once on a different replica.
3. **Hedging** (optional) — idempotent predict reads still in flight
   after the fleet's observed p95 (floored at ``hedge_min_ms``) send a
   second copy to another replica; first response wins.

``/api/metrics`` is answered by the gateway itself with fleet
aggregates (inflight, queue depth, sheds, retries, hedges, ejections,
per-replica latency quantiles + supervisor restart counts) in JSON or
Prometheus text, same ``?format=prometheus`` convention as the worker
metrics endpoint.

The blackbox prober (``obs/prober.py``) is not ported yet (ROADMAP
Queue A item 10, part b): ``/api/probes`` answers ``{"enabled":
false}`` as the JAX gateway does without one, and :meth:`Gateway.serve`
refuses ``RTPU_PROBER=1``.
"""

from __future__ import annotations

import http.client
import http.server
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from routest_tpu_torch.core.config import FleetConfig
from routest_tpu_torch.obs import (get_registry, register_build_info,
                             to_chrome_trace)
from routest_tpu_torch.obs.trace import (REQUEST_ID_RE, get_tracer,
                                   mint_request_id, parse_traceparent,
                                   trace_span)
from routest_tpu_torch.utils.logging import get_logger
from routest_tpu_torch.utils.profiling import RequestStats

_log = get_logger("routest_tpu_torch.fleet.gateway")

# Idempotent pure-compute POST paths: safe to retry on connection death
# and to hedge (nothing persists; same body → same answer). optimize_
# route and the auth/tracker endpoints mutate state and are excluded.
_IDEMPOTENT_POST = {
    "/api/predict_eta", "/api/predict_eta_batch", "/api/predict",
    "/api/matrix", "/api/request_route",
}
# Hop-by-hop headers (RFC 7230 §6.1) never forwarded either direction.
_HOP_HEADERS = {"connection", "keep-alive", "proxy-authenticate",
                "proxy-authorization", "te", "trailer",
                "transfer-encoding", "upgrade"}
# Paths that may ride the persistent binary wire channel when the
# request body is a wire frame (content-type negotiated; docs/API.md
# "Binary wire format"). A channel failure falls back to a normal HTTP
# forward of the same frame — the replica negotiates by content-type
# either way.
_WIRE_PATHS = {"/api/predict_eta_batch", "/api/matrix"}
_WIRE_CONTENT_TYPE = "application/x-rtpu-wire"

# Bounded route-label vocabulary for the gateway's per-route metric
# families (the SLO engine's rollup source). Anything else — including
# attacker-chosen paths — folds into "other" so label cardinality
# cannot be driven from the wire.
_ROUTE_LABELS = _IDEMPOTENT_POST | {
    "/api/optimize_route", "/api/optimize_route_batch", "/api/history",
    "/api/update_tracker", "/api/confirm_route", "/api/dispatch",
    "/api/health", "/api/locations", "/api/ping", "/api/version", "/up",
}


def _route_label(bare: str) -> str:
    if bare in _ROUTE_LABELS:
        return bare
    if bare.startswith("/api/history/"):
        return "/api/history/<id>"
    return "other"

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

# Pre-encoded bodies for the fixed error responses: the admission/shed
# path exists to be CHEAP under overload, so it must not pay a fresh
# json.dumps per rejection.
_CT_JSON = ("Content-Type", "application/json")
_BODY_SATURATED = json.dumps(
    {"error": "fleet saturated; retry later"}).encode()
_BODY_DRAINING = json.dumps({"error": "gateway draining"}).encode()
_BODY_NO_REPLICA = json.dumps({"error": "no healthy replica"}).encode()
_BODY_UPSTREAM_FAILED = json.dumps(
    {"error": "upstream connection failed"}).encode()
_BODY_UPSTREAM_TIMEOUT = json.dumps({"error": "upstream timeout"}).encode()


def _tag_replica(rh: List, rid: str) -> None:
    """Stamp which replica answered: ``X-RTPU-Replica`` (the documented
    correlation header) plus the older ``X-Fleet-Replica`` name for
    back-compat with existing dashboards/tests."""
    rh.append(("X-Fleet-Replica", rid))
    rh.append(("X-RTPU-Replica", rid))


def _fresh_conn(host: str, port: int,
                timeout: float) -> http.client.HTTPConnection:
    """Connected upstream connection with TCP_NODELAY — headers and
    body go out as separate small writes, and Nagle + delayed ACK turns
    that into a flat ~40 ms per proxied request otherwise."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


class _Upstream:
    """One replica as the gateway sees it: outstanding-request gauge,
    circuit breaker, connection pool, counters."""

    def __init__(self, rid: str, host: str, port: int,
                 version: Optional[str] = None,
                 chips: int = 1, capacity: Optional[float] = None) -> None:
        self.id = rid
        self.host = host
        self.port = port
        # Version label (rollout/canary cohort identity): stamps the
        # version-labeled per-route request families so canary and
        # baseline are separately observable. None = "unversioned".
        self.version = version
        # Topology: how many chips this replica's slice owns, and its
        # capacity units (predicted throughput normalized to a 1-chip
        # replica — the placement plan's number, or simply ``chips``).
        # ``_pick`` normalizes outstanding by capacity so a 4-chip
        # replica absorbs ~4× the work before it looks as loaded as a
        # 1-chip peer.
        self.chips = max(1, int(chips))
        self.capacity = float(capacity) if capacity and capacity > 0 \
            else float(self.chips)
        # Draining: scheduled for removal — excluded from routing while
        # outstanding requests finish (dynamic membership, see
        # Gateway.remove_replica).
        self.draining = False
        self.outstanding = 0
        self.consecutive_failures = 0
        self.state = CLOSED
        self.opened_at = 0.0
        self.probe_inflight = False
        self.requests = 0
        self.errors = 0
        self.ejections = 0
        self._pool: List[http.client.HTTPConnection] = []

    @property
    def base(self) -> str:
        return f"http://{self.host}:{self.port}"

    def get_conn(self, timeout: float) -> Tuple[http.client.HTTPConnection,
                                                bool]:
        """→ (connection, was_pooled). Pooled keep-alive connections may
        have been closed by the replica since; callers retry those once
        on a fresh connection before charging the breaker."""
        if self._pool:
            conn = self._pool.pop()
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return conn, True
        return _fresh_conn(self.host, self.port, timeout), False

    def put_conn(self, conn: http.client.HTTPConnection) -> None:
        if len(self._pool) < 8:
            self._pool.append(conn)
        else:
            conn.close()

    def drop_conns(self) -> None:
        while self._pool:
            self._pool.pop().close()


class Gateway:
    def __init__(self, targets: Sequence[Tuple[str, int]],
                 config: Optional[FleetConfig] = None,
                 supervisor=None, version: Optional[str] = None) -> None:
        self.config = config or FleetConfig()
        # Region label (multi-region deployments, ``RTPU_REGION``):
        # stamped on every rollup this gateway merges so frames/rows
        # from two gateways never collide replica names downstream.
        self.region = self.config.region or ""
        self.supervisor = supervisor
        self.replicas = [_Upstream(f"r{i}", host, port, version=version)
                         for i, (host, port) in enumerate(targets)]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._rr = 0                       # round-robin tie-breaker
        self._inflight = 0
        self._waiters = 0
        self.shed_count = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.draining = False
        self.started = time.time()
        # Per-replica latency histograms, keyed by replica id (the same
        # unified metric types the serving layer records into).
        self.stats = RequestStats()
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        # Unified-registry mirrors of the fleet aggregates, so one
        # Prometheus scrape of the gateway sees admission + routing +
        # hedging through the same exposition path as every other layer.
        reg = get_registry()
        self._m_shed = reg.counter(
            "rtpu_gateway_sheds_total", "Requests shed by admission (429).")
        self._m_retries = reg.counter(
            "rtpu_gateway_retries_total",
            "Idempotent retries after transport failure.")
        self._m_hedges = reg.counter(
            "rtpu_gateway_hedges_total", "Hedge copies sent.")
        self._m_hedge_wins = reg.counter(
            "rtpu_gateway_hedge_wins_total", "Hedge copies that won.")
        self._m_upstream = reg.histogram(
            "rtpu_gateway_upstream_seconds",
            "Proxied exchange latency by replica.", ("replica",))
        self._m_admit_wait = reg.histogram(
            "rtpu_gateway_admit_wait_seconds",
            "Time spent queued in admission control.")
        # Per-route request families: what the client actually saw from
        # the fleet (post-admission, post-retry/hedge) — the gateway SLO
        # engine's rollup source, and until now a blind spot (only
        # per-replica upstream latency existed).
        self._m_requests = reg.histogram(
            "rtpu_gateway_request_seconds",
            "Gateway request latency by route (client-observed).",
            ("route",))
        self._m_request_errors = reg.counter(
            "rtpu_gateway_request_errors_total",
            "Gateway responses with status >= 500, by route.", ("route",))
        # Version-labeled per-route families: the SAME client-observed
        # measurements as above, additionally keyed by the serving
        # version of the replica that answered — the rollout
        # controller's canary-vs-baseline comparison source. Kept
        # separate from the unversioned families so the gateway SLO
        # engine's rollups (and their dashboards) are untouched by
        # rollouts. Label cardinality is operator-bounded: versions
        # exist only when a rollout names one.
        self._m_vrequests = reg.histogram(
            "rtpu_gateway_version_request_seconds",
            "Gateway request latency by route and serving version "
            "(replica-answered requests only).", ("route", "version"))
        self._m_vrequest_errors = reg.counter(
            "rtpu_gateway_version_request_errors_total",
            "Gateway responses with status >= 500, by route and "
            "serving version.", ("route", "version"))
        # Probe traffic (X-RTPU-Probe) is diverted HERE instead of the
        # per-route request families above — the exclusion happens
        # before any SLO rollup, so synthetic probe load can never
        # burn user error budget (docs/OBSERVABILITY.md "Synthetic
        # probing & correctness SLOs").
        self._m_probe_requests = reg.counter(
            "rtpu_probe_gateway_requests_total",
            "Probe-tagged requests handled by the gateway (excluded "
            "from the user per-route request families), by route.",
            ("route",))
        self._m_replicas = reg.gauge(
            "rtpu_fleet_replicas",
            "Replicas registered with the gateway (draining excluded).")
        self._m_replicas.set(len(self.replicas))
        # Total capacity units across non-draining replicas: what the
        # autoscaler's pressure signals normalize by — a fleet of one
        # 4-chip replica reads 4.0, not 1.0.
        self._m_capacity = reg.gauge(
            "rtpu_fleet_capacity_units",
            "Sum of replica capacity units (1-chip-replica equivalents) "
            "registered with the gateway, draining excluded.")
        self._m_capacity.set(sum(r.capacity for r in self.replicas))
        self._m_canary_fraction = reg.gauge(
            "rtpu_gateway_canary_fraction",
            "Traffic fraction routed to the canary cohort (0 = none).")
        self._next_rid = len(self.replicas)  # monotonic fallback namer
        # rid → version label, append-only (a drained replica's id never
        # comes back, and late responses must still attribute to the
        # version that served them).
        self._version_by_rid: Dict[str, Optional[str]] = {
            r.id: r.version for r in self.replicas}
        # Canary routing state (set_canary/clear_canary): while a
        # rollout bakes, ``_pick`` splits traffic between the canary
        # and baseline cohorts by an exact credit counter.
        self._canary_rids: frozenset = frozenset()
        self._canary_fraction = 0.0
        self._canary_credit = 0.0
        # Attached by serve/fleet/autoscaler.py when scaling is on; the
        # /api/autoscale endpoint reads it.
        self.autoscaler = None
        # Attached by serve/fleet/rollout.py; /api/rollout reads it and
        # the autoscaler holds while it is active.
        self.rollout = None
        register_build_info()
        # SLO engine over the per-route families above; the ticker
        # starts with serve() (a Gateway constructed for one handle()
        # call in tests shouldn't spawn threads).
        from routest_tpu_torch.obs.recorder import get_recorder
        from routest_tpu_torch.obs.slo import build_gateway_engine

        self._recorder = get_recorder()
        # Change ledger (docs/OBSERVABILITY.md "Change ledger &
        # incident correlation"): the gateway process records its own
        # state changes (rollout phases, autoscale actions, placement)
        # and serves the fleet-merged /api/changes; registering it on
        # the recorder makes every gateway page carry suspects.json.
        from routest_tpu_torch.obs.ledger import get_change_ledger

        self.change_ledger = get_change_ledger()
        if self.change_ledger.enabled:
            self._recorder.register_change_ledger(self.change_ledger)
        self.slo = None
        from routest_tpu_torch.core.config import load_slo_config

        slo_cfg = load_slo_config()
        if slo_cfg.enabled:
            self.slo = build_gateway_engine(slo_cfg)
            self.slo.on_page.append(self._recorder.on_slo_page)
            self._recorder.register_slo_engine(self.slo)
        # Metric timeline (docs/OBSERVABILITY.md "Metric timeline"):
        # the gateway keeps its own registry history (client-observed
        # per-route latency, admission, hedges) AND scrapes each
        # upstream's /api/timeline into per-replica / per-version /
        # fleet-rollup views. Built here, armed in serve() — a Gateway
        # constructed for one handle() call must not spawn threads.
        self.timeline = None
        self.fleet_timeline = None
        self.watcher = None
        # Binary wire channel (docs/API.md "Binary wire format"): when
        # RTPU_WIRE=1 + RTPU_WIRE_CHANNEL, wire-content-type requests
        # to the wire paths ride a persistent multiplexed channel per
        # replica instead of an HTTP exchange. Clients are created
        # lazily per replica and dropped on deregistration; every
        # channel failure falls back to the HTTP path above, so the
        # channel can only ever make things faster, not less available.
        from routest_tpu_torch.core.config import load_wire_config

        self._wire_cfg = load_wire_config()
        self._wire_clients: Dict[str, object] = {}
        self._wire_lock = threading.Lock()

    # ── admission control ─────────────────────────────────────────────

    def _admit(self, deadline: float) -> Tuple[bool, int]:
        """→ (admitted, status). Sheds with 429 when the queue is full
        or the deadline would pass while queued; 503 while draining."""
        cfg = self.config
        with self._cond:
            if self.draining:
                return False, 503
            if self._inflight < cfg.max_inflight:
                self._inflight += 1
                return True, 0
            if self._waiters >= cfg.queue_depth:
                self.shed_count += 1
                self._m_shed.inc()
                return False, 429
            self._waiters += 1
            try:
                while True:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        self.shed_count += 1
                        self._m_shed.inc()
                        return False, 429
                    if self.draining:
                        return False, 503
                    if self._inflight < cfg.max_inflight:
                        self._inflight += 1
                        return True, 0
                    self._cond.wait(min(remaining, 0.1))
            finally:
                self._waiters -= 1

    def _release(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify()

    # ── dynamic membership ────────────────────────────────────────────

    def add_replica(self, host: str, port: int,
                    rid: Optional[str] = None,
                    version: Optional[str] = None,
                    chips: int = 1,
                    capacity: Optional[float] = None) -> str:
        """Register one more upstream at runtime. The newcomer enters
        in the HALF_OPEN breaker state — the same path a recovered
        replica takes: ``_pick`` hands it exactly ONE probe request,
        and only a success admits it to normal rotation, so a worker
        that answered its startup probe but wedges on real traffic
        never absorbs a burst. ``chips``/``capacity`` advertise the
        replica's slice (the placement plan's numbers, passed through
        by the autoscaler/rollout joins) so weighted routing and the
        capacity gauge see it from the first pick. Returns the
        replica id."""
        with self._lock:
            if rid is None:
                rid = f"r{self._next_rid}"
                self._next_rid += 1
            elif rid.startswith("r") and rid[1:].isdigit():
                self._next_rid = max(self._next_rid, int(rid[1:]) + 1)
            if any(r.id == rid for r in self.replicas):
                raise ValueError(f"replica id {rid!r} already registered")
            up = _Upstream(rid, host, port, version=version,
                           chips=chips, capacity=capacity)
            up.state = HALF_OPEN
            up.opened_at = time.time()
            self.replicas.append(up)
            self._version_by_rid[rid] = version
            live = sum(1 for r in self.replicas if not r.draining)
            cap = sum(r.capacity for r in self.replicas if not r.draining)
        self._m_replicas.set(live)
        self._m_capacity.set(cap)
        _log.info("replica_registered", replica=rid, host=host, port=port,
                  version=version, chips=chips, capacity=up.capacity,
                  replicas=live)
        return rid

    def set_topology(self, rid: str, chips: Optional[int] = None,
                     capacity: Optional[float] = None) -> bool:
        """Update one upstream's advertised slice after registration
        (the fleet boot path: the Gateway is constructed from bare
        (host, port) targets, then each replica's placement slice is
        stamped here; a startup probe that measures real preds/s can
        refine ``capacity`` the same way). Returns False for an
        unknown id."""
        with self._lock:
            up = next((r for r in self.replicas if r.id == rid), None)
            if up is None:
                return False
            if chips is not None:
                up.chips = max(1, int(chips))
            if capacity is not None and capacity > 0:
                up.capacity = float(capacity)
            elif chips is not None and capacity is None:
                up.capacity = float(up.chips)
            cap = sum(r.capacity for r in self.replicas if not r.draining)
        self._m_capacity.set(cap)
        return True

    # ── canary routing ────────────────────────────────────────────────

    def set_canary(self, rids, fraction: float) -> None:
        """Route ``fraction`` of picks to the ``rids`` cohort (the
        rollout controller's bake phase). The split is an exact credit
        counter, not a probability draw — 0.25 means every 4th pick,
        deterministically, so a short bake still offers the canary a
        predictable sample and the blast radius of a bad version is
        bounded to the fraction by construction."""
        fraction = min(1.0, max(0.0, float(fraction)))
        with self._lock:
            self._canary_rids = frozenset(rids)
            self._canary_fraction = fraction
            self._canary_credit = 0.0
        self._m_canary_fraction.set(fraction)
        _log.info("canary_routing_set", rids=sorted(self._canary_rids),
                  fraction=fraction)

    def clear_canary(self) -> None:
        with self._lock:
            was = bool(self._canary_rids)
            self._canary_rids = frozenset()
            self._canary_fraction = 0.0
            self._canary_credit = 0.0
        self._m_canary_fraction.set(0.0)
        if was:
            _log.info("canary_routing_cleared")

    def remove_replica(self, rid: str, timeout: float = 15.0) -> bool:
        """Deregister an upstream, draining first: the replica stops
        receiving new picks immediately, outstanding requests get up to
        ``timeout`` seconds to finish, then it is dropped (its pooled
        connections closed). Returns False for an unknown id. Inflight
        work past the timeout is abandoned to its own fate — the
        response still flows (the socket lives until ``_forward_once``
        returns); only the bookkeeping entry is gone."""
        with self._lock:
            up = next((r for r in self.replicas if r.id == rid), None)
            if up is None:
                return False
            up.draining = True
            live = sum(1 for r in self.replicas if not r.draining)
            cap = sum(r.capacity for r in self.replicas if not r.draining)
        self._m_replicas.set(live)
        self._m_capacity.set(cap)
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if up.outstanding <= 0:
                    break
            time.sleep(0.05)
        with self._lock:
            drained = up.outstanding <= 0
            self.replicas = [r for r in self.replicas if r.id != rid]
        up.drop_conns()
        with self._wire_lock:
            wire_client = self._wire_clients.pop(rid, None)
        if wire_client is not None:
            wire_client.close()
        _log.info("replica_deregistered", replica=rid, drained=drained)
        return True

    # ── routing + circuit breaker ─────────────────────────────────────

    def _pick(self, exclude: Tuple[str, ...] = ()) -> Optional[_Upstream]:
        now = time.time()
        with self._lock:
            candidates = []
            probe_gated = []
            for r in self.replicas:
                if r.id in exclude or r.draining:
                    continue
                if r.state == OPEN:
                    if now - r.opened_at >= self.config.cooldown_s:
                        r.state = HALF_OPEN       # cooled: allow one probe
                    else:
                        continue
                if r.state == HALF_OPEN and r.probe_inflight:
                    probe_gated.append(r)
                    continue
                candidates.append(r)
            if not candidates:
                # Last resort: a half-open replica whose probe is still
                # in flight is ALIVE, merely rationed to one request —
                # when it is the only replica left (a 2-replica rolling
                # restart drains the baseline moments after the
                # successor joins), serving it concurrent traffic beats
                # a 503. Breaker-OPEN replicas stay excluded: those are
                # evidence-sick, not merely unproven.
                if not probe_gated:
                    return None
                candidates = probe_gated
            # Canary split: when both cohorts can serve, the credit
            # counter sends exactly the configured fraction of picks to
            # the canary set (retries/hedges that excluded every member
            # of one cohort fall through to the other naturally).
            if self._canary_rids and self._canary_fraction > 0.0:
                canary = [r for r in candidates
                          if r.id in self._canary_rids]
                baseline = [r for r in candidates
                            if r.id not in self._canary_rids]
                if canary and baseline:
                    self._canary_credit += self._canary_fraction
                    if self._canary_credit >= 1.0:
                        self._canary_credit -= 1.0
                        candidates = canary
                    else:
                        candidates = baseline
            self._rr += 1
            # A half-open replica that is due its probe takes priority
            # for exactly ONE request (probe_inflight gates the rest) —
            # otherwise a recovered replica starves behind its closed
            # peers and never re-joins. Everything else: WEIGHTED least
            # outstanding — outstanding normalized by capacity units,
            # so a 4-chip replica absorbs ~4× the concurrent work of a
            # 1-chip peer before looking equally loaded — round-robin
            # tie-break.
            chosen = next((r for r in candidates if r.state == HALF_OPEN),
                          None)
            if chosen is None:
                chosen = min(
                    candidates,
                    key=lambda r: (r.outstanding / r.capacity,
                                   (self.replicas.index(r) - self._rr)
                                   % len(self.replicas)))
            chosen.outstanding += 1
            chosen.requests += 1
            if chosen.state == HALF_OPEN:
                chosen.probe_inflight = True
            return chosen

    def _complete(self, r: _Upstream, ok: bool, seconds: float) -> None:
        self.stats.add(r.id, seconds, error=not ok)
        self._m_upstream.labels(replica=r.id).observe(seconds)
        with self._lock:
            r.outstanding -= 1
            if r.state == HALF_OPEN:
                r.probe_inflight = False
            if ok:
                r.consecutive_failures = 0
                if r.state in (HALF_OPEN, OPEN):
                    r.state = CLOSED
                    _log.info("breaker_closed", replica=r.id)
                return
            r.errors += 1
            r.consecutive_failures += 1
            if r.state == HALF_OPEN:
                r.state = OPEN                     # failed probe: re-open
                r.opened_at = time.time()
                r.drop_conns()
                _log.warning("breaker_reopened", replica=r.id)
            elif (r.state == CLOSED
                  and r.consecutive_failures >= self.config.eject_after):
                r.state = OPEN
                r.opened_at = time.time()
                r.ejections += 1
                r.drop_conns()
                _log.warning("breaker_opened", replica=r.id,
                             failures=r.consecutive_failures)

    # ── proxying ──────────────────────────────────────────────────────

    def _forward_once(self, r: _Upstream, method: str, path: str,
                      body: Optional[bytes], headers: Dict[str, str],
                      timeout: float, parent=None, slot: str = "primary",
                      deadline: Optional[float] = None):
        """→ (status, headers, body) or raises OSError/HTTPException.
        Counts the exchange into the replica's breaker + stats. The
        forward span parents under ``parent`` when given (hedge copies
        run on worker threads, where the ambient context doesn't
        follow), else under the ambient span; its context is what gets
        injected as ``traceparent`` on the upstream hop.

        ``deadline`` (wall-clock) is re-stamped as the REMAINING budget
        in ``X-Deadline-Ms`` at send time — each hop (retry and hedge
        included) carries what is actually left, not what the client
        originally asked for, so the replica can refuse doomed work."""
        from routest_tpu_torch.chaos import inject as chaos_inject
        from routest_tpu_torch.obs.trace import CURRENT

        with trace_span("gateway.forward",
                        parent=parent if parent is not None else CURRENT,
                        replica=r.id, slot=slot) as fspan:
            headers = dict(headers)
            if deadline is not None:
                remaining_ms = max(1, int((deadline - time.time()) * 1000))
                headers["X-Deadline-Ms"] = str(remaining_ms)
                fspan.set_attr("deadline_ms", remaining_ms)
            if fspan.ctx is not None:
                get_tracer().inject(headers)
            t0 = time.perf_counter()
            conn = None
            pooled = False
            try:
                try:
                    # Chaos fault points: generic + per-replica (so a
                    # spec can slow or drop exactly one replica's hops).
                    # A drop raises ConnectionError → the normal
                    # transport-failure path: breaker charge, retry.
                    chaos_inject("gateway.forward")
                    chaos_inject(f"gateway.forward.{r.id}")
                    conn, pooled = r.get_conn(timeout)
                    conn.request(method, path, body=body, headers=headers)
                    resp = conn.getresponse()
                except (http.client.HTTPException, OSError):
                    if conn is not None:
                        conn.close()
                    if not pooled:
                        raise
                    # Stale keep-alive, not a sick replica: one fresh try.
                    conn = _fresh_conn(r.host, r.port, timeout)
                    conn.request(method, path, body=body, headers=headers)
                    resp = conn.getresponse()
                data = resp.read()
                resp_headers = [(k, v) for k, v in resp.getheaders()
                                if k.lower() not in _HOP_HEADERS]
                status = resp.status
            except (http.client.HTTPException, OSError):
                if conn is not None:
                    conn.close()
                self._complete(r, ok=False,
                               seconds=time.perf_counter() - t0)
                raise
            if resp.will_close:
                conn.close()
            else:
                r.put_conn(conn)
            # Breaker failure = transport error or 5xx (a 4xx is the
            # client's fault, not the replica's).
            self._complete(r, ok=status < 500,
                           seconds=time.perf_counter() - t0)
            fspan.set_attr("status", status)
            return status, resp_headers, data

    # ── binary wire channel ───────────────────────────────────────────

    def _wire_channel_for(self, r: _Upstream):
        """The persistent channel client for one replica, created
        lazily. The channel address is derived the same way the worker
        derives its own listen port: explicit ``RTPU_WIRE_PORT``
        (single-replica deployments), else replica HTTP port +
        ``RTPU_WIRE_PORT_OFFSET``. Returns None when the channel
        transport is off."""
        cfg = self._wire_cfg
        if not (cfg.enabled and cfg.channel):
            return None
        from routest_tpu_torch.serve.wirechannel import WireChannelClient

        with self._wire_lock:
            client = self._wire_clients.get(r.id)
            if client is None:
                port = cfg.port or (r.port + cfg.port_offset)
                client = WireChannelClient(
                    r.host, port,
                    max_frame_bytes=int(cfg.max_frame_mb * 1024 * 1024))
                self._wire_clients[r.id] = client
            return client

    def _forward_wire(self, r: _Upstream, path: str, body: bytes,
                      deadline: float, probe=None):
        """One exchange over the replica's wire channel → (status,
        headers, body), or None when the channel is unavailable (the
        caller falls back to an HTTP forward of the same frame —
        counted, so the reuse ratio is honest). Transport failures
        never charge the breaker: the HTTP fallback that follows is
        the authoritative health evidence."""
        client = self._wire_channel_for(r)
        if client is None:
            return None
        from routest_tpu_torch.serve.wirechannel import (WireChannelError,
                                                   fallback_http_count)

        t0 = time.perf_counter()
        remaining_ms = max(1.0, (deadline - time.time()) * 1000.0)
        with trace_span("gateway.wire", replica=r.id, path=path) as wspan:
            try:
                status, frame = client.request(
                    path, body, timeout=max(0.2, remaining_ms / 1000.0),
                    deadline_ms=remaining_ms, probe=probe)
            except WireChannelError as e:
                wspan.set_attr("fallback", str(e))
                fallback_http_count()
                return None
            wspan.set_attr("status", status)
        self._complete(r, ok=status < 500,
                       seconds=time.perf_counter() - t0)
        rh: List = [("Content-Type", _WIRE_CONTENT_TYPE)]
        _tag_replica(rh, r.id)
        return status, rh, frame

    def _hedge_delay_s(self) -> float:
        """p95 of recent proxied latencies, floored at hedge_min_ms."""
        floor = self.config.hedge_min_ms / 1000.0
        snap = self.stats.snapshot().get("routes", {})
        p95s = [s["p95_ms"] for s in snap.values() if "p95_ms" in s]
        return max(floor, max(p95s) / 1000.0) if p95s else floor

    def handle(self, method: str, path: str, body: Optional[bytes],
               headers: Dict[str, str], deadline_ms: Optional[float]):
        """Full gateway pipeline → (status, headers, body), measured:
        every response lands in the per-route request families (the SLO
        rollup source) and the flight recorder's request ring."""
        t0 = time.perf_counter()
        status, rh, data = self._handle_inner(method, path, body,
                                              headers, deadline_ms)
        seconds = time.perf_counter() - t0
        route = _route_label(path.split("?", 1)[0])
        probe = next((v for k, v in headers.items()
                      if k.lower() == "x-rtpu-probe"), None)
        if probe:
            # Tag-and-exclude: probe traffic lands in its own family,
            # BEFORE the per-route user families the SLO engine rolls
            # up — a probe-only error storm leaves user SLO state ok.
            self._m_probe_requests.labels(route=route).inc()
        else:
            self._m_requests.labels(route=route).observe(seconds)
            if status >= 500:
                self._m_request_errors.labels(route=route).inc()
        rid = trace_id = replica_id = None
        for k, v in rh:
            lk = k.lower()
            if lk == "x-request-id":
                rid = v
            elif lk == "x-trace-id":
                trace_id = v
            elif lk == "x-rtpu-replica":
                replica_id = v
        if probe:
            replica_id = None      # version families are user-facing too
        if replica_id is not None:
            # Version-labeled mirror of the per-route families: which
            # serving VERSION answered (the replica tag is stamped by
            # _tag_replica on every proxied response). Looked up in the
            # append-only rid→version map, not the live replica list, so
            # a canary drained mid-flight still gets its errors charged
            # to the canary version.
            version = self._version_by_rid.get(replica_id) or "unversioned"
            self._m_vrequests.labels(route=route,
                                     version=version).observe(seconds)
            if status >= 500:
                self._m_vrequest_errors.labels(route=route,
                                               version=version).inc()
        self._recorder.record_request(
            tier="gateway", method=method, path=path.split("?", 1)[0],
            status=status, duration_ms=seconds * 1000.0,
            request_id=rid, trace_id=trace_id, deadline_ms=deadline_ms,
            extra={"probe": probe} if probe else None)
        return status, rh, data

    def _handle_inner(self, method: str, path: str, body: Optional[bytes],
                      headers: Dict[str, str],
                      deadline_ms: Optional[float]):
        """The pipeline proper → (status, headers, body).

        The trace is born HERE (or adopted from a well-formed client
        ``traceparent``): one root span per proxied request, with
        admission, per-replica forwards, retries, and hedges as
        children, and the context injected into the upstream hop so the
        replica's spans join the same trace. Ditto the correlation id —
        the gateway mints ``X-Request-ID`` when the client sent none,
        one hop earlier than the replica would, so gateway and replica
        log lines for one request finally grep together."""
        # Header names arrive in whatever case the client sent
        # (urllib capitalizes, browsers lowercase). ONE lowercase pass
        # serves every lookup below — the old per-header linear scans
        # re-walked the whole mapping for each name, which the hot
        # /api/predict_eta* path paid twice per request.
        low = {k.lower(): v for k, v in headers.items()}
        rid = low.get("x-request-id", "")
        if not REQUEST_ID_RE.match(rid):
            rid = mint_request_id()
        headers = {k: v for k, v in headers.items()
                   if k.lower() != "x-request-id"}
        headers["X-Request-ID"] = rid
        cfg = self.config
        budget_ms = deadline_ms if deadline_ms else cfg.deadline_ms
        deadline = time.time() + budget_ms / 1000.0
        client_ctx = parse_traceparent(low.get("traceparent", ""))
        with trace_span("gateway.request", parent=client_ctx,
                        method=method, path=path.split("?", 1)[0],
                        request_id=rid) as root:
            if low.get("x-rtpu-probe"):
                # Probe provenance on the root span: tail sampling
                # retains probe traces (``tail: probe``) so a failing
                # probe's evidence bundle can point at a kept trace.
                root.set_attr("probe", low["x-rtpu-probe"])
            t_admit = time.perf_counter()
            admitted, status = self._admit(deadline)
            self._m_admit_wait.observe(time.perf_counter() - t_admit)
            if not admitted:
                root.set_attr("status", status)
                if status == 429:
                    rh = [("Retry-After", "1"), _CT_JSON]
                    out = _BODY_SATURATED
                else:
                    rh = [_CT_JSON]
                    out = _BODY_DRAINING
                return status, self._stamp(rh, rid, root), out
            try:
                status, rh, data = self._routed(method, path, body,
                                                headers, deadline)
                root.set_attr("status", status)
                return status, self._stamp(rh, rid, root), data
            finally:
                self._release()

    @staticmethod
    def _stamp(rh: List, rid: str, root) -> List:
        """Correlation headers every gateway response carries: the
        request id (minted or echoed) and — when tracing is on — the
        trace id, so a slow client call pairs with its exported spans."""
        rh = [(k, v) for k, v in rh if k.lower() != "x-request-id"]
        rh.append(("X-Request-ID", rid))
        if root.trace_id is not None:
            rh.append(("X-Trace-Id", root.trace_id))
        return rh

    def _routed(self, method, path, body, headers, deadline):
        bare = path.split("?", 1)[0]
        idempotent = method in ("GET", "HEAD") or bare in _IDEMPOTENT_POST
        # The client's X-Deadline-Ms is consumed here (it defined
        # ``deadline``); each upstream hop gets a fresh header carrying
        # the REMAINING budget, stamped in _forward_once at send time.
        fwd_headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_HEADERS
                       and k.lower() not in ("host", "traceparent",
                                             "x-deadline-ms")}
        timeout = max(0.2, deadline - time.time())

        primary = self._pick()
        if primary is None:
            return 503, [_CT_JSON], _BODY_NO_REPLICA

        # Wire-frame requests try the persistent channel first (never
        # hedged — the channel is itself the low-latency path); a
        # channel miss falls through to the ordinary HTTP machinery
        # below with the frame as the request body, where the replica
        # still negotiates by content-type.
        if (bare in _WIRE_PATHS and body is not None
                and self._wire_cfg.enabled and self._wire_cfg.channel):
            ct = next((v for k, v in fwd_headers.items()
                       if k.lower() == "content-type"), "")
            if ct.split(";", 1)[0].strip().lower() == _WIRE_CONTENT_TYPE:
                probe = next((v for k, v in fwd_headers.items()
                              if k.lower() == "x-rtpu-probe"), None)
                result = self._forward_wire(primary, bare, body, deadline,
                                            probe=probe)
                if result is not None:
                    return result

        hedgeable = (self.config.hedge and idempotent
                     and len(self.replicas) > 1
                     and bare != "/api/realtime_feed"
                     and (body is None
                          or len(body) <= self.config.hedge_max_body_bytes))
        if hedgeable:
            result = self._forward_hedged(primary, method, path, body,
                                          fwd_headers, timeout, deadline)
            if result is not None:
                return result
        else:
            try:
                status, rh, data = self._forward_once(
                    primary, method, path, body, fwd_headers, timeout,
                    deadline=deadline)
                _tag_replica(rh, primary.id)
                return status, rh, data
            except (http.client.HTTPException, OSError):
                if not idempotent:
                    return 502, [_CT_JSON], _BODY_UPSTREAM_FAILED
            # idempotent fall-through: retry once on another replica
        retry = self._pick(exclude=(primary.id,)) or self._pick()
        if retry is None:
            return 503, [_CT_JSON], _BODY_NO_REPLICA
        with self._lock:
            self.retries += 1
        self._m_retries.inc()
        try:
            status, rh, data = self._forward_once(
                retry, method, path, body, fwd_headers,
                max(0.2, deadline - time.time()), slot="retry",
                deadline=deadline)
            _tag_replica(rh, retry.id)
            return status, rh, data
        except (http.client.HTTPException, OSError):
            return 502, [_CT_JSON], _BODY_UPSTREAM_FAILED

    def _forward_hedged(self, primary, method, path, body, headers,
                        timeout, fwd_deadline=None):
        """Primary in a worker thread; if it is still in flight after
        the p95-based delay, race a hedge on another replica. Returns
        the first SUCCESSFUL result, else the primary's failure — or
        None to signal "connection-level failure, let caller retry"."""
        box: List = []          # (source, result-or-None)
        done = threading.Event()
        # Hedge copies run on worker threads; contextvars don't follow,
        # so capture the ambient (root) span context and parent both
        # forwards under it explicitly.
        from routest_tpu_torch.obs.trace import current_context

        parent_ctx = current_context()

        def run(r, slot):
            try:
                res = self._forward_once(r, method, path, body,
                                         dict(headers), timeout,
                                         parent=parent_ctx, slot=slot,
                                         deadline=fwd_deadline)
            except (http.client.HTTPException, OSError):
                res = None
            box.append((slot, r, res))
            done.set()

        t = threading.Thread(target=run, args=(primary, "primary"),
                             daemon=True)
        t.start()
        done.wait(self._hedge_delay_s())
        hedge_r = None
        if not box:
            hedge_r = self._pick(exclude=(primary.id,))
            if hedge_r is not None:
                with self._lock:
                    self.hedges += 1
                self._m_hedges.inc()
                threading.Thread(target=run, args=(hedge_r, "hedge"),
                                 daemon=True).start()
        # Wait for the first result; if it's a transport failure, wait
        # for the other copy before giving up.
        expected = 2 if hedge_r is not None else 1
        deadline = time.time() + timeout
        while len(box) < expected and time.time() < deadline:
            done.wait(0.05)
            done.clear()
            if box and box[0][2] is not None:
                break
        for slot, r, res in box:
            if res is not None:
                if slot == "hedge":
                    with self._lock:
                        self.hedge_wins += 1
                    self._m_hedge_wins.inc()
                status, rh, data = res
                _tag_replica(rh, r.id)
                return status, rh, data
        if len(box) >= expected:
            return None          # every copy died at transport level
        return 504, [_CT_JSON], _BODY_UPSTREAM_TIMEOUT

    # ── metrics ───────────────────────────────────────────────────────

    def snapshot(self) -> dict:
        lat = self.stats.snapshot()["routes"]
        with self._lock:
            replicas = {}
            for r in self.replicas:
                replicas[r.id] = {
                    "base": r.base,
                    "state": r.state,
                    "version": r.version,
                    "canary": r.id in self._canary_rids,
                    "draining": r.draining,
                    "chips": r.chips,
                    "capacity": r.capacity,
                    "outstanding": r.outstanding,
                    "requests": r.requests,
                    "errors": r.errors,
                    "ejections": r.ejections,
                    "consecutive_failures": r.consecutive_failures,
                    "latency": lat.get(r.id, {"count": 0}),
                }
            fleet = {
                "uptime_s": round(time.time() - self.started, 1),
                "replica_count": len(self.replicas),
                "capacity_units": round(
                    sum(r.capacity for r in self.replicas
                        if not r.draining), 3),
                "inflight": self._inflight,
                "queued": self._waiters,
                "max_inflight": self.config.max_inflight,
                "queue_depth": self.config.queue_depth,
                "shed": self.shed_count,
                "retries": self.retries,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "draining": self.draining,
                "canary_fraction": self._canary_fraction,
            }
            if self.region:
                fleet["region"] = self.region
        if self.supervisor is not None:
            sup = self.supervisor.snapshot()
            for rid, info in sup.items():
                if rid in replicas:
                    replicas[rid]["supervisor"] = info
            fleet["restarts"] = sum(i["restarts"] for i in sup.values())
        return {"fleet": fleet, "replicas": replicas}

    def version_skew(self) -> dict:
        """Per-replica version + live model identity at a glance:
        the gateway's own version label merged with each replica's
        ``/api/version`` (build info, model generation + artifact
        fingerprint) — the 'is anything serving stale bytes?' answer
        surfaced on ``/api/autoscale`` and ``/api/metrics?replicas=1``.
        Unreachable replicas report the error in place."""
        fetched = self._fetch_replica_json("/api/version")
        with self._lock:
            labels = {r.id: {"version": r.version,
                             "canary": r.id in self._canary_rids,
                             "draining": r.draining,
                             "chips": r.chips,
                             "capacity": r.capacity}
                      for r in self.replicas}
        out = {}
        for rid, entry in labels.items():
            info = fetched.get(rid)
            if isinstance(info, dict):
                for key in ("version_label", "build", "model", "error"):
                    if key in info:
                        entry[key] = info[key]
            out[rid] = entry
        return out

    def replica_metrics(self) -> dict:
        """Per-replica ``/api/metrics`` JSON (batcher stage histograms
        included), fetched on demand for ``/api/metrics?replicas=1`` —
        the fleet tier's view into worker-side registries without a
        second scrape config. Unreachable replicas report the error
        instead of failing the whole endpoint."""
        return self._fetch_replica_json("/api/metrics")

    def _fetch_replica_json(self, path: str) -> dict:
        """GET ``path`` from every replica → {replica_id: parsed JSON};
        unreachable replicas report the error in place."""
        out = {}
        with self._lock:
            replicas = list(self.replicas)   # membership may change
        for r in replicas:
            try:
                conn = _fresh_conn(r.host, r.port, timeout=2.0)
                try:
                    conn.request("GET", path)
                    resp = conn.getresponse()
                    out[r.id] = json.loads(resp.read())
                finally:
                    conn.close()
            except (http.client.HTTPException, OSError, ValueError) as e:
                out[r.id] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # ── serving ───────────────────────────────────────────────────────

    def serve(self, host: str, port: int):
        """Start the gateway's HTTP server (returns the bound server;
        runs in a daemon thread). ``RTPU_PROBER=1`` raises: the prober
        is not ported yet."""
        from routest_tpu_torch.core.config import load_prober_config

        if load_prober_config().enabled:
            raise RuntimeError(
                "RTPU_PROBER=1: the blackbox prober (obs/prober.py) is not "
                "ported yet (ROADMAP Queue A item 10, part b)")
        gw = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):   # structured logs only
                pass

            def _respond(self, status, headers, data):
                try:
                    self.send_response(status)
                    for k, v in headers:
                        if k.lower() in _HOP_HEADERS | {"content-length"}:
                            continue
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _handle(self):
                path = self.path
                bare = path.split("?", 1)[0]
                if bare == "/api/metrics":
                    return self._metrics()
                if bare == "/api/trace":
                    return self._trace()
                if bare == "/api/timeline":
                    return self._timeline()
                if bare == "/api/slo":
                    return self._slo()
                if bare == "/api/probes":
                    return self._probes()
                if bare == "/api/efficiency":
                    return self._efficiency()
                if bare == "/api/changes":
                    return self._changes()
                if bare == "/api/incidents":
                    return self._incidents()
                if bare == "/api/autoscale":
                    return self._autoscale()
                if bare == "/api/rollout":
                    return self._rollout()
                if bare == "/api/debug/snapshot" and self.command == "POST":
                    return self._debug_snapshot()
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                deadline_ms = None
                raw = self.headers.get("X-Deadline-Ms")
                if raw:
                    try:
                        deadline_ms = max(1.0, float(raw))
                    except ValueError:
                        deadline_ms = None
                if bare == "/api/realtime_feed":
                    return self._stream(path)
                status, rh, data = gw.handle(
                    self.command, path, body, dict(self.headers.items()),
                    deadline_ms)
                self._respond(status, rh, data)

            def _metrics(self):
                snap = gw.snapshot()
                if "format=prometheus" in self.path:
                    # Fleet families + the unified registry (admission
                    # waits, per-replica latency histograms, hedge
                    # counters) in one scrape.
                    data = (_prometheus_fleet_text(snap)
                            + get_registry().prometheus_text()).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    snap["registry"] = get_registry().snapshot()
                    if "replicas=1" in self.path:
                        snap["replica_metrics"] = gw.replica_metrics()
                        snap["versions"] = gw.version_skew()
                    data = json.dumps(snap).encode()
                    ctype = "application/json"
                self._respond(200, [("Content-Type", ctype)], data)

            def _slo(self):
                """Gateway burn-rate state (the same contract as the
                replica's ``/api/slo``); ``?replicas=1`` embeds each
                worker's /api/slo, mirroring the metrics passthrough."""
                if gw.slo is None:
                    payload = {"enabled": False}
                else:
                    gw.slo.tick()
                    payload = gw.slo.snapshot()
                if "replicas=1" in self.path:
                    payload["replica_slo"] = gw._fetch_replica_json(
                        "/api/slo")
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _probes(self):
                """Blackbox-prober state: no prober is ported yet, so
                the JAX gateway's answer without one."""
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps({"enabled": False}).encode())

            def _efficiency(self):
                """Fleet device-goodput snapshot (docs/OBSERVABILITY.md
                "Device efficiency & goodput"): every replica's
                ``/api/efficiency`` (ledger + watchdog) in place, plus
                a fleet rollup — per-program real/padded/cached row
                totals summed across replicas and the set of replicas
                whose watchdog is NOT armed (the loud ledger-only
                degradation surface at fleet scope)."""
                replicas = gw._fetch_replica_json("/api/efficiency")
                fleet: dict = {"programs": {}, "degraded": [],
                               "pages": 0}
                for rid, snap in replicas.items():
                    if not isinstance(snap, dict) or "ledger" not in snap:
                        fleet["degraded"].append(rid)
                        continue
                    wd = snap.get("watchdog") or {}
                    if not wd.get("armed"):
                        fleet["degraded"].append(rid)
                    fleet["pages"] += int(wd.get("pages") or 0)
                    programs = (snap.get("ledger") or {}).get(
                        "programs") or {}
                    for prog, row in programs.items():
                        agg = fleet["programs"].setdefault(
                            prog, {"rows": 0, "padded_rows": 0,
                                   "cached_rows": 0, "calls": 0,
                                   "oversized": 0, "device_s": 0.0})
                        for k in agg:
                            agg[k] = round(
                                agg[k] + (row.get(k) or 0), 6)
                for prog, agg in fleet["programs"].items():
                    pad = agg["padded_rows"]
                    agg["waste_fraction"] = round(
                        1.0 - agg["rows"] / pad, 4) if pad > 0 else 0.0
                payload = {"fleet": fleet, "replicas": replicas}
                if gw.region:
                    payload["region"] = gw.region
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _changes(self):
                """Fleet change ledger (docs/OBSERVABILITY.md "Change
                ledger & incident correlation"): the gateway process's
                own events (rollout phases, autoscale actions,
                placement) merged with every replica's ``/api/changes``
                — deduped by event id, newest first — under the same
                ``kind``/label/``since``/``limit`` filters as the
                replica endpoint."""
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)

                def one(name):
                    return (q.get(name) or [None])[0]

                since = None
                raw = one("since")
                if raw:
                    try:
                        since = float(raw)
                    except ValueError:
                        since = None
                limit = None
                raw = one("limit")
                if raw:
                    try:
                        limit = max(1, int(raw))
                    except ValueError:
                        limit = None
                filters = dict(kind=one("kind"), replica=one("replica"),
                               version=one("version"),
                               region=one("region"), bucket=one("bucket"),
                               since=since)
                led = gw.change_ledger
                local = led.query(limit=None, **filters)
                merged = {e.get("id") or id(e): e
                          for e in local["events"]}
                replicas = gw._fetch_replica_json("/api/changes")
                degraded = []
                for rid, snap in sorted(replicas.items()):
                    if not isinstance(snap, dict) \
                            or "events" not in snap:
                        degraded.append(rid)
                        continue
                    for e in snap["events"]:
                        if isinstance(e, dict):
                            merged.setdefault(e.get("id") or id(e), e)
                from routest_tpu_torch.obs.ledger import event_ts
                events = sorted(merged.values(),
                                key=lambda e: -event_ts(e))
                if limit is not None:
                    events = events[:limit]
                payload = {"enabled": led.enabled,
                           "count": len(events), "events": events,
                           "ledger": led.snapshot(),
                           "degraded": degraded}
                if gw.region:
                    payload["region"] = gw.region
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _incidents(self):
                """Recent pages with their ranked suspects: the gateway
                recorder's incident roll-up plus each replica's
                ``/api/incidents``, newest first."""
                incidents = list(gw._recorder.incidents_snapshot())
                for rid, snap in sorted(
                        gw._fetch_replica_json(
                            "/api/incidents").items()):
                    if not isinstance(snap, dict):
                        continue
                    for inc in snap.get("incidents") or []:
                        if isinstance(inc, dict):
                            incidents.append(dict(inc, replica=rid))
                from routest_tpu_torch.obs.ledger import event_ts
                incidents.sort(key=lambda i: -event_ts(i))
                payload = {"enabled": gw.change_ledger.enabled,
                           "count": len(incidents),
                           "incidents": incidents}
                if gw.region:
                    payload["region"] = gw.region
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _autoscale(self):
                """Autoscaler state (fleet size, pending joins, recent
                decisions, config) — ``{"enabled": false}`` when no
                autoscaler is attached. Always carries ``versions``:
                per-replica build info + live model generation/
                fingerprint, so version skew is visible at a glance."""
                scaler = gw.autoscaler
                payload = {"enabled": False} if scaler is None \
                    else scaler.snapshot()
                payload["versions"] = gw.version_skew()
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _rollout(self):
                """Change-delivery surface: GET = the rollout
                controller's state machine snapshot (decisions,
                canary cohort, verdicts); POST starts or aborts one
                (``{"version": "...", "env": {...}}`` /
                ``{"action": "abort"}``)."""
                ro = gw.rollout
                if self.command == "POST":
                    if ro is None:
                        return self._respond(
                            503, [("Content-Type", "application/json")],
                            json.dumps({"error": "no rollout controller "
                                                 "attached"}).encode())
                    length = int(self.headers.get("Content-Length") or 0)
                    try:
                        body = json.loads(self.rfile.read(length)
                                          or b"{}")
                    except ValueError:
                        body = None
                    if not isinstance(body, dict):
                        return self._respond(
                            400, [("Content-Type", "application/json")],
                            json.dumps({"error": "body must be a JSON "
                                                 "object"}).encode())
                    if body.get("action") == "abort":
                        aborted = ro.abort("api")
                        payload = {"aborted": aborted, **ro.snapshot()}
                        return self._respond(
                            200, [("Content-Type", "application/json")],
                            json.dumps(payload, default=str).encode())
                    version = body.get("version")
                    env = body.get("env") or {}
                    if not isinstance(version, str) or not version \
                            or not isinstance(env, dict) \
                            or not all(isinstance(k, str)
                                       and isinstance(v, str)
                                       for k, v in env.items()):
                        return self._respond(
                            400, [("Content-Type", "application/json")],
                            json.dumps({"error": "need a version string "
                                        "(and optional str→str env "
                                        "overlay)"}).encode())
                    started = ro.start(version, env=env)
                    payload = {"started": started, **ro.snapshot()}
                    return self._respond(
                        202 if started else 409,
                        [("Content-Type", "application/json")],
                        json.dumps(payload, default=str).encode())
                payload = {"enabled": False} if ro is None \
                    else ro.snapshot()
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _debug_snapshot(self):
                """Manual postmortem bundle from the GATEWAY process
                (the replica's own /api/debug/snapshot is a plain
                proxied POST — this path must not be forwarded)."""
                bundle = gw._recorder.trigger(
                    "manual_api", {"source": "gateway"}, force=True)
                status = 200 if bundle else 503
                self._respond(
                    status, [("Content-Type", "application/json")],
                    json.dumps({"bundle": bundle,
                                "recorder": gw._recorder.snapshot()},
                               default=str).encode())

            def _timeline(self):
                """Fleet metric history (docs/OBSERVABILITY.md "Metric
                timeline"): ``?scope=fleet`` (default — the merged
                rollup of every replica's scraped frames),
                ``replicas`` (per-rid), ``versions`` (merged per
                serving version), or ``local`` (the gateway's own
                registry history: client-observed per-route latency,
                admission, hedges). ``?family=``/``?window=``/
                ``?step=`` as on the replica endpoint."""
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)

                def one(name):
                    return (q.get(name) or [None])[0]

                def num(name):
                    raw = one(name)
                    try:
                        return float(raw) if raw else None
                    except ValueError:
                        return None

                scope = one("scope") or "fleet"
                family = one("family") or None
                window, step = num("window"), num("step")
                if gw.timeline is None:
                    payload = {"enabled": False}
                elif scope == "local":
                    payload = gw.timeline.query(
                        family=family, window_s=window, step_s=step)
                    payload["enabled"] = True
                    if gw.watcher is not None:
                        payload["watcher"] = gw.watcher.snapshot()
                elif gw.fleet_timeline is None:
                    payload = {"enabled": False, "scope": scope}
                else:
                    payload = gw.fleet_timeline.query(
                        scope=scope, family=family, window_s=window)
                    payload["enabled"] = True
                    payload["scraper"] = gw.fleet_timeline.snapshot()
                if gw.region:
                    payload["region"] = gw.region
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _trace(self):
                """Span flight-recorder dump (same contract as the
                replica's ``/api/trace``): JSON spans, or Chrome
                trace_event JSON with ``?format=chrome``."""
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                buf = get_tracer().buffer
                spans = buf.snapshot(
                    trace_id=(q.get("trace_id") or [None])[0])
                limit = (q.get("limit") or [None])[0]
                if limit and limit.isdigit():
                    spans = spans[-int(limit):]
                if (q.get("format") or [None])[0] == "chrome":
                    payload = to_chrome_trace(spans)
                else:
                    payload = {"count": len(spans),
                               "dropped": buf.dropped, "spans": spans}
                self._respond(200,
                              [("Content-Type", "application/json")],
                              json.dumps(payload, default=str).encode())

            def _stream(self, path):
                """SSE pass-through: pick a replica, pipe bytes until
                either side closes. No admission queueing (streams are
                long-lived connections, not units of work)."""
                r = gw._pick()
                if r is None:
                    return self._respond(
                        503, [("Content-Type", "application/json")],
                        json.dumps({"error": "no healthy replica"}).encode())
                t0 = time.perf_counter()
                try:
                    conn = _fresh_conn(r.host, r.port, timeout=300)
                except OSError:
                    gw._complete(r, ok=False, seconds=0.0)
                    return self._respond(
                        502, [("Content-Type", "application/json")],
                        json.dumps({"error": "upstream connection failed"
                                    }).encode())
                try:
                    fwd = {k: v for k, v in self.headers.items()
                           if k.lower() not in _HOP_HEADERS
                           and k.lower() != "host"}
                    conn.request("GET", path, headers=fwd)
                    resp = conn.getresponse()
                    self.send_response(resp.status)
                    for k, v in resp.getheaders():
                        if k.lower() in _HOP_HEADERS | {"content-length"}:
                            continue
                        self.send_header(k, v)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        # read1, not read: read(8192) blocks until the
                        # full 8 KiB accumulates, which buffers small
                        # SSE events in the gateway for unbounded time
                        # on a quiet channel. read1 forwards whatever
                        # the replica flushed, as soon as it flushed.
                        chunk = resp.read1(8192)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                    gw._complete(r, ok=True,
                                 seconds=time.perf_counter() - t0)
                except (http.client.HTTPException, OSError):
                    gw._complete(r, ok=True,   # client hangup ≠ replica sick
                                 seconds=time.perf_counter() - t0)
                finally:
                    conn.close()
                    self.close_connection = True

            do_GET = do_POST = do_DELETE = do_PUT = do_OPTIONS = _handle

        httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        if self.slo is not None and self.slo.config.tick_s > 0:
            self.slo.start()  # burn-rate ticker lives with the listener
        # Timeline + fleet scraper live with the listener too.
        from routest_tpu_torch.core.config import load_timeline_config

        timeline_cfg = load_timeline_config()
        if timeline_cfg.enabled and self.timeline is None:
            from routest_tpu_torch.obs.timeline import (AnomalyWatcher,
                                                  FleetTimelineScraper,
                                                  TimelineStore)

            self.timeline = TimelineStore([get_registry()], timeline_cfg,
                                          component="gateway")
            self._recorder.register_timeline(self.timeline)
            if timeline_cfg.watch:
                self.watcher = AnomalyWatcher(
                    self.timeline, timeline_cfg, self._recorder).attach()
            self.timeline.start()
            self.fleet_timeline = FleetTimelineScraper(
                self._fetch_replica_json, timeline_cfg,
                versions_fn=lambda: {
                    rid: v or "unversioned"
                    for rid, v in self._version_by_rid.items()})
            self.fleet_timeline.start()
        thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                  name="fleet-gateway")
        thread.start()
        _log.info("gateway_listening", host=host, port=port,
                  replicas=[r.base for r in self.replicas])
        return httpd

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: stop admitting, finish inflight, stop the
        listener."""
        with self._cond:
            self.draining = True
            self._cond.notify_all()
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.05)
        if self.slo is not None:
            self.slo.stop()
        if self.timeline is not None:
            self.timeline.stop()
        if self.fleet_timeline is not None:
            self.fleet_timeline.stop()
        with self._wire_lock:
            wire_clients, self._wire_clients = \
                list(self._wire_clients.values()), {}
        for client in wire_clients:
            client.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        # Pooled keep-alive connections hold a handler thread open on
        # every replica: close them with the listener.
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            r.drop_conns()


def _prometheus_fleet_text(snapshot: dict) -> str:
    """Fleet snapshot → Prometheus exposition format (the worker
    endpoint's ``text/plain; version=0.0.4`` convention)."""

    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")

    fleet = snapshot["fleet"]
    lines = []
    gauges = ("inflight", "queued", "replica_count", "capacity_units",
              "uptime_s")
    counters = ("shed", "retries", "hedges", "hedge_wins", "restarts")
    for key in gauges:
        if key in fleet:
            lines.append(f"# TYPE routest_fleet_{key} gauge")
            lines.append(f"routest_fleet_{key} {fleet[key]}")
    for key in counters:
        if key in fleet:
            lines.append(f"# TYPE routest_fleet_{key} counter")
            lines.append(f"routest_fleet_{key} {fleet[key]}")
    rep_counters = ("requests", "errors", "ejections")
    rep_gauges = ("outstanding", "chips", "capacity")
    for key in rep_counters + rep_gauges:
        kind = "gauge" if key in rep_gauges else "counter"
        lines.append(f"# TYPE routest_fleet_replica_{key} {kind}")
        for rid, r in sorted(snapshot["replicas"].items()):
            lines.append(
                f'routest_fleet_replica_{key}{{replica="{esc(rid)}"}} '
                f"{r[key]}")
    lines.append("# TYPE routest_fleet_replica_up gauge")
    lines.append("# TYPE routest_fleet_replica_latency_ms gauge")
    for rid, r in sorted(snapshot["replicas"].items()):
        lines.append(f'routest_fleet_replica_up{{replica="{esc(rid)}"}} '
                     f"{int(r['state'] != OPEN)}")
        for q in ("p50_ms", "p95_ms", "p99_ms"):
            if q in r.get("latency", {}):
                lines.append(
                    f'routest_fleet_replica_latency_ms{{replica='
                    f'"{esc(rid)}",quantile="{q[:-3]}"}} '
                    f"{r['latency'][q]}")
    return "\n".join(lines) + "\n"
