"""Geo-front: multi-region active-active serving behind one door.

The counterpart of ``routest_tpu/serve/fleet/geofront.py``, in front of
fleets of ``python -m routest_tpu_torch.serve.fleet``. On one card every
region's fleet plans its replica onto that card, so two regions are two
replicas sharing it, each scoring through ``ops/csrc/fused_eta.cu``.

Two (or more) FULL fleets — each its own supervisor + gateway + broker
— serve the same models and road graph from different "regions". This
thin front routes each request by a client region hint (the
``X-RTPU-Region`` header or a ``?region=`` query parameter), fails
over to a healthy region when the hinted one is down, and merges the
per-fleet observability rollups (``/api/efficiency``, ``/api/slo``,
``/api/timeline``) into one geo-scope answer with every row/frame
carrying its ``region`` label.

What makes the pair ACTIVE-ACTIVE rather than two islands:

- **Live state** crosses regions through ``live/bridge.py``: each
  region's probe channel is republished into the other's bus with
  origin-region tagging, so both congestion estimators converge on the
  same metric from one probe fleet (and an A→B→A ring cannot amplify).
- **Store writes** cross regions through the front's bounded per-peer
  journal: every replicated mutation (``REPLICATED_POSTS``) that
  succeeds in its home region is journaled for every peer and drained
  by a replayer thread whenever the peer is healthy. A dead region's
  journal simply accumulates (depth metered, bounded by
  ``RTPU_REGION_JOURNAL_LIMIT``); on rejoin the replayer catches it up
  — zero lost writes while the journal never overflowed.
- **Region loss is a first-class chaos scenario**: ``kill_region``
  SIGKILLs an entire fleet (recorded as the ``region.kill`` fault in
  the unified chaos ledger), the survivor absorbs the redirected
  traffic (its autoscaler sees the extra load as ordinary pressure),
  and the cross-region fan-out prober (``RTPU_PROBER_REACH``) pages
  naming the dead region on the ``reach`` skew dimension.

Health is judged from the front: ``/up`` polled every
``RTPU_REGION_HEALTH_S``, a region is down after
``RTPU_REGION_UNHEALTHY_AFTER`` consecutive failures and up again on
the first success. Live-metric staleness per region (seconds since
``/api/live`` ingest observations last advanced) is metered on
``rtpu_region_live_staleness_seconds`` so a survivor serving without
its peer's probe feed is loud, bounded by ``RTPU_REGION_STALE_BOUND_S``
in the region-loss acceptance scenario.

``python -m routest_tpu_torch.serve.fleet.geofront`` boots the whole
topology from ``RTPU_REGIONS``: one broker + one fleet subprocess per
region (gateway on ``RTPU_GATEWAY_PORT + i``, replicas from
``RTPU_FLEET_BASE_PORT + 100 * i``), bridges both directions, front on
``RTPU_REGION_FRONT_PORT``.
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from routest_tpu_torch.core.config import RegionConfig
from routest_tpu_torch.obs.ledger import event_ts, record_change
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.geofront")

# Mutations replicated across regions through the write journal.
# ``/api/probe`` is deliberately absent: probe frames replicate through
# the probe-bus bridge (live/bridge.py), which already owns loop
# suppression — journaling them too would double-fold observations.
REPLICATED_POSTS = frozenset({
    "/api/optimize_route", "/api/optimize_route_batch",
    "/api/confirm_route", "/api/update_tracker",
})

_HOP_HEADERS = {"connection", "keep-alive", "proxy-authenticate",
                "proxy-authorization", "te", "trailers",
                "transfer-encoding", "upgrade"}

_metrics = None


def _front_metrics():
    global _metrics
    if _metrics is None:
        from routest_tpu_torch.obs import get_registry

        reg = get_registry()
        _metrics = {
            "up": reg.gauge(
                "rtpu_region_up",
                "1 when the region's gateway answers /up, 0 after "
                "unhealthy_after consecutive failures.", ("region",)),
            "requests": reg.counter(
                "rtpu_region_requests_total",
                "Requests the geo-front proxied, by serving region.",
                ("region",)),
            "failover": reg.counter(
                "rtpu_region_failover_total",
                "Requests redirected off their hinted region, by "
                "direction.", ("src", "dst")),
            "unroutable": reg.counter(
                "rtpu_region_unroutable_total",
                "Requests rejected 503 because no region was healthy."),
            "staleness": reg.gauge(
                "rtpu_region_live_staleness_seconds",
                "Seconds since the region's live ingest observation "
                "count last advanced.", ("region",)),
            "journal_depth": reg.gauge(
                "rtpu_region_journal_depth",
                "Replicated writes queued for the peer region.",
                ("region",)),
            "journal_writes": reg.counter(
                "rtpu_region_journal_writes_total",
                "Mutations journaled for a peer region.", ("region",)),
            "journal_replayed": reg.counter(
                "rtpu_region_journal_replayed_total",
                "Journaled mutations successfully replayed into a "
                "peer region.", ("region",)),
            "journal_dropped": reg.counter(
                "rtpu_region_journal_dropped_total",
                "Journaled mutations evicted at RTPU_REGION_JOURNAL_"
                "LIMIT before the peer came back (lost writes).",
                ("region",)),
        }
    return _metrics


class RegionHandle:
    """One region as the front sees it: the gateway base URL plus
    optional actuators. ``kill``/``rejoin`` are callables supplied by
    whatever owns the fleet processes (``FleetProcess`` below, or a
    bench harness) — the front records the fault and flips health; the
    owner does the actual killing."""

    def __init__(self, name: str, base: str, bus_url: str = "",
                 kill: Optional[Callable[[], None]] = None,
                 rejoin: Optional[Callable[[], None]] = None) -> None:
        self.name = name
        self.base = base.rstrip("/")
        self.bus_url = bus_url
        self.kill = kill
        self.rejoin = rejoin
        host, _, port = self.base.rpartition("//")[-1].partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port or 80)


class _RegionState:
    __slots__ = ("up", "fails", "last_ok", "obs_total", "obs_advance_t",
                 "staleness_s", "kills")

    def __init__(self) -> None:
        self.up = True            # optimistic until the first poll says no
        self.fails = 0
        self.kills = 0            # kill_region calls: a poll begun before
        #                           the latest one is stale
        self.last_ok = 0.0
        self.obs_total = -1.0
        self.obs_advance_t = time.monotonic()
        self.staleness_s = 0.0


def _fresh_conn(host: str, port: int,
                timeout: float) -> http.client.HTTPConnection:
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.connect()
    try:
        import socket

        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    return conn


class GeoFront:
    """The thin multi-region door: health, routing, journal, rollups."""

    def __init__(self, regions: Sequence[RegionHandle],
                 config: Optional[RegionConfig] = None) -> None:
        if len(regions) < 2:
            raise ValueError("a geo-front needs at least two regions")
        names = [r.name for r in regions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate region names: {names}")
        self.config = config or RegionConfig(
            enabled=True, regions=tuple(names), default=names[0])
        self.regions: List[RegionHandle] = list(regions)
        self.by_name: Dict[str, RegionHandle] = {r.name: r
                                                 for r in regions}
        self.default = (self.config.default
                        if self.config.default in self.by_name
                        else names[0])
        self._state: Dict[str, _RegionState] = {n: _RegionState()
                                                for n in names}
        self._lock = threading.Lock()
        # Per-peer replication journals: (path, body_bytes) FIFOs.
        self._journals: Dict[str, deque] = {n: deque() for n in names}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._httpd = None
        self.base = ""
        self.bridges: list = []       # probe/ledger bridges, /api/regions
        self.prober = None            # cross-region fan-out prober
        # Change ledger + recorder (docs/OBSERVABILITY.md "Change
        # ledger & incident correlation"): region lifecycle events
        # (failover / kill / rejoin) are recorded HERE — the front is
        # the only tier that sees them — and every front-side page
        # (the cross-region prober's) ranks suspects against them.
        from routest_tpu_torch.obs.ledger import get_change_ledger
        from routest_tpu_torch.obs.recorder import get_recorder

        self.ledger = get_change_ledger()
        self.recorder = get_recorder()
        if self.ledger.enabled:
            self.recorder.register_change_ledger(self.ledger)
        m = _front_metrics()
        for n in names:
            m["up"].labels(region=n).set(1.0)
            m["journal_depth"].labels(region=n).set(0.0)

    # ── health ────────────────────────────────────────────────────────

    def healthy(self, name: str) -> bool:
        st = self._state.get(name)
        return bool(st and st.up)

    def _poll_region(self, r: RegionHandle) -> None:
        st = self._state[r.name]
        m = _front_metrics()
        timeout = max(0.2, min(2.0, self.config.health_s * 2))
        with self._lock:
            kills = st.kills
        ok = False
        try:
            conn = _fresh_conn(r.host, r.port, timeout=timeout)
            try:
                conn.request("GET", "/up")
                ok = conn.getresponse().status < 500
            finally:
                conn.close()
        except OSError:
            ok = False
        came_up = went_down = False
        with self._lock:
            if st.kills != kills:
                # the region was killed while this poll was in flight: a
                # reply its server sent on the way down is no rejoin
                return
            if ok:
                was_down = not st.up
                st.fails = 0
                st.up = True
                st.last_ok = time.monotonic()
                if was_down:
                    came_up = True
                    _log.warning("region_up", region=r.name)
            else:
                st.fails += 1
                if st.up and st.fails >= self.config.unhealthy_after:
                    st.up = False
                    went_down = True
                    _log.warning("region_down", region=r.name,
                                 fails=st.fails)
        if went_down:
            record_change("region.failover", region=r.name,
                          detail={"fails": st.fails,
                                  "via": "health_poll"})
        elif came_up:
            record_change("region.rejoin", region=r.name,
                          detail={"via": "health_poll"})
        m["up"].labels(region=r.name).set(1.0 if st.up else 0.0)
        if ok:
            self._poll_staleness(r, st)

    def _poll_staleness(self, r: RegionHandle, st: _RegionState) -> None:
        """Seconds since this region's live ingest last advanced — the
        survivor-staleness meter the region-loss scenario bounds."""
        try:
            conn = _fresh_conn(r.host, r.port, timeout=2.0)
            try:
                conn.request("GET", "/api/live")
                payload = json.loads(conn.getresponse().read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return
        if not isinstance(payload, dict) or not payload.get("enabled"):
            return
        total = ((payload.get("ingest") or {})
                 .get("total_observations"))
        if not isinstance(total, (int, float)):
            return
        now = time.monotonic()
        with self._lock:
            if total > st.obs_total:
                st.obs_total = float(total)
                st.obs_advance_t = now
            st.staleness_s = now - st.obs_advance_t
        _front_metrics()["staleness"].labels(region=r.name).set(
            round(st.staleness_s, 3))

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            for r in self.regions:
                self._poll_region(r)
            self._stop.wait(max(0.05, self.config.health_s))

    # ── routing ───────────────────────────────────────────────────────

    def route(self, hint: Optional[str]) -> Tuple[Optional[RegionHandle],
                                                  Optional[str]]:
        """Region hint → (serving region, hinted-but-down region name).
        The second slot is non-None exactly when this request failed
        over; (None, None) means nothing is healthy."""
        primary = hint if hint in self.by_name else self.default
        if self.healthy(primary):
            return self.by_name[primary], None
        if not self.config.failover:
            return None, primary
        for r in self.regions:
            if r.name != primary and self.healthy(r.name):
                return r, primary
        return None, primary

    # ── journal ───────────────────────────────────────────────────────

    def journal_write(self, home: str, path: str, body: bytes) -> None:
        """Queue one successful mutation for every peer region."""
        m = _front_metrics()
        limit = max(1, self.config.journal_limit)
        with self._lock:
            for name, q in self._journals.items():
                if name == home:
                    continue
                q.append((path, body))
                m["journal_writes"].labels(region=name).inc()
                if len(q) > limit:
                    q.popleft()
                    m["journal_dropped"].labels(region=name).inc()
                m["journal_depth"].labels(region=name).set(len(q))

    def journal_depth(self, name: str) -> int:
        with self._lock:
            return len(self._journals[name])

    def _replay_loop(self) -> None:
        m = _front_metrics()
        while not self._stop.is_set():
            for r in self.regions:
                q = self._journals[r.name]
                while q and self.healthy(r.name) \
                        and not self._stop.is_set():
                    with self._lock:
                        if not q:
                            break
                        path, body = q[0]
                    try:
                        conn = _fresh_conn(r.host, r.port, timeout=15.0)
                        try:
                            conn.request(
                                "POST", path, body=body,
                                headers={"Content-Type":
                                         "application/json"})
                            status = conn.getresponse().status
                        finally:
                            conn.close()
                    except OSError:
                        break     # region flapped; retry next tick
                    if status >= 500:
                        break
                    with self._lock:
                        # Replays are the only consumer; the head is
                        # still ours unless the limit evicted it.
                        if q and q[0] == (path, body):
                            q.popleft()
                        m["journal_depth"].labels(
                            region=r.name).set(len(q))
                    m["journal_replayed"].labels(region=r.name).inc()
            self._stop.wait(max(0.05, self.config.replay_s))

    # ── region loss ───────────────────────────────────────────────────

    def kill_region(self, name: str) -> None:
        """SIGKILL an entire fleet: the ``region.kill`` chaos scenario.
        Actuated through the handle's ``kill`` callable (a process
        kill cannot be a probability draw inside the victim); recorded
        in the unified injection ledger like ``replica.kill``. Health
        flips immediately — the poller would take unhealthy_after
        rounds to notice, and redirected traffic shouldn't wait."""
        r = self.by_name[name]
        from routest_tpu_torch.chaos import get_chaos

        get_chaos().record("region.kill", "kill")
        record_change("region.kill", region=name,
                      detail={"base": r.base})
        _log.warning("region_kill", region=name)
        if r.kill is not None:
            r.kill()
        with self._lock:
            st = self._state[name]
            st.up = False
            st.fails = max(st.fails, self.config.unhealthy_after)
            st.kills += 1
        _front_metrics()["up"].labels(region=name).set(0.0)

    def rejoin_region(self, name: str) -> None:
        """Bring a killed region back (respawn via the handle's
        ``rejoin`` callable); health flips up on the first successful
        poll, then the replayer drains its journal."""
        r = self.by_name[name]
        record_change("region.rejoin", region=name,
                      detail={"via": "admin"})
        _log.warning("region_rejoin", region=name)
        if r.rejoin is not None:
            r.rejoin()

    # ── cross-region prober ───────────────────────────────────────────

    def arm_prober(self, prober_cfg, recorder=None, oracle=None):
        """The fan-out probe pointed ACROSS regions: targets are the
        region gateways, so a stale-epoch or divergent-model REGION is
        named on the epoch/model skew dimensions and a dead region on
        the ``reach`` dimension (cfg.fanout_reach)."""
        from routest_tpu_torch.obs.prober import BlackboxProber

        def targets():
            return [(r.name, r.base) for r in self.regions]

        self.prober = BlackboxProber(
            prober_cfg, gateway_base=self.base or self.regions[0].base,
            targets_fn=targets, recorder=recorder or self.recorder,
            oracle=oracle)
        self.prober.start()
        return self.prober

    # ── snapshot + merged rollups ─────────────────────────────────────

    def snapshot(self) -> dict:
        with self._lock:
            regions = {
                n: {"base": self.by_name[n].base,
                    "up": st.up, "fails": st.fails,
                    "staleness_s": round(st.staleness_s, 3),
                    "journal_depth": len(self._journals[n])}
                for n, st in self._state.items()}
        out = {"component": "geofront", "default": self.default,
               "failover": self.config.failover, "regions": regions}
        if self.bridges:
            out["bridges"] = [b.snapshot() for b in self.bridges]
        if self.prober is not None:
            out["prober"] = {"armed": True}
        return out

    def fetch_region_json(self, path: str,
                          only: Optional[str] = None,
                          timeout: float = 10.0) -> Dict[str, dict]:
        """GET ``path`` from every (or one) region's gateway →
        {region: payload}; down/unreachable regions report the error
        in place, so a merged rollup never blocks on a corpse."""
        out: Dict[str, dict] = {}
        for r in self.regions:
            if only is not None and r.name != only:
                continue
            if not self.healthy(r.name):
                out[r.name] = {"error": "region down"}
                continue
            try:
                conn = _fresh_conn(r.host, r.port, timeout=timeout)
                try:
                    conn.request("GET", path)
                    out[r.name] = json.loads(conn.getresponse().read())
                finally:
                    conn.close()
            except (http.client.HTTPException, OSError, ValueError) as e:
                out[r.name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def merged_efficiency(self, only: Optional[str] = None) -> dict:
        """Geo-scope ``/api/efficiency``: each region's fleet rollup in
        place (already region-stamped by its gateway) plus per-program
        rows merged across regions, every row carrying its ``region``
        label."""
        per = self.fetch_region_json("/api/efficiency", only=only)
        programs: Dict[str, list] = {}
        degraded: List[str] = []
        for name, payload in sorted(per.items()):
            fleet = (payload or {}).get("fleet") \
                if isinstance(payload, dict) else None
            if not isinstance(fleet, dict):
                degraded.append(name)
                continue
            for prog, row in (fleet.get("programs") or {}).items():
                entry = dict(row)
                entry["region"] = name
                programs.setdefault(prog, []).append(entry)
        return {"scope": "geo", "regions": per, "programs": programs,
                "degraded_regions": degraded}

    def merged_timeline(self, scope: str, query: str,
                        only: Optional[str] = None) -> dict:
        """Geo-scope ``/api/timeline``: ``scope=region`` merges every
        region's fleet frames into one region-labelled stream (sorted
        by time, NOT averaged — cross-region aggregation would hide
        exactly the divergence this scope exists to show);
        ``scope=global`` is the one cross-region curve — same-slot
        frames from every region merged under the gateway scraper's
        discipline (counters sum, gauges sum, histogram buckets add
        and percentiles recompute over the merged distribution), with
        the front ledger's region lifecycle events (failover / kill /
        rejoin) attached as annotations; other scopes fan out and
        return each region's payload in place."""
        sub_scope = "fleet" if scope in ("region", "global") else scope
        path = f"/api/timeline?scope={sub_scope}"
        if query:
            path += "&" + query
        per = self.fetch_region_json(path, only=only)
        out = {"component": "geofront", "scope": scope, "regions": per}
        if scope == "region":
            frames: List[dict] = []
            for name, payload in per.items():
                if not isinstance(payload, dict):
                    continue
                for f in payload.get("frames") or []:
                    tagged = dict(f)
                    tagged["region"] = name
                    frames.append(tagged)
            frames.sort(key=lambda f: f.get("t") or 0)
            out["frames"] = frames
        elif scope == "global":
            from routest_tpu_torch.obs.timeline import merge_frames

            # Same-slot merge: frames align across regions because
            # every TimelineStore cuts windows at wall-clock multiples
            # of the step — identical t means the same instant.
            slots: Dict[float, List[dict]] = {}
            for payload in per.values():
                if not isinstance(payload, dict):
                    continue
                for f in payload.get("frames") or []:
                    if isinstance(f, dict) and f.get("t") is not None \
                            and f.get("families") is not None:
                        slots.setdefault(float(f["t"]), []).append(f)
            frames = []
            for t in sorted(slots):
                merged = merge_frames(slots[t])
                if merged is not None:
                    merged["regions"] = len(slots[t])
                    frames.append(merged)
            out["frames"] = frames
            if frames:
                since = float(frames[0]["t"]) - 1.0
                out["annotations"] = list(reversed(
                    self.ledger.query(kind="region.",
                                      since=since)["events"]))
        return out

    def merged_changes(self, filters: Dict[str, Optional[str]],
                       since: Optional[float] = None,
                       limit: Optional[int] = None,
                       only: Optional[str] = None) -> dict:
        """Geo-scope ``/api/changes``: the front's own ledger (region
        lifecycle events) merged with every region gateway's
        fleet-merged ledger — deduped by event id, newest first."""
        local = self.ledger.query(since=since, limit=None, **filters)
        merged: Dict[object, dict] = {e.get("id") or id(e): e
                                      for e in local["events"]}
        from urllib.parse import urlencode

        params = {k: v for k, v in filters.items() if v is not None}
        if since is not None:
            params["since"] = since
        path = "/api/changes"
        if params:
            path += "?" + urlencode(params)
        per = self.fetch_region_json(path, only=only)
        degraded: List[str] = []
        for name, payload in sorted(per.items()):
            if not isinstance(payload, dict) \
                    or "events" not in payload:
                degraded.append(name)
                continue
            for e in payload["events"]:
                if isinstance(e, dict):
                    merged.setdefault(e.get("id") or id(e), e)
        events = sorted(merged.values(), key=lambda e: -event_ts(e))
        if limit is not None:
            events = events[:limit]
        return {"scope": "geo", "enabled": self.ledger.enabled,
                "count": len(events), "events": events,
                "ledger": self.ledger.snapshot(),
                "degraded_regions": degraded}

    def merged_incidents(self, only: Optional[str] = None) -> dict:
        """Geo-scope ``/api/incidents``: front-side pages (the
        cross-region prober's) plus each region's roll-up, newest
        first, each region incident tagged with its region."""
        incidents = list(self.recorder.incidents_snapshot())
        per = self.fetch_region_json("/api/incidents", only=only)
        for name, payload in sorted(per.items()):
            if not isinstance(payload, dict):
                continue
            for inc in payload.get("incidents") or []:
                if isinstance(inc, dict):
                    incidents.append(dict(inc, region=name))
        incidents.sort(key=lambda i: -event_ts(i))
        return {"scope": "geo", "enabled": self.ledger.enabled,
                "count": len(incidents), "incidents": incidents}

    def merged_slo(self, only: Optional[str] = None) -> dict:
        """Per-region SLO rollup + the worst state across regions
        (page > warn > ok), so one poll answers "is ANY region
        burning"."""
        per = self.fetch_region_json("/api/slo", only=only)
        rank = {"page": 2, "warn": 1}
        worst, worst_region = "ok", None
        for name, payload in per.items():
            objectives = (payload or {}).get("objectives") \
                if isinstance(payload, dict) else None
            for obj in (objectives or {}).values():
                state = obj.get("state") if isinstance(obj, dict) else None
                if rank.get(state, 0) > rank.get(worst, 0):
                    worst, worst_region = state, name
        return {"scope": "geo", "regions": per, "worst": worst,
                "worst_region": worst_region}

    # ── serving ───────────────────────────────────────────────────────

    def serve(self, host: str, port: int):
        front = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):   # structured logs only
                pass

            def _respond_json(self, status, payload):
                data = json.dumps(payload, default=str).encode()
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _query(self) -> Dict[str, str]:
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                return {k: v[0] for k, v in q.items() if v}

            def _handle(self):
                bare = self.path.split("?", 1)[0]
                q = self._query()
                if bare == "/up":
                    healthy = [r.name for r in front.regions
                               if front.healthy(r.name)]
                    return self._respond_json(
                        200 if healthy else 503,
                        {"status": "ok" if healthy else "no healthy "
                         "region", "healthy_regions": healthy})
                if bare == "/api/regions":
                    return self._respond_json(200, front.snapshot())
                if bare == "/api/probes" and front.prober is not None:
                    return self._respond_json(200,
                                              front.prober.snapshot())
                only = q.get("region") \
                    if q.get("region") in front.by_name else None
                if bare == "/api/efficiency" and self.command == "GET":
                    return self._respond_json(
                        200, front.merged_efficiency(only=only))
                if bare == "/api/slo" and self.command == "GET":
                    return self._respond_json(
                        200, front.merged_slo(only=only))
                if bare == "/api/changes" and self.command == "GET":
                    since = limit = None
                    try:
                        if q.get("since"):
                            since = float(q["since"])
                    except ValueError:
                        pass
                    try:
                        if q.get("limit"):
                            limit = max(1, int(q["limit"]))
                    except ValueError:
                        pass
                    filters = {k: q.get(k) for k in
                               ("kind", "replica", "version",
                                "region", "bucket")}
                    return self._respond_json(
                        200, front.merged_changes(
                            filters, since=since, limit=limit))
                if bare == "/api/incidents" and self.command == "GET":
                    return self._respond_json(
                        200, front.merged_incidents(only=only))
                if bare == "/api/timeline" and self.command == "GET":
                    from urllib.parse import urlsplit

                    query = "&".join(
                        tok for tok in
                        urlsplit(self.path).query.split("&")
                        if tok and not tok.startswith("scope=")
                        and not tok.startswith("region="))
                    return self._respond_json(
                        200, front.merged_timeline(
                            q.get("scope") or "region", query,
                            only=only))
                self._proxy(bare, q)

            def _proxy(self, bare: str, q: Dict[str, str]):
                hint = (self.headers.get("X-RTPU-Region")
                        or q.get("region"))
                m = _front_metrics()
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                tried: List[str] = []
                while True:
                    region, hinted_down = front.route(hint)
                    if region is not None and region.name in tried:
                        region = None
                    if region is None:
                        for r in front.regions:   # second-chance sweep
                            if r.name not in tried \
                                    and front.healthy(r.name):
                                region = r
                                break
                    if region is None:
                        m["unroutable"].inc()
                        return self._respond_json(
                            503, {"error": "no healthy region",
                                  "tried": tried})
                    if hinted_down is not None \
                            and hinted_down != region.name:
                        m["failover"].labels(src=hinted_down,
                                             dst=region.name).inc()
                    tried.append(region.name)
                    if bare == "/api/realtime_feed":
                        return self._stream(region)
                    try:
                        status, headers, data = self._exchange(
                            region, body)
                    except (http.client.HTTPException, OSError):
                        front._poll_region(region)  # fast down-detect
                        hint = None                 # reroute anywhere
                        continue
                    break
                m["requests"].labels(region=region.name).inc()
                if self.command == "POST" and 200 <= status < 300 \
                        and bare in REPLICATED_POSTS:
                    front.journal_write(region.name, self.path,
                                        body or b"")
                try:
                    self.send_response(status)
                    for k, v in headers:
                        if k.lower() in _HOP_HEADERS | {"content-length"}:
                            continue
                        self.send_header(k, v)
                    self.send_header("X-RTPU-Served-Region", region.name)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _exchange(self, region: RegionHandle,
                          body: Optional[bytes]):
                conn = _fresh_conn(region.host, region.port,
                                   timeout=120.0)
                try:
                    fwd = {k: v for k, v in self.headers.items()
                           if k.lower() not in _HOP_HEADERS
                           and k.lower() not in ("host",
                                                 "content-length")}
                    conn.request(self.command, self.path, body=body,
                                 headers=fwd)
                    resp = conn.getresponse()
                    return resp.status, resp.getheaders(), resp.read()
                finally:
                    conn.close()

            def _stream(self, region: RegionHandle):
                """SSE pass-through into the serving region (same
                byte-pipe contract as the gateway's replica stream)."""
                try:
                    conn = _fresh_conn(region.host, region.port,
                                       timeout=300)
                except OSError:
                    return self._respond_json(
                        502, {"error": "region connection failed",
                              "region": region.name})
                try:
                    fwd = {k: v for k, v in self.headers.items()
                           if k.lower() not in _HOP_HEADERS
                           and k.lower() != "host"}
                    conn.request("GET", self.path, headers=fwd)
                    resp = conn.getresponse()
                    self.send_response(resp.status)
                    for k, v in resp.getheaders():
                        if k.lower() in _HOP_HEADERS | {"content-length"}:
                            continue
                        self.send_header(k, v)
                    self.send_header("X-RTPU-Served-Region", region.name)
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        chunk = resp.read1(8192)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (http.client.HTTPException, OSError):
                    pass
                finally:
                    conn.close()
                    self.close_connection = True

            do_GET = do_POST = do_DELETE = do_PUT = do_OPTIONS = _handle

        httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        self._httpd = httpd
        probe_host = "127.0.0.1" if host in ("", "0.0.0.0") else host
        self.base = f"http://{probe_host}:{httpd.server_address[1]}"
        for target, name in ((self._health_loop, "geofront-health"),
                             (self._replay_loop, "geofront-replay"),
                             (httpd.serve_forever, "geofront-http")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        _log.info("geofront_listening", host=host,
                  port=httpd.server_address[1],
                  regions={r.name: r.base for r in self.regions},
                  default=self.default)
        return httpd

    def drain(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self.prober is not None:
            self.prober.stop()
        for b in self.bridges:
            b.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=max(0.1, deadline - time.monotonic()))
        self._threads = []


class FleetProcess:
    """One region's full fleet as a child process group —
    ``python -m routest_tpu_torch.serve.fleet`` with a region env
    overlay.
    ``start_new_session`` puts the fleet AND its workers in one
    process group, so ``kill()`` (SIGKILL to the group) is a true
    region loss: gateway, supervisor, and every replica die at once
    with no drain. ``rejoin()`` = a fresh ``start()``."""

    def __init__(self, name: str, *, gateway_port: int, base_port: int,
                 replicas: int = 1, redis_url: str = "",
                 env: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.gateway_port = gateway_port
        self.base = f"http://127.0.0.1:{gateway_port}"
        self.env = dict(env if env is not None else os.environ)
        self.env.update({
            "RTPU_REGION": name,
            "RTPU_GATEWAY_PORT": str(gateway_port),
            "RTPU_FLEET_BASE_PORT": str(base_port),
            "RTPU_FLEET_REPLICAS": str(replicas),
        })
        if redis_url:
            self.env["REDIS_URL"] = redis_url
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        if self.alive():
            return
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "routest_tpu_torch.serve.fleet"],
            env=self.env, start_new_session=True)
        _log.info("region_fleet_spawned", region=self.name,
                  pid=self.proc.pid, gateway_port=self.gateway_port)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def wait_ready(self, timeout: float = 300.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.alive():
                return False
            try:
                conn = _fresh_conn("127.0.0.1", self.gateway_port,
                                   timeout=2.0)
                try:
                    conn.request("GET", "/up")
                    if conn.getresponse().status < 500:
                        return True
                finally:
                    conn.close()
            except OSError:
                pass
            time.sleep(0.5)
        return False

    def kill(self) -> None:
        """SIGKILL the whole process group — no drain, no goodbye."""
        if self.proc is None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait(timeout=30)
        self.proc = None

    def terminate(self, timeout: float = 60.0) -> None:
        """Graceful region shutdown (SIGTERM → fleet drain)."""
        if self.proc is None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
        self.proc = None


def main() -> None:
    """Boot the full multi-region topology from ``RTPU_REGIONS``:
    per-region broker + fleet subprocess, probe bridges both
    directions, geo-front on ``RTPU_REGION_FRONT_PORT``."""
    from routest_tpu_torch.core.config import load_config
    from routest_tpu_torch.serve.netbus import NetBus, start_broker

    config = load_config()
    rc = config.region
    if not rc.enabled:
        _log.error("geofront_needs_regions",
                   hint="set RTPU_REGIONS=a,b (two or more names)")
        sys.exit(2)
    env = dict(os.environ)
    base_gw_port = config.fleet.gateway_port
    base_worker_port = config.fleet.base_port
    brokers, buses, fleets, handles = {}, {}, {}, []
    for i, name in enumerate(rc.regions):
        broker, _ = start_broker()
        brokers[name] = broker
        buses[name] = NetBus(f"tcp://127.0.0.1:{broker.port}",
                             reconnect_s=1.0)
        fleet = FleetProcess(
            name, gateway_port=base_gw_port + i,
            base_port=base_worker_port + 100 * i,
            replicas=max(1, config.fleet.replicas),
            redis_url=f"tcp://127.0.0.1:{broker.port}", env=env)
        fleet.start()
        fleets[name] = fleet
        handles.append(RegionHandle(
            name, fleet.base, bus_url=f"tcp://127.0.0.1:{broker.port}",
            kill=fleet.kill, rejoin=fleet.start))
    for name, fleet in fleets.items():
        if not fleet.wait_ready(timeout=600):
            _log.error("region_never_ready", region=name)
            for f in fleets.values():
                f.terminate(timeout=10)
            sys.exit(2)
    front = GeoFront(handles, rc)
    if rc.bridge:
        from routest_tpu_torch.live.bridge import ProbeBridge
        from routest_tpu_torch.live.probes import DEFAULT_CHANNEL

        channel = rc.bridge_channel or DEFAULT_CHANNEL
        names = list(rc.regions)
        for i, src in enumerate(names):
            dst = names[(i + 1) % len(names)]
            bridge = ProbeBridge(src, dst, buses[src], buses[dst],
                                 channel=channel)
            bridge.start()
            front.bridges.append(bridge)
        # The change ledger rides the same ring on its own channel:
        # every region's fleet sees every other region's deploys,
        # flips, and scale actions — one timeline, no extra transport.
        from routest_tpu_torch.obs.ledger import (
            DEFAULT_CHANNEL as CHANGES_CHANNEL, LedgerBridge)

        for i, src in enumerate(names):
            dst = names[(i + 1) % len(names)]
            lbridge = LedgerBridge(src, dst, buses[src], buses[dst],
                                   channel=CHANGES_CHANNEL)
            lbridge.start()
            front.bridges.append(lbridge)
        _log.info("bridges_started", count=len(front.bridges),
                  channel=channel)
    front.serve(rc.front_host, rc.front_port)
    if rc.prober:
        from routest_tpu_torch.core.config import load_prober_config

        front.arm_prober(load_prober_config(env))
    stop = threading.Event()

    def _term(*_):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    stop.wait()
    _log.info("geofront_draining")
    front.drain()
    for fleet in fleets.values():
        fleet.terminate(timeout=60)
    for broker in brokers.values():
        broker.shutdown()
    _log.info("geofront_stopped")


if __name__ == "__main__":
    main()
