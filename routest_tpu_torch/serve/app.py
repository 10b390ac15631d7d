"""The serving application, on the card.

The routes of ``routest_tpu/serve/app.py::create_app`` that the port
serves, with the same status codes, keys and error strings:

- ETA: ``POST /api/predict_eta``, ``POST /api/predict_eta_batch``
  (JSON, or RTW1 frames as ``application/x-rtpu-wire`` when
  ``RTPU_WIRE=1``; 415 otherwise), the ``POST /api/predict`` proxy
  alias;
- route optimization (great-circle legs, or street-network legs with
  ``road_graph: true``): ``POST /api/request_route``,
  ``POST /api/optimize_route`` (with ``use_ml_eta``, then persisted),
  ``POST /api/optimize_route_batch``, ``POST /api/matrix`` (JSON or
  wire frames); one 1-, 3- and 10-stop optimize warms the engine on
  the serving device once per process (``ROUTEST_WARM_BUCKETS=0`` opts
  out);
- history: ``GET /api/history``, ``GET``/``DELETE /api/history/<id>``,
  persisted through ``make_store`` (PostgREST with ``SUPABASE_URL`` and
  a key, else memory; always behind the resilience layer); the DELETE
  is bearer-gated under ``ROUTEST_AUTH=require``;
- auth (Laravel Breeze parity, ``serve/auth.py``):
  ``/sanctum/csrf-cookie``, ``/api/auth/{register,login,logout,
  forgot-password,reset-password,email/verification-notification,
  verify-email/<id>/<hash>}`` and ``/api/user``;
- live tracking: ``POST /api/confirm_route`` (starts a driver
  simulation publishing to the bus), ``POST /api/update_tracker``,
  ``GET /api/realtime_feed`` (SSE, resumable by ``Last-Event-ID``);
- live traffic: ``POST /api/probe`` (publishes probe observations to the
  probe channel) and ``GET /api/live``; ``RTPU_LIVE=1`` arms the ingest
  and the metric customizer on the road router of the serving device;
- dispatch (on unless ``RTPU_DISPATCH=0``): ``POST``/``GET
  /api/dispatch`` — the batched time-window VRP on the serving device,
  confirmed dispatches registered for live re-optimization, which
  ``POST /api/confirm_route`` also does for bodies that carry lat/lon
  stops;
- the dispatcher's pages (``/`` the point-to-point map, ``/ui`` the
  dispatch dashboard, ``/health`` the status page, ``/lib/<name>``
  their scripts) and ops routes (``/up``, ``/api/version``,
  ``/api/metrics`` in JSON or ``?format=prometheus``);
- ``GET /api/locations``, ``GET /api/ping`` and ``GET /api/health``.

Health keeps the degraded-not-down contract (always HTTP 200) and
reports the scoring path (``checks.model.scoring``), the device
(``checks.engine.mesh``), the road router once one is built
(``checks.engine.road_router``), live traffic when armed
(``checks.engine.live``), the bus (``checks.bus``, the JAX app's
``checks.redis``) and the store (``checks.store``, with the resilience
layer's breaker and journal; journaled writes read ``degraded``).
"""

from __future__ import annotations

import datetime as dt
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from routest_tpu_torch.core.config import (Config, load_config,
                                           load_wire_config, resolve_device)
from routest_tpu_torch.data import geo
from routest_tpu_torch.data.locations import locations_table
from routest_tpu_torch.obs import build_info, get_registry, register_build_info
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.optimize import road_router
from routest_tpu_torch.optimize.engine import (MAX_BATCH_PROBLEMS,
                                               _parse_problem,
                                               optimize_route,
                                               optimize_route_batch,
                                               travel_matrix)
from routest_tpu_torch.optimize.vrp import NO_WINDOW
from routest_tpu_torch.serve import sim, wirecodec
from routest_tpu_torch.serve.auth import (UNAUTHENTICATED, AuthService,
                                          mount_auth)
from routest_tpu_torch.serve.bus import make_bus, sse_stream
from routest_tpu_torch.serve.deadline import DeadlineExceeded
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.store import StoreUnavailable, make_store
from routest_tpu_torch.serve.mail import make_mailer
from routest_tpu_torch.serve.wsgi import App, Response, get_json, json_response
from routest_tpu_torch.train.checkpoint import default_model_path
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.serve")

# Largest batch one request may carry (rows), checked before any
# per-row work.
MAX_BATCH_ROWS = 131_072

_m_dispatch_requests = get_registry().counter(
    "rtpu_dispatch_requests_total",
    "POST /api/dispatch solves accepted, by problem mode.", ("mode",))

_HTML = "text/html; charset=utf-8"
_STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "static")


def _obj(value) -> dict:
    """A client-supplied field that SHOULD be an object, defensively:
    non-dict values degrade to {} so handlers fall into their normal
    missing-field defaults instead of AttributeError 500s."""
    return value if isinstance(value, dict) else {}


def create_app(config: Optional[Config] = None,
               eta_service: Optional[EtaService] = None,
               store=None, bus=None,
               sim_tick_range=(2.0, 5.0),
               auth: Optional[AuthService] = None,
               mailer=None) -> App:
    """The app. Route optimization runs on ``config.serve.device``;
    ``store`` and ``bus`` default to :func:`make_store` and
    :func:`make_bus` of the configured backends; ``sim_tick_range`` is
    the driver simulation's tick interval in seconds; ``auth`` defaults
    to an :class:`AuthService` required iff ``ROUTEST_AUTH=require``,
    ``mailer`` to :func:`make_mailer` (``ROUTEST_MAIL_FILE``)."""
    config = config or load_config()
    if mailer is None:
        mailer = make_mailer()
    if auth is None:
        auth = AuthService(
            required=os.environ.get("ROUTEST_AUTH") == "require")
    store = store if store is not None else make_store(
        config.serve.supabase_url, config.serve.supabase_service_key)
    bus = bus if bus is not None else make_bus(config.serve.redis_url)
    eta = eta_service if eta_service is not None else EtaService(
        config.serve, model_path=default_model_path(config.model))
    device = config.serve.device
    started = time.time()
    app = App()
    app.eta = eta  # for tests / introspection
    app.store = store
    app.bus = bus
    app.auth = auth
    mount_auth(app, auth, mailer=mailer)

    # Live traffic (RTPU_LIVE=1): probe-stream ingest → per-edge
    # congestion state → periodic metric refresh of the road router on
    # the serving device. Armed asynchronously: the router build on a
    # metro extract must not stall boot.
    app.live = None
    if config.live.enabled:
        from routest_tpu_torch.live.service import LiveTrafficService

        app.live = LiveTrafficService(bus, config.live, device=device)
        app.live.start()

    # Standard identity gauges (rtpu_build_info + process start time) on
    # the process registry /api/metrics exposes.
    register_build_info()
    _arm_observability(app, config, bus)

    # Dispatch: concurrent POST /api/dispatch VRP problems merge into one
    # padded batch on the serving device (dispatch/batcher.py);
    # confirmed dispatches register their corridor (dispatch/
    # registry.py); on live metric flips the re-optimization loop
    # re-solves exactly the degraded plans and pushes plan_update events
    # over the bus (dispatch/reopt.py).
    app.dispatch = (_dispatch_service(config, app, bus, sim_tick_range)
                    if config.dispatch.enabled else None)

    # ── optimization ────────────────────────────────────────────────────

    @app.route("/api/request_route", methods=("POST",))
    def request_route(request):
        response = optimize_route(get_json(request) or {}, device=device)
        return response, 400 if "error" in response else 200

    @app.route("/api/optimize_route", methods=("POST",))
    def optimize_route_endpoint(request):
        payload = get_json(request) or {}
        result = optimize_route(payload, device=device)
        if "error" in result:
            return result, 400

        # Optional ML ETA — computed before persisting, as the reference
        # does (``Flaskr/routes.py:96-116``).
        if payload.get("use_ml_eta"):
            props = result.setdefault("properties", {}) or {}
            summary = _obj(props.get("summary"))
            ctx = _obj(payload.get("context"))
            try:
                age = float(_obj(payload.get("driver_details"))
                            .get("driver_age", 30) or 30)
            except (TypeError, ValueError):
                age = 30.0
            try:
                distance_m = float(summary.get("distance") or 0)
            except (TypeError, ValueError):
                distance_m = 0.0
            eta_min, eta_iso, eta_bands = eta.predict_eta_quantiles(
                weather=ctx.get("weather", "Sunny"),
                traffic=ctx.get("traffic", "Low"),
                distance_m=distance_m,
                pickup_time=dt.datetime.now(),
                driver_age=age,
            )
            if eta_min is not None:
                props["eta_minutes_ml"] = eta_min
                props["eta_completion_time_ml"] = eta_iso
                # Additive: calibrated uncertainty band when the serving
                # model has quantile heads (point models add nothing).
                for level, val in eta_bands.items():
                    props[f"eta_minutes_ml_{level}"] = round(val, 4)

        # Best-effort persistence: failures are logged, never fatal
        # (``Flaskr/routes.py:118-125``).
        try:
            req_id = _persist(store, payload, result)
            if req_id:
                result.setdefault("properties", {})["request_id"] = req_id
                result["properties"]["saved"] = True
                # Write-behind: the rows are journaled, not yet durable
                # at the backend (the id stays valid; the journal replays
                # on recovery).
                if getattr(store, "degraded", False):
                    result["properties"]["degraded"] = True
        except Exception as e:
            _log.error("persist_failed", error=str(e), store=store.kind)
        return result, 200

    @app.route("/api/optimize_route_batch", methods=("POST",))
    def optimize_route_batch_endpoint(request):
        """``{"items": [<optimize_route bodies>], "use_ml_eta": bool}`` →
        ``{"count": N, "items": [<Feature or {"error"}>]}``: all
        multi-stop problems solve in one batched device program; with
        ``use_ml_eta`` every successful route's ETA scores in one model
        batch. Nothing here persists."""
        body = get_json(request) or {}
        items = body.get("items")
        if not isinstance(items, list) or not items:
            return {"error": "items must be a non-empty list"}, 400
        if len(items) > MAX_BATCH_PROBLEMS:
            return {"error": f"batch too large (max {MAX_BATCH_PROBLEMS} "
                             f"problems)"}, 400
        if not all(isinstance(it, dict) for it in items):
            return {"error": "every item must be an optimize_route body"}, 400
        results = optimize_route_batch(items, device=device)

        if body.get("use_ml_eta"):
            ok = [(i, r) for i, r in enumerate(results)
                  if isinstance(r, dict) and "error" not in r]
            if ok:
                ctx = _obj(body.get("context"))
                try:
                    minutes, iso = eta.predict_eta_batch(
                        weather=[ctx.get("weather", "Sunny")] * len(ok),
                        traffic=[ctx.get("traffic", "Low")] * len(ok),
                        distance_m=[
                            float((r["properties"].get("summary") or {})
                                  .get("distance") or 0) for _, r in ok],
                        pickup_time=None,
                        driver_age=[
                            float((items[i].get("driver_details") or {})
                                  .get("driver_age", 30) or 30)
                            for i, _ in ok],
                    )
                except DeadlineExceeded:
                    raise  # 504: the whole batch's budget is gone
                except Exception as e:
                    _log.error("batch_eta_failed", error=str(e))
                    minutes = None
                if minutes is not None:
                    for (i, r), m, ts in zip(ok, minutes, iso):
                        if math.isfinite(m):
                            r["properties"]["eta_minutes_ml"] = round(
                                float(m), 4)
                            r["properties"]["eta_completion_time_ml"] = str(ts)
        return {"count": len(items), "items": results}, 200

    # ── binary wire path ───────────────────────────────────────────────
    # Content-type-negotiated alternative representation of the two hot
    # endpoints: ``application/x-rtpu-wire`` frames in, frames out, the
    # SAME answers as JSON bit for bit. One implementation per endpoint
    # serves both transports: the HTTP negotiation below and the
    # persistent channel (serve/wirechannel.py) call these handlers,
    # which speak raw frame bytes → (status, frame bytes). Transport
    # failures (413/504) stay JSON; request-level outcomes are error
    # frames.
    wire_cfg = load_wire_config()
    app.wire_config = wire_cfg
    wire_max = int(wire_cfg.max_frame_mb * 1024 * 1024)

    def _wire_eta(payload):
        try:
            frame = wirecodec.decode_eta_request(
                payload, max_bytes=wire_max, max_rows=MAX_BATCH_ROWS)
        except wirecodec.WireError as e:
            return 400, wirecodec.encode_error_frame(
                400, f"malformed batch: {e}")
        try:
            result = eta.predict_eta_wire(
                frame.columns["features"], frame.columns["pickup_ms"],
                blob=frame.payload("features"))
        except DeadlineExceeded:
            raise  # → 504 via the transport layer, not a 503
        except Exception as e:
            _log.error("predict_wire_failed", error=str(e))
            result = None
        if result is None:
            return 503, wirecodec.encode_error_frame(
                503, "model unavailable")
        minutes, completion_ms, bands = result
        return 200, wirecodec.encode_eta_response(minutes, completion_ms,
                                                  bands)

    def _wire_matrix(payload):
        try:
            body = wirecodec.decode_matrix_request(payload,
                                                   max_bytes=wire_max)
        except wirecodec.WireError as e:
            return 400, wirecodec.encode_error_frame(400, str(e))
        result = travel_matrix(body, device=device)
        if "error" in result:
            return 400, wirecodec.encode_error_frame(400, result["error"])
        return 200, wirecodec.encode_matrix_response(result)

    # Path → wire handler; ``python -m routest_tpu_torch.serve`` hands
    # this dict to the channel server. Empty while the path is off: the
    # negotiation answers 415 and no channel listener starts.
    app.wire_handlers = (
        {"/api/predict_eta_batch": _wire_eta, "/api/matrix": _wire_matrix}
        if wire_cfg.enabled else {})
    if wire_cfg.enabled:
        record_change("wire.enable",
                      detail={"paths": sorted(app.wire_handlers),
                              "channel": wire_cfg.channel})

    def _wire_negotiated(request, path):
        """None when the request is not wire content-type, else the
        finished binary (or 415) Response."""
        ct = (request.content_type or "").split(";", 1)[0].strip().lower()
        if ct != wirecodec.WIRE_CONTENT_TYPE:
            return None
        fn = app.wire_handlers.get(path)
        if fn is None:
            return json_response(
                {"error": "binary wire format disabled on this replica "
                          "(RTPU_WIRE=1 enables it)"}, 415)
        status, frame = fn(request.get_data())
        return Response(frame, status=status,
                        content_type=wirecodec.WIRE_CONTENT_TYPE)

    @app.route("/api/matrix", methods=("POST",))
    def matrix_endpoint(request):
        """Travel matrix: ``{"points": [{"lat","lon"}, …],
        "sources"/"destinations": [idx], ...}`` → ``{"distances_m": S×D,
        "durations_s": S×D}``; also speaks the binary wire format by
        content-type."""
        wired = _wire_negotiated(request, "/api/matrix")
        if wired is not None:
            return wired
        result = travel_matrix(get_json(request) or {}, device=device)
        if "error" in result:
            return result, 400
        return result, 200

    # ── dispatch ───────────────────────────────────────────────────────

    @app.route("/api/dispatch", methods=("POST",))
    def dispatch_endpoint(request):
        """Batched VRP dispatch.

        Geographic mode (reference-shaped body): ``{"source_point",
        "destination_points": [{lat, lon, payload}, …],
        "driver_details", "time_windows": [[open_s, close_s|null],
        …]?, "confirm": bool?, "sim_seed": int?}`` — stops price into
        travel seconds under the current metric and solve through the
        shared dispatch batcher (time-window + demand-spillover VRP).

        Matrix mode: ``{"matrix": (N+1)×(N+1), "demands": [N],
        "capacity", "max_distance", "time_windows"?}`` — the caller
        brings the cost matrix.

        ``{"complete": "<dispatch_id>"}`` retires an active dispatch.

        With ``confirm`` the plan registers for live re-optimization
        (``plan_update`` over SSE on corridor degradation) and — when
        the body carries a driver — starts the driver simulation.
        """
        svc = app.dispatch
        if svc is None:
            return {"error": "dispatch disabled (RTPU_DISPATCH=0)"}, 503
        body = get_json(request) or {}

        done = body.get("complete")
        if done is not None:
            if not isinstance(done, str):
                return {"error": "complete must be a dispatch id"}, 400
            if not svc.registry.complete(done):
                return {"error": "not found"}, 404
            return {"status": "completed", "dispatch_id": done}, 200

        seed = body.get("sim_seed")
        if seed is not None and not isinstance(seed, int):
            return {"error": "sim_seed must be an integer"}, 400

        if "matrix" in body:
            parsed = _parse_matrix_dispatch(body, svc.cfg.max_stops)
        else:
            parsed = _parse_geo_dispatch(body, svc.cfg.max_stops)
        if "error" in parsed:
            return parsed, 400

        from routest_tpu_torch.dispatch import DispatchProblem, plan_cost

        mode = parsed["mode"]
        if mode == "geographic":
            speed = parsed["speed"]
            matrix = svc.matrix_fn(parsed["latlon"], speed_mps=speed)
            max_cost = parsed["max_dist"] / speed  # meters → seconds
        else:
            matrix = parsed["matrix"]
            max_cost = parsed["max_cost"]
        problem = DispatchProblem(matrix, parsed["demands"],
                                  parsed["capacity"], max_cost,
                                  parsed["tw_open"], parsed["tw_close"])
        try:
            plan = svc.batcher.solve([problem])[0]
        except TimeoutError:
            return {"error": "dispatch solver saturated; retry"}, 503
        _m_dispatch_requests.labels(mode=mode).inc()
        cost = plan_cost(matrix, plan)
        out = {"mode": mode, "plan": plan,
               "cost": round(float(cost), 3), "epoch": svc.epoch_fn()}

        if body.get("confirm"):
            driver = dict(parsed.get("driver_details") or {})
            if mode == "geographic":
                driver.setdefault("speed_mps", round(speed, 3))
            rec = svc.registry.register(
                channel=driver.get("driver_name"),
                latlon=parsed.get("latlon"),
                demands=parsed["demands"],
                capacity=parsed["capacity"], max_cost=max_cost,
                plan=plan, baseline_cost=cost, epoch=out["epoch"],
                tw_open=parsed["tw_open"], tw_close=parsed["tw_close"],
                sim_seed=seed, driver_details=driver,
                destinations=parsed.get("destinations"))
            out["dispatch_id"] = rec.id
            out["channel"] = rec.channel
            svc.sim_restart(rec)  # no-op without a named driver
        return out, 200

    @app.route("/api/dispatch", methods=("GET",))
    def dispatch_state(request):
        # Active registry, batcher merge stats, re-optimization loop
        # snapshot.
        svc = app.dispatch
        if svc is None:
            return {"enabled": False}, 200
        out = {"enabled": True, "epoch": svc.epoch_fn(),
               "registry": svc.registry.snapshot(),
               "batcher": svc.batcher.stats()}
        if svc.reopt is not None:
            out["reopt"] = svc.reopt.snapshot()
        return out, 200

    # ── live tracking ──────────────────────────────────────────────────

    @app.route("/api/confirm_route", methods=("POST",))
    def confirm_route(request):
        data = get_json(request)
        if not data or "route_details" not in data or "driver_details" not in data:
            return {"error": "driver_details and route_details required"}, 400
        # Validate the structure the simulator dereferences up front —
        # a daemon thread dying on KeyError would 200 then go silent.
        route = _obj(data["route_details"])
        driver = _obj(data["driver_details"])
        coords = _obj(route.get("geometry")).get("coordinates")
        summary = _obj(route.get("properties")).get("summary")
        if not isinstance(coords, list) or not coords or not isinstance(summary, dict):
            return {"error": "route_details must carry geometry.coordinates and properties.summary"}, 400
        if not driver.get("driver_name") or not driver.get("vehicle_type"):
            return {"error": "driver_details must carry driver_name and vehicle_type"}, 400
        if "destinations" not in _obj(route.get("properties")):
            return {"error": "route_details.properties.destinations required"}, 400
        # Optional deterministic replay: a caller-supplied sim_seed makes
        # the tick jitter (and so the publish cadence) bit-identical
        # across runs.
        seed = data.get("sim_seed")
        if seed is not None and not isinstance(seed, int):
            return {"error": "sim_seed must be an integer"}, 400
        sim.start_simulation(data, bus.publish, sim_tick_range, seed=seed)
        # A confirmed route also registers for live re-optimization when
        # the body carries enough of the problem to re-solve (lat/lon
        # stops, finite constraints), with its sim_seed; other bodies
        # keep the reference's answer.
        out = {"status": "route simulation initialized."}
        svc = app.dispatch
        if svc is not None:
            try:
                rec = _register_confirmed_route(svc, data, seed)
            except Exception as e:  # best-effort: never fail the confirm
                rec = None
                _log.debug("dispatch_register_skipped",
                           error=f"{type(e).__name__}: {e}")
            if rec is not None:
                out["dispatch_id"] = rec.id
        return out, 200

    @app.route("/api/update_tracker", methods=("POST",))
    def update_tracker(request):
        data = get_json(request)
        if not data:
            return {"error": "no data provided in the publish request."}, 400
        try:
            event = sim.format_sse_data(data)
        except (KeyError, ValueError, TypeError, OverflowError) as e:
            # TypeError: right fields, wrong types; OverflowError:
            # timedelta on an infinite/huge duration — all client errors.
            return {"error": f"malformed tracker payload: {e}"}, 400
        bus.publish(str(data.get("route_id")), event)
        return {"status": "published"}, 200

    @app.route("/api/probe", methods=("POST",))
    def probe(request):
        """Probe-observation ingest over HTTP. The handler only
        PUBLISHES to the probe channel; the live ingester folds the
        event through its own bus subscription, so HTTP- and
        bus-sourced probes take one code path into the estimator."""
        data = get_json(request)
        if not data:
            return {"error": "no probe data provided."}, 400
        obs = data.get("obs") if isinstance(data.get("obs"), list) \
            else data.get("observations")
        if not isinstance(obs, list) or not obs:
            return {"error": "obs must be a non-empty list of "
                             "[edge_id, speed_mps] pairs"}, 400
        if len(obs) > 4096:
            return {"error": "probe batch too large (max 4096)"}, 400
        for o in obs:
            if (not isinstance(o, (list, tuple)) or len(o) != 2
                    or not isinstance(o[0], int)
                    or not isinstance(o[1], (int, float))):
                return {"error": "each observation must be "
                                 "[edge_id, speed_mps]"}, 400
        channel = (app.live.cfg.channel if app.live is not None
                   else os.environ.get("RTPU_LIVE_CHANNEL", "rtpu.probes"))
        event = {"t": float(data.get("t") or time.time()),
                 "driver": str(data.get("driver") or "http"),
                 "obs": [[int(e), float(s)] for e, s in obs]}
        # A frame that already crossed a region bridge keeps its origin
        # stamp (the JAX package's bridge reads it).
        if data.get("origin_region") is not None:
            event["origin_region"] = str(data["origin_region"])
        if data.get("hour") is not None:
            try:
                event["hour"] = int(data["hour"]) % 24
            except (TypeError, ValueError):
                return {"error": "hour must be an integer"}, 400
        bus.publish(channel, event)
        return {"status": "published", "count": len(obs)}, 200

    @app.route("/api/live", methods=("GET",))
    def live_state(request):
        """Live-traffic surface: ingest and customizer state, the
        serving metric epoch, and — with ``?metric=1`` — the blended
        per-edge seconds themselves."""
        live = app.live
        if live is None:
            return {"enabled": False}, 200
        out = live.snapshot()
        if request.args.get("metric") and live.router is not None:
            metric = live.router.live_metric_export()
            if metric is not None:
                out["edge_time_s"] = [round(float(v), 4) for v in metric]
                out["n_edges"] = len(metric)
        return out, 200

    @app.route("/api/realtime_feed", methods=("GET",))
    def realtime_feed(request):
        channel = request.args.get("channel", "sse")
        try:
            max_events = int(request.args["max_events"]) \
                if "max_events" in request.args else None
        except ValueError:
            max_events = None
        # SSE resume: EventSource sends Last-Event-ID on reconnect; the
        # bus's replay ring resumes from it.
        last_id = None
        raw_lei = (request.header("Last-Event-ID")
                   or request.args.get("last_event_id"))
        if raw_lei:
            try:
                last_id = int(raw_lei)
            except ValueError:
                last_id = None
        subscription = bus.subscribe(channel, last_event_id=last_id)
        return Response(
            sse_stream(subscription, max_events=max_events),
            content_type="text/event-stream",
            headers={"Cache-Control": "no-cache", "X-Accel-Buffering": "no"},
        )

    # ── history ────────────────────────────────────────────────────────

    @app.route("/api/history", methods=("GET",))
    def history(request):
        try:
            limit = int(request.args.get("limit", 20))
        except ValueError:
            limit = 20
        limit = max(1, min(limit, 100))
        # Additive filter: ?engine=ml|default narrows server-side.
        engine = request.args.get("engine")
        if engine is not None and engine not in ("ml", "default"):
            return {"error": "engine must be 'ml' or 'default'"}, 400
        try:
            rows = store.list_history(limit, engine=engine)
        except StoreUnavailable:
            return {"items": [], "degraded": True}, 200
        except Exception as e:
            return {"error": f"history fetch failed: {e}"}, 500

        items = []
        for rr in rows:
            res = rr.get("route_results") or []
            first = res[0] if res else {}
            stops = rr.get("stops") or {}
            dest_ids = stops.get("destination_ids") or []
            items.append({
                "request_id": rr["id"],
                "created_at": rr.get("request_time"),
                "origin_id": rr.get("origin_id"),
                "dest_count": len(dest_ids),
                "total_distance": first.get("total_distance"),
                "total_duration": first.get("total_duration"),
                "optimized": bool(first.get("optimized_order") or []),
                "engine": rr.get("engine") or "default",
                "vehicle_id": rr.get("vehicle_id"),
                "eta_minutes_ml": first.get("eta_minutes_ml"),
                "eta_completion_time_ml": first.get("eta_completion_time_ml"),
            })
        return {"items": items}, 200

    @app.route("/api/history/<req_id>", methods=("GET",))
    def history_detail(request, req_id):
        try:
            row = store.get_request(req_id)
        except StoreUnavailable:
            return {"error": "store degraded; retry later",
                    "degraded": True}, 503
        except Exception as e:
            return {"error": f"history fetch failed: {e}"}, 500
        if row is None:
            return {"error": "not found"}, 404
        results = row.get("route_results") or []
        return {
            "request": {
                "id": row["id"],
                "origin_id": row.get("origin_id"),
                "stops": row.get("stops") or {},
                "status": row.get("status"),
                "request_time": row.get("request_time"),
                "engine": row.get("engine") or "default",
                "vehicle_id": row.get("vehicle_id"),
                "driver_age": row.get("driver_age"),
            },
            "result": results[0] if results else None,
        }, 200

    @app.route("/api/history/<req_id>", methods=("DELETE",))
    def delete_history(request, req_id):
        # The one destructive route: bearer-gated under
        # ROUTEST_AUTH=require (the reference never gated it).
        if auth.required and auth.user_from_request(request) is None:
            return UNAUTHENTICATED
        try:
            deleted = store.delete_request(req_id)
        except StoreUnavailable:
            return {"error": "store degraded; retry later",
                    "degraded": True}, 503
        except Exception as e:
            return {"error": f"delete failed: {e}"}, 500
        if not deleted:
            return {"error": "not found"}, 404
        return Response("", 204)

    @app.route("/api/locations", methods=("GET",))
    def locations(request):
        # Laravel parity (``routes/api.php:7-9``): plain array of rows.
        return locations_table(), 200

    # ── prediction ─────────────────────────────────────────────────────

    @app.route("/api/predict_eta", methods=("POST",))
    def predict_eta(request):
        body = get_json(request) or {}
        summary = _obj(body.get("summary"))
        try:
            distance_m = float(summary.get("distance") or 0)
            driver_age = float(body.get("driver_age", 30) or 30)
        except (TypeError, ValueError):
            return {"error": "distance/driver_age must be numeric"}, 400
        # Categorical fields must be strings (an unhashable dict would
        # blow up featurization).
        for name in ("weather", "traffic"):
            if not isinstance(body.get(name, ""), str):
                return {"error": f"{name} must be a string"}, 400
        eta_min, eta_iso, eta_bands = eta.predict_eta_quantiles(
            weather=body.get("weather", "Sunny"),
            traffic=body.get("traffic", "Low"),
            distance_m=distance_m,
            pickup_time=body.get("pickup_time") or dt.datetime.now().isoformat(),
            driver_age=driver_age,
        )
        if eta_min is None:
            return {"error": "model unavailable"}, 503
        out = {"eta_minutes_ml": eta_min, "eta_completion_time_ml": eta_iso}
        for level, val in eta_bands.items():  # additive uncertainty band
            out[f"eta_minutes_ml_{level}"] = round(val, 4)
        return out, 200

    @app.route("/api/predict_eta_batch", methods=("POST",))
    def predict_eta_batch(request):
        """Batched ETA scoring. Accepts either form:

        - columnar: ``{"distance_m": [..N..], "weather": [..]|str,
          "traffic": [..]|str, "driver_age": [..]|num,
          "pickup_time": [..]|iso}`` — scalars broadcast to N;
        - row-shaped: ``{"items": [{summary:{distance}, weather, traffic,
          pickup_time, driver_age}, ...]}``.

        Response: ``{"count": N, "eta_minutes_ml": [..],
        "eta_completion_time_ml": [..]}`` (+ ``eta_minutes_ml_p10``/
        ``_p90`` columns for a quantile model) / 503 when no model serves.
        Also speaks the binary wire format by content-type.
        """
        wired = _wire_negotiated(request, "/api/predict_eta_batch")
        if wired is not None:
            return wired
        body = get_json(request) or {}
        try:
            if "items" in body:
                items = body["items"]
                if not isinstance(items, list) or not items:
                    return {"error": "items must be a non-empty list"}, 400
                if len(items) > MAX_BATCH_ROWS:
                    return {"error": "batch too large (max 131072 rows)"}, 400
                distance = [float(((it.get("summary") or {}).get("distance"))
                                  or it.get("distance_m") or 0)
                            for it in items]
                # `or` (not .get default) so explicit nulls coerce to the
                # defaults exactly like the columnar form.
                weather = [it.get("weather") or "Sunny" for it in items]
                traffic = [it.get("traffic") or "Low" for it in items]
                age = [float(it.get("driver_age", 30) or 30) for it in items]
                pickup = [it.get("pickup_time") for it in items]
            else:
                distance = body.get("distance_m")
                if not isinstance(distance, list) or not distance:
                    return {"error": "distance_m must be a non-empty list "
                                     "(or send items=[...])"}, 400
                if len(distance) > MAX_BATCH_ROWS:
                    return {"error": "batch too large (max 131072 rows)"}, 400
                distance = [float(d or 0) for d in distance]
                n = len(distance)

                def col(name, default):
                    v = body.get(name, default)
                    if isinstance(v, list):
                        if len(v) != n:
                            raise ValueError(
                                f"{name} has {len(v)} entries, expected {n}")
                        return v
                    return [v] * n  # scalar broadcasts

                weather = [w or "Sunny" for w in col("weather", "Sunny")]
                traffic = [t or "Low" for t in col("traffic", "Low")]
                age = [float(a or 30) for a in col("driver_age", 30.0)]
                pickup = col("pickup_time", None)
            # Bad entry TYPES are client errors: 400, not a downstream
            # 503 that reads like a model outage.
            for name, vals in (("weather", weather), ("traffic", traffic)):
                for v in vals:
                    if not isinstance(v, str):
                        raise ValueError(f"{name} entries must be strings")
            for p in pickup:
                if p is not None and not isinstance(p, str):
                    raise ValueError("pickup_time entries must be ISO strings")
        except (TypeError, ValueError, AttributeError) as e:
            # AttributeError: non-dict items / summary ("items": ["foo"])
            return {"error": f"malformed batch: {e}"}, 400
        try:
            minutes, iso, bands = eta.predict_eta_batch(
                weather=weather, traffic=traffic, distance_m=distance,
                pickup_time=pickup, driver_age=age, return_quantiles=True)
        except DeadlineExceeded:
            raise  # → 504 via the WSGI layer, not a 503 "model outage"
        except Exception as e:
            _log.error("predict_batch_failed", error=str(e))
            minutes = None
        if minutes is None:
            return {"error": "model unavailable"}, 503
        # Non-finite rows serialize as null in BOTH columns (NaN is
        # invalid JSON; its timestamp is NaT). Vectorized serialization,
        # with the per-element loop only for rows that carry NaN.
        minutes = np.asarray(minutes, np.float64)
        finite = np.isfinite(minutes)
        rounded = np.round(minutes, 4)
        out = {"count": len(distance)}
        if bool(finite.all()):
            out["eta_minutes_ml"] = rounded.tolist()
            out["eta_completion_time_ml"] = np.asarray(iso).tolist()
        else:
            out["eta_minutes_ml"] = [float(m) if ok else None
                                     for m, ok in zip(rounded, finite)]
            out["eta_completion_time_ml"] = [str(s) if ok else None
                                             for s, ok in zip(iso, finite)]
        for level, vals in bands.items():  # additive uncertainty columns
            vals = np.asarray(vals, np.float64)
            ok_col = finite & np.isfinite(vals)
            col = np.round(vals, 4)
            out[f"eta_minutes_ml_{level}"] = (
                col.tolist() if bool(ok_col.all())
                else [float(v) if ok else None
                      for v, ok in zip(col, ok_col)])
        return out, 200

    @app.route("/api/predict", methods=("POST",))
    def predict_alias(request):
        """The Laravel-proxy contract: ONE endpoint accepting either the
        single-row ``/api/predict_eta`` body or the batch forms,
        dispatched on shape (the parsed body is memoized on the
        request, so delegating does not re-parse)."""
        body = get_json(request) or {}
        if "items" in body or isinstance(body.get("distance_m"), list):
            return predict_eta_batch(request)
        return predict_eta(request)

    # ── pages (the reference frontend's layout: "/" the point-to-point
    # map, "/ui" the dispatch dashboard, "/health" the status page) ─────

    pages = {}
    for name in ("dashboard", "mvp", "health"):
        with open(os.path.join(_STATIC_DIR, name + ".html"), "rb") as f:
            pages[name] = f.read()  # immutable assets: read once
    lib_dir = os.path.join(_STATIC_DIR, "lib")
    lib_files = {}
    for name in sorted(os.listdir(lib_dir)):
        if name.endswith(".js"):
            with open(os.path.join(lib_dir, name), "rb") as f:
                lib_files[name] = f.read()

    @app.route("/lib/<name>", methods=("GET",))
    def lib_js(request, name):
        body = lib_files.get(name)
        if body is None:
            return {"error": "not found"}, 404
        return Response(body, content_type="text/javascript; charset=utf-8")

    @app.route("/", methods=("GET",))
    def mvp_page(request):
        return Response(pages["mvp"], content_type=_HTML)

    @app.route("/ui", methods=("GET",))
    def dashboard(request):
        return Response(pages["dashboard"], content_type=_HTML)

    @app.route("/health", methods=("GET",))
    def health_page(request):
        return Response(pages["health"], content_type=_HTML)

    @app.route("/api/ping", methods=("GET",))
    def ping(request):
        return {"ok": True, "service": "route-optimizer"}, 200

    @app.route("/up", methods=("GET",))
    def up(request):
        # Laravel's stock health endpoint (reference bootstrap/app.php:12):
        # plain HTTP 200, no body contract beyond "the app is up".
        return Response(b"OK", content_type=_HTML)

    @app.route("/api/version", methods=("GET",))
    def version_info(request):
        # Which build and which model bytes this replica serves.
        return {
            "version_label": os.environ.get("RTPU_VERSION"),
            "build": build_info(),
            "model": {
                "available": eta.available,
                "generation": eta.generation,
                "fingerprint": eta.fingerprint,
                "path": eta.model_path,
                "kernel": eta.kernel,
                "quantiles": list(eta.quantiles),
                "loaded_unix": eta.loaded_unix,
            },
        }, 200

    @app.route("/api/metrics", methods=("GET",))
    def metrics(request):
        # Per-route latency percentiles + batcher gauges, plus the
        # process registry; ?format=prometheus renders the same data in
        # the exposition format.
        snapshot = {"http": app.request_stats.snapshot(),
                    "batcher": eta.stats}
        if request.args.get("format") == "prometheus":
            text = _prometheus_text(snapshot) + \
                get_registry().prometheus_text()
            return Response(text, 200, content_type=(
                "text/plain; version=0.0.4; charset=utf-8"))
        snapshot["registry"] = get_registry().snapshot()
        return snapshot, 200

    @app.route("/api/health", methods=("GET",))
    def health(request):
        t0 = time.time()
        bus_ok = bus.ping()
        bus_res = {"status": "ok" if bus_ok else "error",
                   "latency_ms": int((time.time() - t0) * 1000),
                   "backend": bus.kind}
        t0 = time.time()
        store_ok = store.ping()
        store_res = {"status": "ok" if store_ok else "error",
                     "latency_ms": int((time.time() - t0) * 1000),
                     "backend": store.kind}
        # Breaker state + journal depth: a store with journaled writes
        # is "degraded", not "ok" — history may lag.
        resilience = getattr(store, "resilience", None)
        if resilience is not None:
            store_res["resilience"] = resilience()
            if store_ok and getattr(store, "degraded", False):
                store_res["status"] = "degraded"
        engine_res = {"status": "ok", "latency_ms": 0,
                      "engine": f"torch-{eta.device.type}",
                      "mesh": eta.mesh_info()}
        # Road-router gauge, only once a router has been built on the
        # app's device (probing would build the graph on a health
        # check): which leg pricers are live, over what graph.
        router = road_router._default_routers.get(
            str(torch.device(device)))
        if router is not None:
            engine_res["road_router"] = {
                "nodes": int(router.n_nodes),
                "edges": int(len(router.senders)),
                "leg_cost_model": router.leg_cost_model,
                "transformer": bool(router.has_transformer),
                **router.solver_info,
            }
        # Live-traffic gauge (absent when RTPU_LIVE is off): armed state,
        # estimator coverage and the serving metric epoch.
        if app.live is not None:
            live_snap = app.live.snapshot()
            engine_res["live"] = {
                "ready": live_snap.get("ready", False),
                "epoch": live_snap.get("epoch", 0),
                "edges_observed": live_snap.get(
                    "ingest", {}).get("edges_observed", 0),
                "confidence_mean": live_snap.get(
                    "ingest", {}).get("confidence_mean", 0.0),
                "flips": live_snap.get(
                    "customize", {}).get("flips", 0),
                **({"error": live_snap["error"]}
                   if live_snap.get("error") else {}),
            }
        # Device-efficiency gauge: the goodput watchdog's armed state, or
        # why not (a missing or foreign-backend kernel record).
        from routest_tpu_torch.obs.efficiency import get_ledger

        if get_ledger().enabled or app.efficiency is not None:
            engine_res["efficiency"] = (
                app.efficiency.health() if app.efficiency is not None
                else {"ledger": get_ledger().enabled,
                      "watchdog": "disabled"})
        model_res = {"status": "ok" if eta.available else "degraded",
                     "generation": eta.generation,
                     "fingerprint": eta.fingerprint,
                     "scoring": eta.scoring_info(),
                     **({"error": eta.load_error} if eta.load_error else {})}
        overall = ("ok" if model_res["status"] == "ok"
                   and store_res["status"] == "ok"
                   and bus_res["status"] == "ok" else "degraded")
        return {
            "backend": True,
            "checks": {
                "engine": engine_res,
                "bus": bus_res,
                "store": store_res,
                "model": model_res,
                "device": {"batcher": eta.stats,
                           "uptime_s": int(time.time() - started)},
            },
            "status": overall,
            "version": config.serve.version,
        }, 200  # always 200: degraded-not-down

    _mount_observability(app, config, eta, device)
    _warm_optimizer(device)
    return app


def _arm_observability(app: App, config: Config, bus) -> None:
    """The replica's observability spine, as the JAX app arms it: the
    flight recorder, the change ledger on the bus (local events fanned
    out, foreign ones ingested), the SLO engine over this app's request
    stats (its page edge writes a bundle), the metric timeline and its
    anomaly watcher, the triggered profiler (armed by the SLO's upward
    edges) and the goodput watchdog against the port's kernel record.
    The tickers run on daemon threads; ``app.close()`` stops them."""
    from routest_tpu_torch.core.config import load_efficiency_config
    from routest_tpu_torch.obs.efficiency import (EfficiencyWatchdog,
                                                  get_ledger)
    from routest_tpu_torch.obs.ledger import (get_change_ledger,
                                              replica_label)
    from routest_tpu_torch.obs.profiler import TriggeredProfiler
    from routest_tpu_torch.obs.recorder import get_recorder
    from routest_tpu_torch.obs.slo import build_replica_engine
    from routest_tpu_torch.obs.timeline import AnomalyWatcher, TimelineStore

    recorder = get_recorder()
    app.change_ledger = get_change_ledger()
    app.change_ledger.set_context(
        replica=replica_label(),
        version=os.environ.get("RTPU_VERSION") or None)
    if app.change_ledger.enabled:
        app.change_ledger.attach_bus(bus)
    recorder.register_change_ledger(app.change_ledger)

    app.slo = None
    if config.slo.enabled:
        app.slo = build_replica_engine(app.request_stats.registry,
                                       config.slo)
        app.slo.on_page.append(recorder.on_slo_page)
        recorder.register_slo_engine(app.slo)
        if config.slo.tick_s > 0:
            app.slo.start()

    app.timeline = None
    app.watcher = None
    if config.timeline.enabled:
        app.timeline = TimelineStore(
            [app.request_stats.registry, get_registry()],
            config.timeline, component="replica")
        recorder.register_timeline(app.timeline)
        if config.timeline.watch:
            app.watcher = AnomalyWatcher(app.timeline, config.timeline,
                                         recorder).attach()
        app.timeline.start()

    app.profiler = None
    if config.profile.enabled:
        app.profiler = TriggeredProfiler(config.profile, recorder,
                                         component="replica",
                                         device=config.serve.device)
        if app.slo is not None:
            app.slo.on_warn.append(app.profiler.on_slo_edge)

    # Goodput: the ledger is always-on accounting inside the batchers;
    # the watchdog pins the port's kernel record. A missing or
    # foreign-backend record degrades to ledger-only, named in
    # /api/health and /api/efficiency.
    get_ledger().bind_device(config.serve.device)
    app.efficiency = None
    app.efficiency_config = eff_cfg = load_efficiency_config()
    if eff_cfg.enabled and eff_cfg.watchdog:
        app.efficiency = EfficiencyWatchdog(eff_cfg, recorder=recorder)
        if app.efficiency.arm():
            app.efficiency.start()

    def close() -> None:
        """Stop the app's background threads: the SLO and timeline
        tickers, the watchdog, the change-ledger tap and the dispatch
        re-optimization loop."""
        for part in (app.slo, app.timeline, app.efficiency,
                     app.change_ledger):
            if part is not None:
                part.stop()
        dispatch = getattr(app, "dispatch", None)
        if dispatch is not None and dispatch.reopt is not None:
            dispatch.reopt.stop()

    app.close = close


def _mount_observability(app: App, config: Config, eta: EtaService,
                         device) -> None:
    """The nine observability routes of the JAX app: ``/api/trace``,
    ``/api/slo``, ``/api/efficiency``, ``/api/changes``,
    ``/api/incidents``, ``/api/timeline``, ``POST /api/debug/profile``,
    ``GET /api/debug/probe_subgraph`` and ``POST /api/debug/snapshot``."""
    import json

    from routest_tpu_torch.core.config import load_prober_config
    from routest_tpu_torch.data.road_graph import haversine_np
    from routest_tpu_torch.obs import to_chrome_trace
    from routest_tpu_torch.obs.efficiency import get_ledger
    from routest_tpu_torch.obs.recorder import get_recorder
    from routest_tpu_torch.obs.trace import get_tracer

    def _num(request, name):
        raw = request.args.get(name)
        if not raw:
            return None
        try:
            return float(raw)
        except ValueError:
            return None

    @app.route("/api/trace", methods=("GET",))
    def trace_dump(request):
        # Span flight recorder: raw span JSON by default; ?format=chrome
        # emits Trace Event JSON (chrome://tracing / Perfetto);
        # ?trace_id= narrows to one request's tree; ?limit=N tails it.
        buf = get_tracer().buffer
        spans = buf.snapshot(trace_id=request.args.get("trace_id") or None)
        raw_limit = request.args.get("limit", "")
        if raw_limit.isdigit():
            spans = spans[-int(raw_limit):]
        payload = (to_chrome_trace(spans)
                   if request.args.get("format") == "chrome"
                   else {"count": len(spans), "dropped": buf.dropped,
                         "spans": spans})
        # default=str: span attrs are caller-supplied — a dump endpoint
        # must render them, not 500.
        return Response(json.dumps(payload, default=str), 200,
                        content_type="application/json")

    @app.route("/api/slo", methods=("GET",))
    def slo_state(request):
        # Burn-rate alert surface; a request forces a fresh tick.
        if app.slo is None:
            return {"enabled": False}, 200
        app.slo.tick()
        return app.slo.snapshot(), 200

    @app.route("/api/efficiency", methods=("GET",))
    def efficiency_state(request):
        # Device goodput: per-program real/padded/cached rows, live
        # per-bucket windows, the watchdog's pin and verdicts (a request
        # forces a fresh watchdog tick).
        out = {"enabled": get_ledger().enabled,
               "ledger": get_ledger().snapshot()}
        wd = app.efficiency
        if wd is None:
            out["watchdog"] = {"armed": False,
                               "status": "disabled"
                               if not app.efficiency_config.watchdog
                               else "unarmed"}
        else:
            if wd.armed:
                wd.tick()
            out["watchdog"] = wd.snapshot()
        return out, 200

    @app.route("/api/changes", methods=("GET",))
    def changes_query(request):
        # Newest-first state-change events with label filtering.
        limit = _num(request, "limit")
        out = app.change_ledger.query(
            kind=request.args.get("kind") or None,
            replica=request.args.get("replica") or None,
            version=request.args.get("version") or None,
            region=request.args.get("region") or None,
            bucket=request.args.get("bucket") or None,
            since=_num(request, "since"),
            limit=int(limit) if limit else None)
        out["ledger"] = app.change_ledger.snapshot()
        return out, 200

    @app.route("/api/incidents", methods=("GET",))
    def incidents_query(request):
        # Recent flight-recorder pages, each with its ranked suspects.
        incidents = get_recorder().incidents_snapshot()
        return {"enabled": app.change_ledger.enabled,
                "count": len(incidents), "incidents": incidents}, 200

    @app.route("/api/timeline", methods=("GET",))
    def timeline_query(request):
        # Windowed deltas/percentiles from the in-process rings.
        if app.timeline is None:
            return {"enabled": False}, 200
        out = app.timeline.query(
            family=request.args.get("family") or None,
            window_s=_num(request, "window"), step_s=_num(request, "step"))
        out["enabled"] = True
        if app.watcher is not None:
            out["watcher"] = app.watcher.snapshot()
        return out, 200

    @app.route("/api/debug/profile", methods=("POST",))
    def debug_profile(request):
        # Arms a bounded stack-sample capture (plus a torch.profiler
        # trace under RTPU_PROFILE_DEVICE=1, whose start it waits for,
        # so a refused capture is named in this answer); the result
        # lands as a flight-recorder bundle. 202 armed / 409 when one
        # is running or the budget is spent.
        if app.profiler is None:
            return {"error": "profiler disabled"}, 503
        body = get_json(request) or {}
        duration = body.get("duration_s")
        if duration is not None and not isinstance(duration, (int, float)):
            return {"error": "duration_s must be a number"}, 400
        armed = app.profiler.arm("manual_api", {"source": "api"},
                                 duration_s=duration, wait_start_s=30.0)
        return ({"armed": armed, "profiler": app.profiler.snapshot()},
                202 if armed else 409)

    @app.route("/api/debug/probe_subgraph", methods=("GET",))
    def probe_subgraph(request):
        # The prober's oracle feed: the road graph's edge topology in
        # graph edge order plus the probe waypoints' snapped nodes and
        # snap distances, bounded by RTPU_PROBER_SUBGRAPH_MAX_EDGES.
        router = road_router._default_routers.get(str(torch.device(device)))
        if router is None:
            return {"error": "no road router built"}, 503
        n_edges = int(len(router.senders))
        max_edges = load_prober_config().subgraph_max_edges
        if n_edges > max_edges:
            return {"error": f"graph too large to export ({n_edges} "
                             f"edges > RTPU_PROBER_SUBGRAPH_MAX_EDGES="
                             f"{max_edges})"}, 413
        latlon = []
        for raw in request.arg_list("wp"):
            lat, sep, lon = raw.partition(",")
            try:
                if not sep:
                    raise ValueError(raw)
                latlon.append((float(lat), float(lon)))
            except ValueError:
                return {"error": f"malformed wp {raw!r}: want "
                                 "lat,lon"}, 400
        out = {
            "nodes": int(router.n_nodes),
            "edges": n_edges,
            "senders": np.asarray(router.senders).tolist(),
            "receivers": np.asarray(router.receivers).tolist(),
            "snapped": [],
            "snap_m": [],
        }
        if latlon:
            pts = np.asarray(latlon, np.float32)
            snapped = np.asarray(router.snap(pts), np.int64)
            snap_m = haversine_np(
                pts[:, 0].astype(np.float64),
                pts[:, 1].astype(np.float64),
                router.coords[snapped, 0], router.coords[snapped, 1])
            out["snapped"] = snapped.tolist()
            out["snap_m"] = [round(float(v), 3) for v in snap_m]
        return out, 200

    @app.route("/api/debug/snapshot", methods=("POST",))
    def debug_snapshot(request):
        # Manual postmortem trigger; force=True bypasses the rate limit,
        # the disk bounds hold.
        rec = get_recorder()
        bundle = rec.trigger("manual_api", {"source": "api"}, force=True)
        if bundle is None:
            return {"error": "recorder disabled or bundle write failed",
                    "recorder": rec.snapshot()}, 503
        return {"bundle": bundle, "recorder": rec.snapshot()}, 200


_warmed_devices = set()
_warm_lock = threading.Lock()


def _warm_optimizer(device) -> None:
    """Run one 1-, 3- and 10-stop optimize (the point-to-point, typical
    and the UI's largest request) through the engine on ``device``, so
    the first customer request at each count pays no CUDA context,
    allocator or library warm-up. Process-wide: each device warms once
    per process, however many apps are built. ``ROUTEST_WARM_BUCKETS=0``
    opts out. A failure (no card for a ``cuda`` app) logs and leaves the
    lazy path: optimize requests then raise as they would unwarmed."""
    if os.environ.get("ROUTEST_WARM_BUCKETS", "1") == "0":
        return
    key = str(torch.device(device))
    with _warm_lock:
        if key in _warmed_devices:
            return
        t0 = time.time()
        try:
            for n in (1, 3, 10):
                optimize_route({
                    "source_point": {"lat": 14.5836, "lon": 121.0409},
                    "destination_points": [
                        {"lat": 14.55 + 0.002 * i, "lon": 121.05,
                         "payload": 1} for i in range(n)],
                    "driver_details": {"vehicle_type": "car",
                                       "vehicle_capacity": 9e9,
                                       "maximum_distance": 9e9},
                }, device=device)
        except Exception as e:
            _log.warning("optimizer_warm_failed", device=key,
                         error=f"{type(e).__name__}: {e}")
            return
        _warmed_devices.add(key)
    _log.info("optimizer_warmed", device=key, shapes=[1, 3, 10],
              seconds=round(time.time() - t0, 2))


def _persist(store, payload: dict, feature: dict) -> Optional[str]:
    """Write request+result rows (``Flaskr/routes.py:134-182`` shape)."""
    meta = payload.get("meta") or {}
    driver = payload.get("driver_details") or {}
    req_row = {
        "origin_id": meta.get("origin_id"),
        "stops": {
            "destination_ids": meta.get("destination_ids") or [],
            "destination_points": payload.get("destination_points") or [],
        },
        "status": "completed",
        "engine": "ml" if payload.get("use_ml_eta") else "default",
        "vehicle_id": driver.get("driver_name"),
        "driver_age": driver.get("driver_age"),
    }
    request_id = store.insert_request(req_row)

    props = (feature or {}).get("properties", {}) or {}
    summary = props.get("summary", {}) or {}
    store.insert_result({
        "request_id": request_id,
        "total_distance": float(summary.get("distance") or 0),
        "total_duration": float(summary.get("duration") or 0),
        "optimized_order": props.get("optimized_order") or [],
        "legs": props.get("segments", []) or [],
        "geometry": feature.get("geometry") or None,
        "eta_minutes_ml": props.get("eta_minutes_ml"),
        "eta_completion_time_ml": props.get("eta_completion_time_ml"),
    })
    return request_id


def _prometheus_text(snapshot: dict) -> str:
    """metrics snapshot → Prometheus exposition format (text/plain
    0.0.4). Route labels are sanitized; numeric leaves only."""

    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")

    lines = [
        "# HELP routest_http_uptime_seconds Server uptime.",
        "# TYPE routest_http_uptime_seconds gauge",
        f"routest_http_uptime_seconds "
        f"{snapshot['http'].get('uptime_s', 0)}",
    ]
    route_keys = ("count", "errors", "mean_ms", "p50_ms", "p95_ms", "p99_ms")
    for key in route_keys:
        metric = f"routest_http_route_{key}"
        kind = "counter" if key in ("count", "errors") else "gauge"
        lines.append(f"# TYPE {metric} {kind}")
        for route, s in sorted(snapshot["http"].get("routes", {}).items()):
            if key in s:
                lines.append(
                    f'{metric}{{route="{esc(route)}"}} {s[key]}')
    lines.append("# TYPE routest_batcher gauge")
    for key, val in sorted(snapshot.get("batcher", {}).items()):
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, (int, float)):
            lines.append(f'routest_batcher{{stat="{esc(key)}"}} {val}')
    return "\n".join(lines) + "\n"


def _dispatch_service(config: Config, app, bus, sim_tick_range):
    """The dispatch service of ``app``: registry, batcher and (with
    ``RTPU_DISPATCH_REOPT``) the re-optimization loop, solving on
    ``config.serve.device``. The loop's thread runs when
    ``reopt_poll_s > 0``; 0 leaves ticks to the caller."""
    from types import SimpleNamespace

    from routest_tpu_torch.dispatch import (DispatchBatcher,
                                            DispatchRegistry, ReoptLoop)

    cfg = config.dispatch
    device = config.serve.device

    def live_epoch() -> int:
        live = app.live
        if live is not None and live.router is not None:
            return int(live.router.live_epoch)
        return 0

    def corridor_matrix(latlon, speed_mps=None):
        """(N+1, 2) lat/lon → (N+1, N+1) float32 travel SECONDS under
        the CURRENT metric: road-router shortest paths priced by the
        live leg models when the live router is armed, great-circle ×
        the car road factor otherwise (on the serving device). One unit
        everywhere, so a dispatch's baseline cost and its re-priced
        corridor cost stay comparable across metric flips."""
        latlon = np.asarray(latlon, np.float32)
        car = geo.profile_for_vehicle("car")
        speed = float(speed_mps or cfg.speed_mps
                      or geo.PROFILE_SPEED_MPS[car])
        live = app.live
        if live is not None and live.ready and live.router is not None:
            legs = live.router.route_legs(latlon)
            return np.asarray(legs.duration_matrix(), np.float32)
        dist_m = geo.distance_matrix_m(
            torch.from_numpy(latlon).to(resolve_device(device, "dispatch")),
            geo.PROFILE_ROAD_FACTOR[car]).cpu().numpy()
        return (dist_m / speed).astype(np.float32)

    def sim_restart(rec) -> None:
        """plan_update → re-target the driver sim at the NEW stop order,
        replaying under the dispatch's stored sim_seed (None keeps the
        reference's random gait)."""
        if rec.latlon is None \
                or not rec.driver_details.get("driver_name") \
                or not rec.driver_details.get("vehicle_type"):
            return
        order = list(rec.plan.get("optimized_order") or []) \
            + list(rec.plan.get("spill_lane") or [])
        coords = [[float(rec.latlon[0][1]), float(rec.latlon[0][0])]]
        coords += [[float(rec.latlon[j + 1][1]),
                    float(rec.latlon[j + 1][0])] for j in order]
        coords.append(list(coords[0]))
        speed = float(rec.driver_details.get("speed_mps") or 1.0)
        data = {
            "route_details": {
                "geometry": {"coordinates": coords},
                "properties": {
                    "summary": {
                        "duration": round(rec.baseline_cost, 1),
                        "distance": round(rec.baseline_cost * speed, 1),
                        "trips": rec.plan.get("n_trips", 1),
                    },
                    "destinations": rec.destinations or [],
                },
            },
            "driver_details": rec.driver_details,
        }
        sim.start_simulation(data, bus.publish, sim_tick_range,
                             seed=rec.sim_seed)

    registry = DispatchRegistry(max_active=cfg.max_active)
    batcher = DispatchBatcher(max_rows=cfg.max_rows, window_s=cfg.window_s,
                              epoch_fn=live_epoch, device=device)
    reopt = None
    if cfg.reopt:
        reopt = ReoptLoop(registry, batcher, bus.publish, live_epoch,
                          corridor_matrix, degrade_ratio=cfg.degrade_ratio,
                          poll_s=cfg.reopt_poll_s, sim_restart=sim_restart)
        if cfg.reopt_poll_s > 0:
            reopt.start()
    return SimpleNamespace(cfg=cfg, registry=registry, batcher=batcher,
                           reopt=reopt, matrix_fn=corridor_matrix,
                           epoch_fn=live_epoch, sim_restart=sim_restart)


def _parse_windows(body: dict, n: int):
    """``time_windows``: list of N ``[open_s, close_s|null]`` pairs →
    (tw_open, tw_close) float32 arrays, (None, None) when absent, or
    ``{"error"}``. A null close means "no deadline" (``NO_WINDOW``);
    non-finite values are client errors — a NaN window would poison the
    feasibility mask."""
    raw = body.get("time_windows")
    if raw is None:
        return None, None
    if not isinstance(raw, list) or len(raw) != n:
        return {"error": f"time_windows must be a list of {n} "
                         "[open_s, close_s] pairs"}, None
    opens, closes = [], []
    for tw in raw:
        if not isinstance(tw, (list, tuple)) or len(tw) != 2:
            return {"error": "each time window must be "
                             "[open_s, close_s]"}, None
        o, c = tw
        try:
            o = float(o or 0)
            c = NO_WINDOW if c is None else float(c)
        except (TypeError, ValueError):
            return {"error": "time window bounds must be numeric"}, None
        if not (math.isfinite(o) and (c == NO_WINDOW or math.isfinite(c))):
            return {"error": "time window bounds must be finite"}, None
        opens.append(o)
        closes.append(min(c, NO_WINDOW))
    return (np.asarray(opens, np.float32), np.asarray(closes, np.float32))


def _parse_matrix_dispatch(body: dict, max_stops: int) -> dict:
    """Matrix-mode dispatch body → problem fields or ``{"error"}``."""
    matrix = body.get("matrix")
    if not isinstance(matrix, list) or len(matrix) < 2:
        return {"error": "matrix must be a square cost matrix "
                         "(row/col 0 = depot) with at least one stop"}
    n = len(matrix) - 1
    if n > max_stops:
        return {"error": f"too many stops (max {max_stops})"}
    try:
        m = np.asarray(matrix, np.float32)
    except ValueError:
        return {"error": "matrix must be numeric and square"}
    if m.shape != (n + 1, n + 1) or not np.isfinite(m).all():
        return {"error": "matrix must be numeric, square and finite"}
    demands = body.get("demands")
    if not isinstance(demands, list) or len(demands) != n:
        return {"error": f"demands must be a list of {n} numbers"}
    try:
        dem = np.asarray([float(d or 0) for d in demands], np.float32)
        capacity = float(body.get("capacity", 9e12))
        max_cost = float(body.get("max_distance", 9e12))
    except (TypeError, ValueError):
        return {"error": "demands/capacity/max_distance must be numeric"}
    if not (np.isfinite(dem).all() and math.isfinite(capacity)
            and math.isfinite(max_cost)):
        return {"error": "demands/capacity/max_distance must be finite"}
    tw_open, tw_close = _parse_windows(body, n)
    if isinstance(tw_open, dict):
        return tw_open
    return {"mode": "matrix", "matrix": m, "demands": dem,
            "capacity": capacity, "max_cost": max_cost,
            "tw_open": tw_open, "tw_close": tw_close, "latlon": None,
            "driver_details": _obj(body.get("driver_details")),
            "destinations": None}


def _parse_geo_dispatch(body: dict, max_stops: int) -> dict:
    """Geographic dispatch body → problem fields or ``{"error"}``.
    Shares the optimizer's body validation, so a malformed dispatch
    fails exactly like a malformed optimize_route."""
    p = _parse_problem(body)
    if "error" in p:
        return p
    if len(p["destinations"]) > max_stops:
        return {"error": f"too many stops (max {max_stops})"}
    tw_open, tw_close = _parse_windows(body, len(p["destinations"]))
    if isinstance(tw_open, dict):
        return tw_open
    return {"mode": "geographic", "latlon": p["latlon"],
            "demands": p["demands"], "capacity": p["cap"],
            "max_dist": p["max_dist"], "speed": p["speed"],
            "tw_open": tw_open, "tw_close": tw_close,
            "driver_details": p["driver_details"],
            "destinations": p["destinations"]}


def _register_confirmed_route(svc, data: dict, seed):
    """Best-effort: register a confirm_route body's route as an active
    dispatch so the re-optimization loop watches its corridor. Needs
    lat/lon on every destination and finite constraints; returns None
    (the caller keeps the reference's answer) when the body cannot
    support a re-solve. The confirmed stop ORDER is the baseline plan."""
    from routest_tpu_torch.dispatch import plan_cost

    route = _obj(data["route_details"])
    driver = dict(_obj(data["driver_details"]))
    props = _obj(route.get("properties"))
    dests = props.get("destinations")
    if not isinstance(dests, list) or not dests:
        return None
    coords = _obj(route.get("geometry")).get("coordinates")
    try:
        origin = [float(coords[0][1]), float(coords[0][0])]  # lonlat row
        latlon = np.asarray(
            [origin] + [[float(d["lat"]), float(d["lon"])] for d in dests],
            np.float32)
        demands = np.asarray(
            [float(_obj(d).get("payload", 0) or 0) for d in dests],
            np.float32)
        capacity = float(driver.get("vehicle_capacity", 9e12))
        max_dist = float(driver.get("maximum_distance", 9e12))
    except (KeyError, TypeError, ValueError, IndexError):
        return None
    if not (np.isfinite(latlon).all() and np.isfinite(demands).all()
            and math.isfinite(capacity) and math.isfinite(max_dist)):
        return None
    profile = geo.profile_for_vehicle(
        str(driver.get("vehicle_type") or "car").lower().strip())
    speed = float(svc.cfg.speed_mps or geo.PROFILE_SPEED_MPS[profile])
    driver.setdefault("speed_mps", round(speed, 3))
    matrix = svc.matrix_fn(latlon, speed_mps=speed)
    plan = {"trips": [list(range(len(dests)))],
            "optimized_order": list(range(len(dests))),
            "n_trips": 1, "spill_lane": [], "spilled": [],
            "penalty": 0.0, "unroutable": []}
    return svc.registry.register(
        channel=driver.get("driver_name"), latlon=latlon,
        demands=demands, capacity=capacity, max_cost=max_dist / speed,
        plan=plan, baseline_cost=plan_cost(matrix, plan),
        epoch=svc.epoch_fn(), sim_seed=seed, driver_details=driver,
        destinations=dests, source="confirm_route")
