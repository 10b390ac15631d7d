"""The serving application for the ETA path, on the card.

The ETA routes of ``routest_tpu/serve/app.py::create_app`` with the same
status codes, keys and error strings: ``POST /api/predict_eta``,
``POST /api/predict_eta_batch`` (JSON), the ``POST /api/predict`` proxy
alias, ``GET /api/ping`` and ``GET /api/health``. Health keeps the
degraded-not-down contract (always HTTP 200) and reports the scoring
path (``checks.model.scoring``) and the device (``checks.engine.mesh``).
The route-optimization, store and bus endpoints arrive with the next
slices.
"""

from __future__ import annotations

import datetime as dt
import time
from typing import Optional

import numpy as np

from routest_tpu_torch.core.config import Config, load_config
from routest_tpu_torch.serve.deadline import DeadlineExceeded
from routest_tpu_torch.serve.ml_service import EtaService
from routest_tpu_torch.serve.wsgi import App, get_json
from routest_tpu_torch.train.checkpoint import default_model_path
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.serve")

# Largest batch one request may carry (rows), checked before any
# per-row work.
MAX_BATCH_ROWS = 131_072


def _obj(value) -> dict:
    """A client-supplied field that SHOULD be an object, defensively:
    non-dict values degrade to {} so handlers fall into their normal
    missing-field defaults instead of AttributeError 500s."""
    return value if isinstance(value, dict) else {}


def create_app(config: Optional[Config] = None,
               eta_service: Optional[EtaService] = None) -> App:
    config = config or load_config()
    eta = eta_service if eta_service is not None else EtaService(
        config.serve, model_path=default_model_path(config.model))
    started = time.time()
    app = App()
    app.eta = eta  # for tests / introspection

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
        """
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

    @app.route("/api/ping", methods=("GET",))
    def ping(request):
        return {"ok": True, "service": "route-optimizer"}, 200

    @app.route("/api/health", methods=("GET",))
    def health(request):
        engine_res = {"status": "ok", "latency_ms": 0,
                      "engine": f"torch-{eta.device.type}",
                      "mesh": eta.mesh_info()}
        model_res = {"status": "ok" if eta.available else "degraded",
                     "generation": eta.generation,
                     "fingerprint": eta.fingerprint,
                     "scoring": eta.scoring_info(),
                     **({"error": eta.load_error} if eta.load_error else {})}
        overall = "ok" if model_res["status"] == "ok" else "degraded"
        return {
            "backend": True,
            "checks": {
                "engine": engine_res,
                "model": model_res,
                "device": {"batcher": eta.stats,
                           "uptime_s": int(time.time() - started)},
            },
            "status": overall,
            "version": config.serve.version,
        }, 200  # always 200: degraded-not-down

    return app
