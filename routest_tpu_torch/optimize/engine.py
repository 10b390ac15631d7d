"""The routing engine: ORS-shaped results computed on the device.

The counterpart of ``routest_tpu/optimize/engine.py`` for great-circle
legs: the distance matrix (one batched haversine), the greedy multi-trip
order with its refiners, and the top-k alternatives run on the device;
geometry, segments and the summary are assembled on the host. Output is
the same GeoJSON Feature (``properties.optimized_order``, ``source``,
``destinations``, ``segments[].steps[]``, ``summary``, ``bbox``, the
vehicle/driver annotations), and errors the same ``{"error": ...}``
dicts. ``properties.engine`` reads ``backend:torch-<device>``.

With ``road_graph: true`` legs are true shortest paths over the street
network (``optimize/road_router.py``): street-following geometry, leg
durations from the road GNN at the pickup hour, re-priced in route
context by the route transformer, and ``leg_cost_model`` naming the
pricer.

Every entry point takes ``device`` (None → ``load_config().serve.device``,
``cuda`` by default) and raises when the card is asked for and missing.
"""

from __future__ import annotations

import datetime as dt
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from routest_tpu_torch.core.config import resolve_device
from routest_tpu_torch.data import geo
from routest_tpu_torch.optimize.ranking import rank_routes
from routest_tpu_torch.optimize.road_router import default_router
from routest_tpu_torch.optimize.vrp import solve_host, solve_host_batch

MAX_MATRIX_POINTS = 64
MAX_BATCH_PROBLEMS = 256

_COMPASS = ("north", "north-east", "east", "south-east",
            "south", "south-west", "west", "north-west")


def engine_tag(device: torch.device) -> str:
    return f"backend:torch-{device.type}"


def _compass(bearing: float) -> str:
    return _COMPASS[int(((bearing + 22.5) % 360.0) // 45.0)]


def _leg_geometry(p0, p1, n_points: int = 24) -> np.ndarray:
    return geo.great_circle_interpolate(p0, p1, n_points)


def _leg_steps(p0, p1, name: str, distance_m: float, duration_s: float,
               wp_start: int, wp_end: int) -> List[Dict]:
    """ORS-shaped step list for one leg: depart instruction + arrival."""
    bearing = geo.bearing_deg(p0, p1)
    return [
        {
            "distance": round(distance_m, 1),
            "duration": round(duration_s, 1),
            "type": 11,  # depart
            "instruction": f"Head {_compass(bearing)} toward {name}",
            "name": "-",
            "way_points": [wp_start, wp_end],
        },
        {
            "distance": 0.0,
            "duration": 0.0,
            "type": 10,  # arrive
            "instruction": f"Arrive at {name}",
            "name": "-",
            "way_points": [wp_end, wp_end],
        },
    ]


def _pickup_hour(pickup_time) -> int:
    """Hour-of-day for leg pricing: ISO ``pickup_time`` if it parses,
    else now (the JAX engine's rule)."""
    if pickup_time:
        try:
            return dt.datetime.fromisoformat(str(pickup_time)).hour
        except ValueError:
            pass
    return dt.datetime.now().hour


def _stop_name(point: Dict, idx: Optional[int]) -> str:
    if point.get("name"):
        return str(point["name"])
    return "origin" if idx is None else f"stop {idx + 1}"


def _gc_legs(all_points: List[Dict], dist: np.ndarray, speed_mps: float):
    """Great-circle leg provider over the host copy of the matrix:
    duration = d/speed."""
    def leg_cost(a: int, b: int):
        return float(dist[a, b]), float(dist[a, b]) / speed_mps

    def leg_geom(a: int, b: int) -> List[List[float]]:
        pa, pb = all_points[a], all_points[b]
        return _leg_geometry((pa["lat"], pa["lon"]),
                             (pb["lat"], pb["lon"])).tolist()

    return leg_cost, leg_geom


def _build_trip_feature_parts(all_points: List[Dict], trip: Sequence[int],
                              leg_cost, leg_geom):
    """One trip (origin → stops → origin): geometry, segments, totals.
    ``leg_cost(a, b) -> (meters, seconds)``, ``leg_geom(a, b) ->
    [[lon, lat], …]``."""
    node_seq = [0] + [i + 1 for i in trip] + [0]
    coords: List[List[float]] = []
    segments: List[Dict] = []
    total_dist = 0.0
    total_dur = 0.0
    for a, b in zip(node_seq[:-1], node_seq[1:]):
        pa, pb = all_points[a], all_points[b]
        leg_m, leg_s = leg_cost(a, b)
        g = leg_geom(a, b)
        wp_start = len(coords)
        pts = g if not coords else g[1:]
        coords.extend(pts)
        wp_end = len(coords) - 1
        name = _stop_name(pb, b - 1 if b > 0 else None)
        segments.append(
            {
                "distance": round(leg_m, 1),
                "duration": round(leg_s, 1),
                "steps": _leg_steps((pa["lat"], pa["lon"]), (pb["lat"], pb["lon"]),
                                    name, leg_m, leg_s, wp_start, wp_end),
            }
        )
        total_dist += leg_m
        total_dur += leg_s
    return coords, segments, total_dist, total_dur


def _parse_problem(input_data: dict) -> dict:
    """Validate one optimize-route request body → either ``{"error"}``
    or the parsed problem dict (shared by the single and batch paths so
    a malformed item fails identically on both)."""
    if not input_data or not input_data.get("destination_points"):
        return {"error": "no destination points specified."}
    if not input_data.get("source_point"):
        return {"error": "no source point specified."}

    driver_details = input_data.get("driver_details") or {}
    if not isinstance(driver_details, dict):
        return {"error": "invalid driver_details: must be an object"}
    vehicle_type = driver_details.get("vehicle_type")
    vehicle_type = ((vehicle_type if isinstance(vehicle_type, str) else "car")
                    or "car").lower().strip()
    profile = geo.profile_for_vehicle(vehicle_type)

    source = input_data["source_point"]
    destinations = input_data["destination_points"]
    if not isinstance(destinations, (list, tuple)):
        return {"error": "invalid coordinates: each point needs numeric lat/lon"}

    try:
        cap = float(driver_details.get("vehicle_capacity", 9e12))
        max_dist = float(driver_details.get("maximum_distance", 9e12))
    except (TypeError, ValueError):
        return {"error": "invalid driver_details: vehicle_capacity/maximum_distance must be numeric"}
    # Non-finite constraints would make the solver's feasibility mask
    # vacuous (NaN compares False both ways; json.loads happily parses
    # NaN/Infinity) — reject up front, before any item reaches a solve.
    if not (math.isfinite(cap) and math.isfinite(max_dist)):
        return {"error": "invalid driver_details: vehicle_capacity/maximum_distance must be finite"}

    all_points = [source] + list(destinations)
    try:
        latlon = np.asarray([[float(p["lat"]), float(p["lon"])] for p in all_points],
                            dtype=np.float32)
    except (KeyError, TypeError, ValueError):
        return {"error": "invalid coordinates: each point needs numeric lat/lon"}
    if not np.isfinite(latlon).all():
        return {"error": "invalid coordinates: each point needs numeric lat/lon"}
    # Validate top_k UP FRONT: the same malformed value must fail the
    # same way on every path, before any matrix/solve work is spent.
    try:
        top_k = int(input_data.get("top_k", 0) or 0)
    except (TypeError, ValueError, OverflowError):  # int(inf) overflows
        return {"error": "top_k must be an integer"}
    try:
        demands = np.asarray(
            [float(p.get("payload", 0) or 0) for p in destinations],
            dtype=np.float32)
    except (TypeError, ValueError, AttributeError):
        return {"error": "invalid destination payload: must be numeric"}
    if not np.isfinite(demands).all():
        return {"error": "invalid destination payload: must be finite"}

    return {
        "source": source,
        "destinations": destinations,
        "all_points": all_points,
        "latlon": latlon,
        "demands": demands,
        "driver_details": driver_details,
        "vehicle_type": vehicle_type,
        "road_factor": geo.PROFILE_ROAD_FACTOR[profile],
        "speed": geo.PROFILE_SPEED_MPS[profile],
        "cap": cap,
        "max_dist": max_dist,
        "top_k": top_k,
        "refine": bool(input_data.get("refine")),
        "use_road": bool(input_data.get("road_graph")),
        "pickup_time": input_data.get("pickup_time"),
    }


def _car_time_scale(speed: float) -> float:
    """Road legs are priced for a car; other profiles scale by speed."""
    return geo.PROFILE_SPEED_MPS[geo.profile_for_vehicle("car")] / speed


def optimize_route(input_data: dict, device=None) -> dict:
    """Drop-in equivalent of the reference's optimizer entry point
    (``Flaskr/utils.py:10-48``): dict in, GeoJSON Feature (or error) out.
    The matrix (great-circle, or road-graph shortest paths with
    ``road_graph: true``) and the solve run on ``device``."""
    p = _parse_problem(input_data)
    if "error" in p:
        return p
    dev = resolve_device(device, "optimize_route")
    legs = None
    if p["use_road"]:
        legs = default_router(dev).route_legs(
            p["latlon"], _car_time_scale(p["speed"]),
            hour=_pickup_hour(p["pickup_time"]))
        dist = legs.dist_m
        leg_cost, leg_geom = _road_leg_fns(legs)
    else:
        dist = geo.distance_matrix_m(torch.from_numpy(p["latlon"]).to(dev),
                                     p["road_factor"])
        leg_cost, leg_geom = _gc_legs(p["all_points"], dist.cpu().numpy(),
                                      p["speed"])
    if len(p["destinations"]) == 1:
        return _finish_point_to_point(p, leg_cost, leg_geom, legs, dev)
    # Additive ABI: {"refine": true} runs the local searches on the
    # greedy order — strictly shorter or equal routes, same shape.
    sol = solve_host(dist, p["demands"], p["cap"], p["max_dist"],
                     refine=p["refine"], device=dev)
    return _assemble_multi(p, sol, dist, leg_cost, leg_geom, legs, dev)


def travel_matrix(input_data: dict, device=None) -> dict:
    """S×D great-circle travel matrix — the ORS capability the reference
    rents. ``{"points": [{"lat","lon"}, …]}`` → distances and durations
    between every pair (or the ``sources``/``destinations`` index
    subsets, ORS-style), great-circle × the vehicle profile's road
    factor, from one device matrix."""
    points = input_data.get("points") if isinstance(input_data, dict) else None
    if not isinstance(points, (list, tuple)) or len(points) < 2:
        return {"error": "points must be a list of at least 2 {lat, lon}"}
    if len(points) > MAX_MATRIX_POINTS:
        return {"error": f"too many points (max {MAX_MATRIX_POINTS})"}
    try:
        latlon = np.asarray([[float(p["lat"]), float(p["lon"])]
                             for p in points], dtype=np.float32)
    except (KeyError, TypeError, ValueError):
        return {"error": "invalid coordinates: each point needs numeric lat/lon"}
    if not np.isfinite(latlon).all():
        return {"error": "invalid coordinates: each point needs numeric lat/lon"}

    def _subset(key):
        idx = input_data.get(key)
        if idx is None:
            return list(range(len(points))), None
        if not isinstance(idx, (list, tuple)) or not idx:
            return None, {"error": f"{key} must be a non-empty index list"}
        if len(idx) > MAX_MATRIX_POINTS:
            # The points cap must bound the OUTPUT too: unbounded index
            # lists would let a few-KB body demand a giant S×D response.
            return None, {"error": f"too many {key} (max {MAX_MATRIX_POINTS})"}
        try:
            idx = [int(i) for i in idx]
        except (TypeError, ValueError):
            return None, {"error": f"{key} must be a non-empty index list"}
        if any(i < 0 or i >= len(points) for i in idx):
            return None, {"error": f"{key} index out of range"}
        return idx, None

    sources, err = _subset("sources")
    if err:
        return err
    dests, err = _subset("destinations")
    if err:
        return err

    vehicle_type = "car"
    vt = input_data.get("vehicle_type")
    if isinstance(vt, str) and vt.strip():
        vehicle_type = vt.lower().strip()
    profile = geo.profile_for_vehicle(vehicle_type)
    speed = geo.PROFILE_SPEED_MPS[profile]

    dev = resolve_device(device, "travel_matrix")
    if input_data.get("road_graph"):
        # Solve only the waypoints the response can reference: each row
        # is an independent one-source solve, so the subset's values are
        # bitwise the full matrix's.
        need = sorted(set(sources) | set(dests))
        pos = {p: k for k, p in enumerate(need)}
        legs = default_router(dev).route_legs(
            latlon[need], _car_time_scale(speed),
            hour=_pickup_hour(input_data.get("pickup_time")))
        durm = legs.duration_matrix()   # one device table, no walks
        dist = np.full((len(points), len(points)), np.inf)
        dist[np.ix_(need, need)] = legs.dist_m
        durations = [[float(durm[pos[i], pos[j]]) for j in dests]
                     for i in sources]
        meta = {"road_graph": True, "leg_cost_model": legs.cost_model}
    else:
        dist = geo.distance_matrix_m(torch.from_numpy(latlon).to(dev),
                                     geo.PROFILE_ROAD_FACTOR[profile]
                                     ).cpu().numpy()
        durations = [[float(dist[i, j]) / speed for j in dests]
                     for i in sources]
        meta = {"road_graph": False, "leg_cost_model": "haversine"}

    def _clean(v):
        return round(float(v), 1) if math.isfinite(v) else None

    return {
        "distances_m": [[_clean(dist[i, j]) for j in dests]
                        for i in sources],
        "durations_s": [[_clean(d) for d in row] for row in durations],
        "sources": sources,
        "destinations": dests,
        "vehicle_type": vehicle_type,
        **meta,
    }


def _road_leg_fns(legs) -> tuple:
    """(leg_cost, leg_geom) over one :class:`RoadLegs`: costs without
    polylines, geometry only for the legs a response renders."""
    return (legs.cost, lambda a, b: legs.leg(a, b)[2])


def _repriced(leg_cost, rep: Dict):
    """``leg_cost`` with the transformer's durations where it priced a
    leg (distances stay the base provider's)."""
    def cost(a: int, b: int):
        meters, seconds = leg_cost(a, b)
        return meters, rep.get((a, b), seconds)

    return cost


def _finish_point_to_point(p: dict, leg_cost, leg_geom, legs,
                           device: torch.device) -> dict:
    """Single-destination finishing, shared by the single and batch
    paths. With road legs the transformer (when it serves this graph)
    re-prices the out-and-back pair, as for multi-stop, so both report
    the same ``leg_cost_model``."""
    p2p_model = None
    if legs is not None:
        rep = legs.reprice_trips([[0]])
        if rep:
            leg_cost = _repriced(leg_cost, rep)
            p2p_model = "transformer"
    feature = _point_to_point(p, leg_cost, leg_geom, device,
                              use_road=legs is not None)
    if legs is not None and "error" not in feature:
        feature["properties"]["leg_cost_model"] = (
            p2p_model or legs.cost_model)
    return feature


def _assemble_multi(p: dict, sol: dict, dist, leg_cost, leg_geom, legs,
                    device: torch.device) -> dict:
    """Solved multi-stop problem → GeoJSON Feature (host-side geometry,
    segments, summary, top-k alternatives). Shared by the single path and
    ``optimize_route_batch``; the alternatives are ranked over ``dist``
    on ``device``. ``legs`` is the problem's :class:`RoadLegs` (road
    items) or None."""
    destinations = p["destinations"]
    all_points = p["all_points"]
    max_dist = p["max_dist"]
    top_k = p["top_k"]
    use_road = legs is not None
    if sol["unroutable"]:
        which = ", ".join(str(i) for i in sol["unroutable"])
        return {"error": f"stops not routable under constraints (indices: {which})"}

    # Route-context pricing: once the order is solved, the transformer
    # (when it serves this graph) re-prices each trip's whole edge
    # sequence in one forward; distances and geometry stay the base
    # provider's. Empty dict ⇒ base pricing throughout.
    repriced: Dict = {}
    if use_road:
        repriced = legs.reprice_trips(sol["trips"])
        if repriced:
            leg_cost = _repriced(leg_cost, repriced)

    coords: List[List[float]] = []
    segments: List[Dict] = []
    total_dist = 0.0
    total_dur = 0.0
    for trip in sol["trips"]:
        c, s, d, t = _build_trip_feature_parts(all_points, trip,
                                               leg_cost, leg_geom)
        coords.extend(c)
        segments.extend(s)
        total_dist += d
        total_dur += t
    if not (math.isfinite(total_dist) and math.isfinite(total_dur)):
        # A leg the solver accepted turned out unwalkable (a one-way-
        # disconnected graph): an error, not `Infinity` in the JSON.
        return {"error": "stops not routable over the road graph"}

    lons = [c[0] for c in coords]
    lats = [c[1] for c in coords]
    feature = {
        "bbox": [min(lons), min(lats), max(lons), max(lats)],
        "type": "Feature",
        "geometry": {"type": "LineString", "coordinates": coords},
        "properties": {
            "source": p["source"],
            "destinations": list(destinations),
            "optimized_order": sol["optimized_order"],
            "segments": segments,
            "summary": {
                "distance": round(total_dist, 1),
                "duration": round(total_dur, 1),
                "trips": sol["n_trips"],
            },
        },
    }
    if p["refine"]:
        feature["properties"]["refined"] = True

    # Additive ABI: {"top_k": N} returns up to N ALTERNATIVE visit orders,
    # scored on the device over the distance matrix (perturbed-greedy
    # pool + this solution as seed), then re-priced with the leg
    # provider (cost only, no polylines). The shipped order is excluded.
    # Single-trip solutions only: reordering within one trip keeps the
    # load, so every alternative that fits maximum_distance is feasible.
    if top_k > 1 and sol["n_trips"] == 1 and len(destinations) >= 2:
        price = legs.cost if use_road else leg_cost
        k_want = min(top_k, 10)
        # On the symmetric great-circle matrix EVERY tour occupies two
        # ranked slots (its reversal scores the same), so over-request;
        # road graphs are directed (one-ways): no reversal twins.
        k_ask = (k_want + 2) if use_road else (2 * k_want + 2)
        ranked = rank_routes(
            dist, k=k_ask, speed_mps=p["speed"], max_candidates=2048,
            greedy_order=np.asarray(sol["optimized_order"], np.int32),
            device=device)
        main_key = tuple(int(i) for i in sol["optimized_order"])
        seen = {main_key}
        if not use_road:
            seen.add(main_key[::-1])
        alternatives = []
        for order_alt in ranked.orders:
            if len(alternatives) >= k_want:
                break
            key = tuple(int(i) for i in order_alt)
            if key in seen:
                continue
            seen.add(key)
            if not use_road:
                seen.add(key[::-1])
            seq = [0] + [int(i) + 1 for i in order_alt] + [0]
            alt_m = alt_s = 0.0
            for a, b in zip(seq[:-1], seq[1:]):
                leg_m, leg_s = price(a, b)
                alt_m += leg_m
                alt_s += leg_s
            if not math.isfinite(alt_m) or alt_m > max_dist:
                continue
            alternatives.append({
                "optimized_order": [int(i) for i in order_alt],
                "distance": round(alt_m, 1),
                "duration": round(alt_s, 1),
            })
        if repriced and alternatives:
            # The main summary is transformer-priced; alternatives are
            # priced by the same model (one batched forward) so their
            # durations stay comparable.
            rep_durs = legs.reprice_orders(
                [a["optimized_order"] for a in alternatives])
            for alt, dur in zip(alternatives, rep_durs):
                if dur is not None and math.isfinite(dur):
                    alt["duration"] = round(dur, 1)
        feature["properties"]["alternatives"] = alternatives

    if use_road:
        feature["properties"]["road_graph"] = True
        # Which pricer produced the durations: "transformer", "gnn" or
        # "freeflow".
        feature["properties"]["leg_cost_model"] = (
            "transformer" if repriced else legs.cost_model)
    _annotate(feature, p["driver_details"], p["vehicle_type"], device)
    return feature


def optimize_route_batch(items, device=None) -> list:
    """Solve MANY optimize-route requests with batched device programs.

    Great-circle problems share one batched haversine; road problems
    (``road_graph: true``) share grouped shortest-path solves
    (``RoadRouter.route_legs_batch``: every problem's waypoints
    concatenate along the solver's source axis); then all multi-stop
    problems run the greedy solver (plus refiners when requested) as one
    ``(B, P+1, P+1)`` device program per refine flavor via
    ``solve_host_batch``. Assembly stays host-side per item, shared with
    the single path. Per-item errors come back in place; a router
    failure errors only the road items; ``top_k > 1`` items are rejected
    (ranking is a per-problem program — the single endpoint serves
    them).
    """
    if not isinstance(items, list) or not items:
        return [{"error": "items must be a non-empty list"}]
    if len(items) > MAX_BATCH_PROBLEMS:
        # One error PER item: library callers zip results against their
        # inputs, and a single-element list would silently misalign.
        return [{"error": f"batch too large (max {MAX_BATCH_PROBLEMS} "
                          f"problems)"} for _ in items]
    results: list = [None] * len(items)
    solve: list = []  # [index, parsed, dist, leg_cost, leg_geom, legs]

    for i, item in enumerate(items):
        p = _parse_problem(item if isinstance(item, dict) else {})
        if "error" in p:
            results[i] = p
        elif p["top_k"] > 1:
            results[i] = {"error": "top_k is a per-problem feature; "
                                   "use /api/optimize_route"}
        else:
            solve.append([i, p, None, None, None, None])
    if not solve:
        return results
    dev = resolve_device(device, "optimize_route_batch")

    road = [s for s in solve if s[1]["use_road"]]
    if road:
        try:
            legs_list = default_router(dev).route_legs_batch([
                (s[1]["latlon"], _car_time_scale(s[1]["speed"]),
                 _pickup_hour(s[1]["pickup_time"])) for s in road])
        except Exception as e:  # the per-item error contract
            for s in road:
                results[s[0]] = {"error": f"road graph unavailable: "
                                          f"{type(e).__name__}: {e}"}
            solve = [s for s in solve if not s[1]["use_road"]]
        else:
            for s, legs in zip(road, legs_list):
                s[2] = legs.dist_m
                s[3], s[4] = _road_leg_fns(legs)
                s[5] = legs

    # ONE batched haversine builds every great-circle problem's matrix
    # (points padded with origin copies; the pad is sliced off).
    gc = [s for s in solve if not s[1]["use_road"]]
    if gc:
        max_pts = max(len(s[1]["all_points"]) for s in gc)
        pts_pad = 1 << max(0, (max_pts - 1)).bit_length()
        latlon_b = np.zeros((len(gc), pts_pad, 2), np.float32)
        factor_b = np.zeros((len(gc),), np.float32)
        for j, s in enumerate(gc):
            ll = s[1]["latlon"]
            latlon_b[j] = ll[0]  # origin copies fill the pad
            latlon_b[j, : len(ll)] = ll
            factor_b[j] = s[1]["road_factor"]
        host = torch.from_numpy(np.concatenate(
            [latlon_b.reshape(len(gc), -1), factor_b[:, None]],
            axis=1)).to(dev)
        mats = geo.distance_matrix_m(
            host[:, :-1].reshape(len(gc), pts_pad, 2), host[:, -1]
        ).cpu().numpy()
        for j, s in enumerate(gc):
            n_pts = len(s[1]["all_points"])
            s[2] = mats[j, :n_pts, :n_pts]
            s[3], s[4] = _gc_legs(s[1]["all_points"], s[2], s[1]["speed"])

    # Point-to-point items price host-side directly (one leg each).
    multi: list = []
    for s in solve:
        i, p, dist, leg_cost, leg_geom, legs = s
        if len(p["destinations"]) == 1:
            results[i] = _finish_point_to_point(p, leg_cost, leg_geom, legs,
                                                dev)
        else:
            multi.append(s)

    # One batched device solve per refine flavor.
    for flavor in (False, True):
        group = [s for s in multi if s[1]["refine"] is flavor]
        if not group:
            continue
        sols = solve_host_batch(
            [g[2] for g in group],
            [g[1]["demands"] for g in group],
            [g[1]["cap"] for g in group],
            [g[1]["max_dist"] for g in group],
            refine=flavor, device=dev,
        )
        for (i, p, dist, leg_cost, leg_geom, legs), sol in zip(group, sols):
            results[i] = _assemble_multi(p, sol, dist, leg_cost, leg_geom,
                                         legs, dev)
    return results


def _point_to_point(p: dict, leg_cost, leg_geom, device,
                    use_road: bool = False) -> dict:
    """Single-destination path with the reference's feasibility semantics
    (``Flaskr/utils.py:53-82``): payload > capacity and distance >
    maximum_distance produce the same joined error strings."""
    destination = p["destinations"][0]
    d_m = leg_cost(0, 1)[0]
    payload = float(destination.get("payload", 0) or 0)
    errors = []
    if payload > p["cap"]:
        errors.append("payload exceeds vehicle capacity")
    if not math.isfinite(d_m):
        errors.append("stops not routable over the road graph")
    elif d_m > p["max_dist"]:
        errors.append("route distance exceeds maximum_distance")
    if errors:
        return {"error": " | ".join(errors)}

    coords, segments, total_dist, total_dur = _build_trip_feature_parts(
        p["all_points"], [0], leg_cost, leg_geom
    )
    # Reference point-to-point is one-way (no return leg): use only the
    # outbound segment.
    out_seg = segments[0]
    out_coords = coords[: out_seg["steps"][0]["way_points"][1] + 1]
    lons = [c[0] for c in out_coords]
    lats = [c[1] for c in out_coords]
    feature = {
        "bbox": [min(lons), min(lats), max(lons), max(lats)],
        "type": "Feature",
        "geometry": {"type": "LineString", "coordinates": out_coords},
        "properties": {
            "segments": [out_seg],
            "summary": {
                "distance": round(out_seg["distance"], 1),
                "duration": round(out_seg["duration"], 1),
            },
            "way_points": [0, len(out_coords) - 1],
            "optimized_order": [0],
            "source": p["source"],
            "destinations": [destination],
        },
    }
    if use_road:
        feature["properties"]["road_graph"] = True
    _annotate(feature, p["driver_details"], p["vehicle_type"], device)
    return feature


def _annotate(feature: dict, driver_details: dict, vehicle_type: str,
              device: torch.device) -> None:
    """Common properties the frontend reads (``Flaskr/utils.py:196-201``)."""
    props = feature.setdefault("properties", {})
    props["vehicle_type"] = vehicle_type
    props["driver_name"] = driver_details.get("driver_name")
    props["engine"] = engine_tag(device)
