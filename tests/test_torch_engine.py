"""The port's geodesy (``data/geo.py``, ``data/locations.py``) and routing
engine (``optimize/engine.py``) against the JAX package's on the same
request bodies, the port on the CPU.

Features must be equal — orders, trip counts, alternatives, geometry,
bbox, step instructions, errors — with two named exceptions: distances
and durations (``distance``/``duration`` keys, the matrix columns) are
held to rtol 1e-6 or 0.1 m (0.1 s), since ``sin``/``cos``/``arcsin``
differ by ulps between XLA and PyTorch and the values are rounded to
0.1; and ``properties.engine`` reads ``backend:torch-cpu`` where the
JAX engine says ``backend:jax-tpu``.

The JAX batch path computes its matrices with a jitted, vmapped
haversine that differs from its own single path (up to 0.97 m at 11+
points, see ``test_jax_batch_matrix_is_not_its_single_path``); the port
computes both paths like the JAX single path, so its batch items are
held to the JAX single path, and to the JAX batch only where that batch
agrees with its single path (8 points or fewer).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routest_tpu.data import geo as jgeo
from routest_tpu.data import locations as jloc
from routest_tpu.optimize import engine as jeng
from routest_tpu_torch.data import geo as tgeo
from routest_tpu_torch.data import locations as tloc
from routest_tpu_torch.optimize import engine as teng

SEED = jloc.SEED_LOCATIONS
_ROUNDED = ("distance", "duration")


def _same(got, want, path=""):
    """Equal JSON trees, except rounded distances/durations (within
    rtol 1e-6 or 0.1) and the engine tag."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for key in want:
            _same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif path.endswith(".engine"):
        assert want == "backend:jax-tpu" and got == "backend:torch-cpu", path
    elif isinstance(want, float) and (path.rsplit(".", 1)[-1] in _ROUNDED
                                      or "_m[" in path or "_s[" in path):
        assert abs(got - want) <= max(0.1 + 1e-9, 1e-6 * abs(want)), \
            (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _pt(i, payload=1):
    name, lat, lon = SEED[i]
    return {"lat": lat, "lon": lon, "payload": payload, "name": name}


def _req(n_dests=3, start=1, **extra):
    driver = {"driver_name": "Kai", "vehicle_type": "car",
              "vehicle_capacity": 9999, "maximum_distance": 100_000.0}
    driver.update(extra.pop("driver", {}))
    body = {"source_point": {"lat": SEED[0][1], "lon": SEED[0][2]},
            "destination_points": [_pt(i + start) for i in range(n_dests)],
            "driver_details": driver}
    body.update(extra)
    return body


def _split(n, cap, payload=10):
    body = _req(n)
    for p in body["destination_points"]:
        p["payload"] = payload
    body["driver_details"]["vehicle_capacity"] = cap
    return body


def _with(body, fn):
    fn(body)
    return body


BODIES = {
    "stops1": _req(1),
    "stops3": _req(3),
    "stops10": _req(10),
    "stops10_late": _req(10, start=11),
    "stops10_refine": _req(10, refine=True),
    "stops10_topk5": _req(10, top_k=5),
    "stops10_topk10_refine": _req(10, start=5, top_k=10, refine=True),
    "stops4_topk5": _req(4, top_k=5),
    "stops6_truck_topk1": _req(6, driver={"vehicle_type": "Truck"}, top_k=1),
    "stops7_bike_maxd": _req(7, driver={"vehicle_type": "bike",
                                        "maximum_distance": 30_000.0}),
    "capacity_splits": _split(6, 20),
    "capacity_splits_refine": _with(_split(10, 30, 10), lambda b: b.update(
        refine=True)),
    "capacity_splits_topk": _with(_split(8, 40), lambda b: b.update(top_k=4)),
    "unnamed_points": _with(_req(3), lambda b: [p.pop("name") for p in
                                                b["destination_points"]]),
    # the error bodies of tests/test_engine.py
    "p2p_capacity": _with(_req(1, driver={"vehicle_capacity": 0}),
                          lambda b: b["destination_points"][0].update(
                              payload=5)),
    "p2p_capacity_and_range": _with(
        _req(1, driver={"vehicle_capacity": 0, "maximum_distance": 1.0}),
        lambda b: b["destination_points"][0].update(payload=5)),
    "empty": {},
    "no_destinations": {"source_point": {"lat": 0, "lon": 0},
                        "destination_points": []},
    "bad_coordinates": _with(_req(2), lambda b: b["destination_points"]
                             .__setitem__(0, {"lat": "x", "lon": 121.0})),
    "unroutable": _with(_req(3, driver={"vehicle_capacity": 50}),
                        lambda b: b["destination_points"][1].update(
                            payload=10_000)),
    "no_source": {"destination_points": [{"lat": 14.5, "lon": 121.0}]},
    "bad_payload": _with(_req(2), lambda b: b["destination_points"][0]
                         .update(payload="heavy")),
    # the engine's other validation
    "nan_capacity": _req(3, driver={"vehicle_capacity": float("nan")}),
    "inf_range": _req(3, driver={"maximum_distance": float("inf")}),
    "text_capacity": _req(3, driver={"vehicle_capacity": "lots"}),
    "nan_payload": _with(_req(2), lambda b: b["destination_points"][0]
                         .update(payload=float("nan"))),
    "nan_lat": _with(_req(2), lambda b: b["destination_points"][0]
                     .update(lat=float("nan"))),
    "details_not_object": _req(2, driver_details="fast"),
    "destinations_not_list": _req(2, destination_points="here"),
    "top_k_text": _req(3, top_k="many"),
    "top_k_text_p2p": _req(1, top_k="many"),
    "top_k_inf": _req(3, top_k=float("inf")),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_optimize_route_features_match(name):
    body = BODIES[name]
    _same(teng.optimize_route(body, device="cpu"), jeng.optimize_route(body))


def test_top_k_at_10_stops_fills_alternatives():
    """At 10 stops 10! exceeds the 2048-candidate budget: the perturbed
    generator and the PRNG run, and the alternatives equal the JAX
    engine's (checked above) and fill the request."""
    out = teng.optimize_route(BODIES["stops10_topk5"], device="cpu")
    alts = out["properties"]["alternatives"]
    assert len(alts) == 5
    main = out["properties"]["optimized_order"]
    assert all(a["optimized_order"] not in (main, main[::-1]) for a in alts)


@pytest.mark.parametrize("extra", [{}, {"refine": True}, {"top_k": 3}])
def test_road_graph_is_an_explicit_error(extra):
    """``road_graph: true`` bodies answer what the JAX engine answers
    (street-network legs; the road phase's own tests are in
    ``tests/test_torch_road_serve.py``), single and in a batch."""
    body = _req(3, road_graph=True, pickup_time="2026-10-14T08:30:00",
                **extra)
    _same(teng.optimize_route(body, device="cpu"), jeng.optimize_route(body))
    out = teng.optimize_route_batch([body, _req(2)], device="cpu")
    # as in the JAX batch, a top_k > 1 item is refused before its road flag
    if extra.get("top_k"):
        assert out[0] == {"error": "top_k is a per-problem feature; "
                                   "use /api/optimize_route"}
    else:
        _same(out[0], jeng.optimize_route(body))
        assert out[0]["properties"]["leg_cost_model"] == "transformer"
    assert "error" not in out[1]
    # validation still runs first
    assert "finite" in teng.optimize_route(
        _req(3, road_graph=True, driver={"vehicle_capacity": float("nan")}),
        device="cpu")["error"]


BATCH_10 = [BODIES[k] for k in ("stops3", "stops10", "stops1",
                                "capacity_splits", "stops10_refine",
                                "stops6_truck_topk1", "capacity_splits_refine",
                                "stops10_late", "p2p_capacity",
                                "nan_capacity", "bad_coordinates")]


def test_batch_items_match_the_jax_single_path():
    """A 10-stop mix (points pad to 16): each port batch item equals the
    JAX single path's Feature — which JAX's own tests hold its batch
    to, and which its batch misses here (see the module docstring)."""
    got = teng.optimize_route_batch(BATCH_10, device="cpu")
    for body, g in zip(BATCH_10, got):
        _same(g, jeng.optimize_route(body))


def test_batch_items_match_the_jax_batch_up_to_8_points():
    small = [_req(3), _req(5, start=2), _req(2, driver={"vehicle_type":
                                                        "truck"}),
             _req(4, refine=True), _req(1), _split(7, 20),
             _req(3, top_k=2), {"bogus": 1}, "not-a-dict"]
    _same(teng.optimize_route_batch(small, device="cpu"),
          jeng.optimize_route_batch(small))


def test_jax_batch_matrix_is_not_its_single_path():
    """Pins the divergence recorded in ROADMAP.md Queue C: the JAX
    batch's jitted haversine at 11 points (padded to 16) differs from
    the JAX single path by up to ~1 m (its diagonal is not zero); the
    port's batched matrix equals its single one and stays within
    rtol 1e-6 of the JAX single path."""
    ll = jloc.coords_array()[:11]
    pad = np.broadcast_to(ll[0], (16, 2)).copy()
    pad[:11] = ll
    jsingle = np.asarray(jgeo.distance_matrix_m(jnp.asarray(ll), 1.42))
    jbatch = np.asarray(jeng._distance_matrix_batch(
        jnp.asarray(pad[None]), jnp.asarray([1.42], jnp.float32)))[0, :11, :11]
    assert np.abs(jbatch - jsingle).max() > 0.5
    tsingle = tgeo.distance_matrix_m(torch.tensor(ll), 1.42).numpy()
    tbatch = tgeo.distance_matrix_m(torch.tensor(pad[None]),
                                    torch.tensor([1.42]))[0, :11, :11].numpy()
    assert tbatch.tobytes() == tsingle.tobytes()
    np.testing.assert_allclose(tsingle, jsingle, rtol=1e-6, atol=1e-3)
    assert (np.diag(tsingle) == 0).all()


def test_batch_guards_match():
    for items in ([], "x", [_req(2)] * 257):
        _same(teng.optimize_route_batch(items, device="cpu"),
              jeng.optimize_route_batch(items))


def _points(idx):
    return [{"lat": SEED[i][1], "lon": SEED[i][2]} for i in idx]


MATRIX_BODIES = {
    "all21": {"points": _points(range(21))},
    "pair": {"points": _points([3, 7])},
    "subsets": {"points": _points(range(9)), "sources": [0, 4],
                "destinations": [8, 1, 1, 0]},
    "bike": {"points": _points(range(5)), "vehicle_type": " Bike "},
    "duplicate_points": {"points": _points([2, 2, 5])},
    "empty": {},
    "one_point": {"points": _points([1])},
    "not_list": {"points": "here"},
    "too_many": {"points": _points(range(21)) * 4},
    "bad_coordinates": {"points": [{"lat": 1, "lon": "x"}, {"lat": 2}]},
    "nan": {"points": [{"lat": float("nan"), "lon": 1.0},
                       {"lat": 1.0, "lon": 1.0}]},
    "sources_empty": {"points": _points([1, 2]), "sources": []},
    "sources_range": {"points": _points([1, 2]), "sources": [2]},
    "sources_text": {"points": _points([1, 2]), "destinations": ["a"]},
    "sources_too_many": {"points": _points([1, 2]), "sources": [0] * 65},
}


@pytest.mark.parametrize("name", sorted(MATRIX_BODIES))
def test_travel_matrix_matches(name):
    body = MATRIX_BODIES[name]
    _same(teng.travel_matrix(body, device="cpu"), jeng.travel_matrix(body))


def test_travel_matrix_at_64_points():
    rng = np.random.default_rng(0)
    pts = [{"lat": 14.4 + 0.3 * float(a), "lon": 120.95 + 0.18 * float(b)}
           for a, b in rng.random((64, 2))]
    _same(teng.travel_matrix({"points": pts}, device="cpu"),
          jeng.travel_matrix({"points": pts}))


def test_travel_matrix_road_graph_is_an_explicit_error():
    """A road-graph matrix equals the JAX engine's."""
    body = {"points": _points([1, 2]), "road_graph": True,
            "pickup_time": "2026-10-14T08:30:00"}
    got = teng.travel_matrix(body, device="cpu")
    _same(got, jeng.travel_matrix(body))
    assert got["road_graph"] is True and got["leg_cost_model"] == "gnn"


def test_geo_matches():
    assert tgeo.VEHICLE_PROFILES == jgeo.VEHICLE_PROFILES
    assert tgeo.PROFILE_ROAD_FACTOR == jgeo.PROFILE_ROAD_FACTOR
    assert tgeo.PROFILE_SPEED_MPS == jgeo.PROFILE_SPEED_MPS
    for vt in ("car", " TRUCK ", "roadbike", "hovercraft", "", None):
        assert tgeo.profile_for_vehicle(vt) == jgeo.profile_for_vehicle(vt)
    ll = jloc.coords_array()
    for i, j in ((0, 1), (3, 18), (6, 13), (16, 17), (9, 9)):
        p0, p1 = tuple(map(float, ll[i])), tuple(map(float, ll[j]))
        assert tgeo.bearing_deg(p0, p1) == jgeo.bearing_deg(p0, p1)
        for n in (1, 2, 24):
            assert (tgeo.great_circle_interpolate(p0, p1, n).tobytes()
                    == jgeo.great_circle_interpolate(p0, p1, n).tobytes())
        want = float(jgeo.haversine_m(*ll[i], *ll[j]))
        got = float(tgeo.haversine_m(*torch.tensor(ll[i]),
                                     *torch.tensor(ll[j])))
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-3)


def test_locations_match():
    assert tloc.SEED_LOCATIONS == jloc.SEED_LOCATIONS
    assert tloc.locations_table() == jloc.locations_table()
    assert tloc.coords_array().tobytes() == jloc.coords_array().tobytes()


def test_engine_defaults_to_the_card(monkeypatch):
    """device=None resolves to the configured device (cuda by default)
    and raises without a card; ROUTEST_DEVICE=cpu is the opt-in."""
    monkeypatch.delenv("ROUTEST_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: teng.optimize_route(_req(3)),
                 lambda: teng.optimize_route_batch([_req(3)]),
                 lambda: teng.travel_matrix({"points": _points([1, 2])})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    monkeypatch.setenv("ROUTEST_DEVICE", "cpu")
    out = teng.optimize_route(_req(3))
    assert out["properties"]["engine"] == "backend:torch-cpu"
