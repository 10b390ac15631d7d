"""Metro-scale street routing as a deployment serves it: both packages'
process-wide routers on the in-repo 8,192-node OSM extract
(``ROAD_GRAPH_OSM=artifacts/metro_8192.osm.gz``, default knobs: 8,192 is
past ``hier_min_nodes()`` = 4096, so both route through their partition
overlay), the port on the CPU.

Before the port had an overlay it solved this graph flat, and 89,494 of
the 131,072 distances of the 16-source solve below differed bitwise from
the JAX package's (one predecessor too). Here the solves are bitwise
equal, the two apps' road ``/api/optimize_route`` (with ``use_ml_eta``,
on one tiny f32 ETA model both read) and ``/api/matrix`` answers are
equal (ETA minutes within the f32 class; engine tags and request ids
differ by construction), and health's ``road_router`` blocks are equal
apart from timings. Each package's metro router is built once for the
module; the JAX router compiles no AOT buckets (the port has none)."""

import datetime as dt
import os
import types

import jax
import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.dtypes import F32_POLICY
from routest_tpu.models.eta_mlp import EtaMLP
from routest_tpu.optimize import engine as jeng
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve import app as japp_mod
from routest_tpu.serve import ml_service as jml
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu.train.checkpoint import save_model
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.optimize import engine as teng
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.serve import app as tapp_mod
from routest_tpu_torch.serve import ml_service as tml
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

METRO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "metro_8192.osm.gz")
F32 = (1e-4, 1e-3)


class _PinnedClock(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 14, 8, 45, 0)


@pytest.fixture(scope="module")
def metro(tmp_path_factory):
    """(JAX router, port router, JAX client, port client), the routers
    being each package's ``default_router`` on the metro extract."""
    mpath = str(tmp_path_factory.mktemp("eta") / "eta.msgpack")
    model = EtaMLP(hidden=(16, 16), policy=F32_POLICY)
    save_model(mpath, model, model.init(jax.random.PRNGKey(0)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROAD_GRAPH_OSM", METRO)
        mp.setenv("ROUTEST_ROUTER_AOT", "off")
        mp.setattr(jrr, "_default_router", None)
        mp.setattr(trr, "_default_routers", {})
        jr, tr = jrr.default_router(), trr.default_router("cpu")
        jclient = Client(jax_create_app(
            JConfig(), eta_service=JEtaService(JServeConfig(),
                                               model_path=mpath)))
        tclient = Client(create_app(
            Config(serve=ServeConfig(device="cpu")),
            eta_service=EtaService(ServeConfig(device="cpu"),
                                   model_path=mpath, device="cpu")))
        yield jr, tr, jclient, tclient


@pytest.fixture
def pinned_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=_PinnedClock,
                                  timedelta=dt.timedelta,
                                  timezone=dt.timezone)
    for module in (japp_mod, jml, jeng, tapp_mod, tml, teng):
        monkeypatch.setattr(module, "dt", clock)


def test_metro_routes_through_the_overlay_bitwise(metro):
    jr, tr, _, _ = metro
    assert tr.n_nodes == jr.n_nodes == 8192
    assert tr._hier is not None and tr.solver_info["solver"] == "hierarchy"
    src = np.random.default_rng(0).integers(0, jr.n_nodes, 16)
    jd, jp = jr.shortest(src)
    td, tp = tr.shortest(src)
    assert td.dtype == jd.dtype == np.float32
    assert tp.dtype == jp.dtype == np.int32
    assert td.tobytes() == jd.tobytes()
    assert tp.tobytes() == jp.tobytes()


def _same(got, want, path=""):
    key = path.rsplit(".", 1)[-1]
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif key == "engine" and str(want).startswith("backend:"):
        assert (want, got) == ("backend:jax-tpu", "backend:torch-cpu"), path
    elif key in ("request_id", "created_at"):
        assert isinstance(got, str) and got, path
    elif key.startswith("eta_minutes_ml") and want is not None:
        assert abs(got - want) <= F32[1] + F32[0] * abs(want), (path, got,
                                                                want)
    elif key == "eta_completion_time_ml" and want is not None:
        delta = (dt.datetime.fromisoformat(got)
                 - dt.datetime.fromisoformat(want)).total_seconds()
        assert abs(delta) <= 1.0, (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [{"lat": 14.40 + 0.26 * float(a), "lon": 120.96 + 0.14 * float(b),
             "payload": 1} for a, b in rng.random((n, 2))]


def _route(seed, **extra):
    pts = _points(11, seed)
    body = {"source_point": {"lat": pts[0]["lat"], "lon": pts[0]["lon"]},
            "destination_points": pts[1:],
            "driver_details": {"driver_name": "t", "vehicle_type": "car",
                               "vehicle_capacity": 9999,
                               "maximum_distance": 1_000_000,
                               "driver_age": 33},
            "road_graph": True, "pickup_time": "2026-10-14T08:30:00"}
    body.update(extra)
    return body


BODIES = {
    "route_10_ml": ("/api/optimize_route", _route(
        1, use_ml_eta=True, context={"weather": "Stormy", "traffic": "Jam"})),
    "route_10_top_k": ("/api/optimize_route", _route(2, top_k=3)),
    "matrix_16": ("/api/matrix", {"points": _points(16, 3),
                                  "road_graph": True,
                                  "pickup_time": "2026-10-14T17:00:00"}),
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_metro_app_answers_match(metro, pinned_clock, name):
    _, _, jclient, tclient = metro
    path, body = BODIES[name]
    jres, tres = jclient.post(path, json=body), tclient.post(path, json=body)
    assert jres.status_code == tres.status_code == 200, tres.get_json()
    got, want = tres.get_json(), jres.get_json()
    _same(got, want)
    if path == "/api/matrix":
        assert got["road_graph"] is True
        assert all(v > 0 for v in got["distances_m"][0][1:])
    else:
        assert len(got["geometry"]["coordinates"]) > 4
        if body.get("use_ml_eta"):
            assert got["properties"]["eta_minutes_ml"] > 0


def _strip_timings(d):
    if isinstance(d, dict):
        return {k: _strip_timings(v) for k, v in d.items()
                if not k.endswith("_s")}
    if isinstance(d, list):
        return [_strip_timings(x) for x in d]
    return d


def test_metro_health_road_router_block(metro):
    _, _, jclient, tclient = metro
    body = _route(4)
    for client in (jclient, tclient):
        assert client.post("/api/optimize_route",
                           json=body).status_code == 200
    want = jclient.get("/api/health").get_json()["checks"]["engine"]
    got = tclient.get("/api/health").get_json()["checks"]["engine"]
    jblock, tblock = want["road_router"], got["road_router"]
    assert tblock["solver"] == jblock["solver"] == "hierarchy"
    assert tblock["aot_buckets"] == jblock["aot_buckets"] == []
    assert tblock["overlay"]["loaded_from_cache"] is False
    assert tblock["overlay"]["n_levels"] == 3
    assert _strip_timings(tblock) == _strip_timings(jblock)
