"""The road router's metric families on the port's ``/api/metrics``
against the JAX app's.

The JAX router registers ``rtpu_router_phase_seconds{phase}`` and the
batcher's ``rtpu_router_batch_{dispatches,rows,merged_requests}_total``
(``routest_tpu/optimize/road_router.py``) and observes the phases
``snap``, ``solve``, ``walk`` and ``matrix``. After one
``road_graph: true`` route on each app (the default deployment: the
generated 2048-node graph), the set of ``rtpu_router_*`` families in
``/api/metrics?format=prometheus`` is the same on both, and the port's
phase histogram has counts for ``snap``, ``solve`` and ``walk`` and its
batcher counted the dispatch."""

import re

import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.data.locations import SEED_LOCATIONS as SEED
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8,)
FAMILY = re.compile(r"^# TYPE (rtpu_router_[a-z0-9_]+) ", re.M)


def _body():
    pts = [{"lat": SEED[i][1], "lon": SEED[i][2], "payload": 1,
            "name": SEED[i][0]} for i in (2, 5, 9)]
    return {"source_point": {"lat": SEED[0][1], "lon": SEED[0][2]},
            "destination_points": pts,
            "driver_details": {"driver_name": "Kai", "vehicle_type": "car",
                               "vehicle_capacity": 9999,
                               "maximum_distance": 150_000.0,
                               "driver_age": 37},
            "road_graph": True}


@pytest.fixture(scope="module")
def scraped():
    jsvc = JEtaService(JServeConfig(batch_buckets=BUCKETS),
                       model_path=ARTIFACT)
    tsvc = EtaService(ServeConfig(batch_buckets=BUCKETS),
                      model_path=ARTIFACT, device="cpu")
    japp = jax_create_app(JConfig(), eta_service=jsvc)
    tapp = create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=tsvc)
    out = []
    try:
        for app in (japp, tapp):
            client = Client(app)
            r = client.post("/api/optimize_route", json=_body())
            assert r.status_code == 200, r.get_data(as_text=True)
            assert r.get_json()["properties"]["road_graph"] is True
            text = client.get("/api/metrics?format=prometheus") \
                .get_data(as_text=True)
            out.append(text)
    finally:
        tapp.close()
        if japp.dispatch.reopt is not None:
            japp.dispatch.reopt.stop()
    return out


def test_router_families_match_the_jax_app(scraped):
    jtext, ttext = scraped
    jfam, tfam = set(FAMILY.findall(jtext)), set(FAMILY.findall(ttext))
    for name in ("rtpu_router_phase_seconds",
                 "rtpu_router_batch_dispatches_total",
                 "rtpu_router_batch_rows_total",
                 "rtpu_router_batch_merged_requests_total"):
        assert name in jfam, name
    assert tfam == jfam


def _sample(text, name, **labels):
    sel = ",".join(f'{k}="{v}"' for k, v in labels.items())
    pat = re.escape(name) + (r"\{" + re.escape(sel) + r"\}" if sel else "")
    m = re.search(r"^" + pat + r" ([0-9.e+-]+)$", text, re.M)
    return float(m.group(1)) if m else None


def test_port_observes_the_request_path_phases(scraped):
    _, ttext = scraped
    for phase in ("snap", "solve", "walk"):
        count = _sample(ttext, "rtpu_router_phase_seconds_count",
                        phase=phase)
        assert count is not None and count >= 1, phase
    assert _sample(ttext, "rtpu_router_batch_dispatches_total") >= 1
    assert _sample(ttext, "rtpu_router_batch_rows_total") >= 1
