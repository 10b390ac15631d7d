"""Verified hot-swap in the port: ``EtaService.reload_if_changed`` /
``_verify_swap`` / ``start_reload_watcher`` and the road router's
``_maybe_reload_models`` / ``_verify_gnn_swap``.

The ETA cases are the bodies of ``tests/test_reload.py`` (swap, broken
replacement, late artifact, point→quantile without torn reads, config
wiring, the watcher thread, swaps under concurrent traffic) and the
golden-batch gate cases of ``tests/test_rollout.py`` (divergent, close,
NaN, bound off), run against the port's service on artifacts the JAX
``save_model`` writes; the config knobs parse as the JAX package's. The
road cases write GNN artifacts with the JAX ``save_gnn`` for a small
generated graph: a first install, NaN and truncated replacements
rejected while the old GNN keeps pricing, a divergent one rejected, a
close one accepted, the bound switched off, and a deleted file falling
back to free-flow — each swap bumping the generation that keys the
route cache. The GBDT and AOT artifact formats of
``tests/test_reload.py`` arrive with their loaders.
"""

import os
import threading
import time
import warnings

import jax
import numpy as np
import pytest

from routest_tpu.core.config import load_config as jload_config
from routest_tpu.core.dtypes import F32_POLICY
from routest_tpu.models.eta_mlp import EtaMLP
from routest_tpu.models.gnn import RoadGNN
from routest_tpu.train.checkpoint import save_gnn, save_model
from routest_tpu_torch.core.config import ServeConfig, load_config
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.optimize.road_router import RoadRouter
from routest_tpu_torch.serve.ml_service import EtaService

BUCKETS = (8, 64)


def _touch(path):
    # mtime_ns granularity can be coarse: force a visible change
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


def _write_model(path, seed, hidden=(8,), quantiles=(), params=None):
    model = EtaMLP(hidden=hidden, policy=F32_POLICY, quantiles=quantiles)
    if params is None:
        params = model.init(jax.random.PRNGKey(seed))
    save_model(path, model, params)
    _touch(path)
    return model, params


def _service(path, **cfg):
    return EtaService(ServeConfig(batch_buckets=BUCKETS, **cfg),
                      model_path=path, device="cpu")


def _eta(svc):
    eta, _ = svc.predict_eta_minutes(weather="Sunny", traffic="Low",
                                     distance_m=10_000, pickup_time=None)
    return eta


def _swaps(result):
    return get_registry().counter("rtpu_model_swaps_total", "",
                                  ("result",)).labels(result=result).value


# ── tests/test_reload.py ─────────────────────────────────────────────


def test_reload_swaps_predictions(tmp_path):
    path = str(tmp_path / "m.msgpack")
    _write_model(path, seed=0)
    svc = _service(path)
    before, gen0 = _eta(svc), svc.generation
    accepted = _swaps("accepted")
    assert svc.reload_if_changed() is False  # unchanged file: no-op
    _write_model(path, seed=99)
    assert svc.reload_if_changed() is True
    after = _eta(svc)
    assert before is not None and after is not None and before != after
    assert svc.generation > gen0
    assert _swaps("accepted") == accepted + 1


def test_broken_replacement_keeps_old_model(tmp_path):
    path = str(tmp_path / "m.msgpack")
    _write_model(path, seed=1)
    svc = _service(path)
    before, fp = _eta(svc), svc.fingerprint
    rejected = _swaps("rejected")
    with open(path, "wb") as f:
        f.write(b"garbage, not an artifact")
    os.utime(path, ns=(time.time_ns(), time.time_ns()))
    assert svc.reload_if_changed() is False
    assert svc.available and _eta(svc) == before and svc.fingerprint == fp
    assert _swaps("rejected") == rejected + 1
    # the bad mtime is remembered: the next poll is a cheap no-op …
    assert svc.reload_if_changed() is False
    assert _swaps("rejected") == rejected + 1
    # … but a subsequent GOOD write still goes live
    _write_model(path, seed=2)
    assert svc.reload_if_changed() is True
    assert _eta(svc) is not None


def test_truncated_replacement_is_rejected(tmp_path):
    path = str(tmp_path / "m.msgpack")
    _write_model(path, seed=1, hidden=(16,))
    svc = _service(path)
    before, gen0 = _eta(svc), svc.generation
    with open(path, "rb") as f:
        data = f.read()
    with open(path + ".tmp", "wb") as f:
        f.write(data[: len(data) // 2])
    os.replace(path + ".tmp", path)  # atomic, like a real deploy
    _touch(path)
    assert svc.reload_if_changed() is False
    assert svc.generation == gen0 and _eta(svc) == before


def test_late_arriving_artifact_goes_live(tmp_path):
    path = str(tmp_path / "late.msgpack")
    svc = _service(path)
    assert not svc.available and _eta(svc) is None
    _write_model(path, seed=3)
    assert svc.reload_if_changed() is True
    assert svc.available and _eta(svc) is not None


def test_point_to_quantile_swap_has_no_torn_reads(tmp_path):
    path = str(tmp_path / "m.msgpack")
    _write_model(path, seed=0)
    svc = _service(path)
    point_serving = svc._serving
    _write_model(path, seed=9, quantiles=(0.1, 0.5, 0.9))
    assert svc.reload_if_changed() is True
    assert svc.quantiles == (0.1, 0.5, 0.9)
    # a request holding the pre-reload snapshot still scores and
    # interprets consistently as a point model …
    preds = svc._predict_rows(point_serving, np.zeros((1, 12), np.float32))
    assert preds.shape == (1,) and point_serving.quantiles == ()
    # … while new requests see the quantile world end to end
    eta, _, bands = svc.predict_eta_quantiles(
        weather="Sunny", traffic="Low", distance_m=5_000, pickup_time=None)
    assert eta is not None and set(bands) == {"p10", "p90"}


@pytest.mark.parametrize("env", [
    {}, {"ROUTEST_RELOAD_SEC": "2.5", "RTPU_SWAP_VERIFY": "0",
         "RTPU_SWAP_MAX_DIV": "12"},
    {"ROUTEST_RELOAD_SEC": "5s", "RTPU_SWAP_MAX_DIV": "lots"}],
    ids=["defaults", "set", "malformed"])
def test_config_env_parses_like_jax(env):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got, want = load_config(env).serve, jload_config(env).serve
    for name in ("reload_sec", "swap_verify", "swap_max_divergence"):
        assert getattr(got, name) == getattr(want, name), name


def test_config_env_wiring_and_tolerant_parse(tmp_path, monkeypatch):
    monkeypatch.setenv("ROUTEST_RELOAD_SEC", "2.5")
    assert load_config().serve.reload_sec == 2.5
    monkeypatch.setenv("ROUTEST_RELOAD_SEC", "5s")  # malformed: no crash
    with pytest.warns(UserWarning, match="ROUTEST_RELOAD_SEC"):
        assert load_config().serve.reload_sec == 0.0
    # a service constructed with reload_sec starts its own watcher; the
    # replacement built inside reload_if_changed must NOT start another
    path = str(tmp_path / "m.msgpack")
    _write_model(path, seed=6)
    svc = _service(path, reload_sec=3600.0)
    try:
        def watchers():
            return [t for t in threading.enumerate()
                    if t.name == "eta-reload-watcher"]

        n_before = len(watchers())
        assert n_before >= 1
        _write_model(path, seed=7)
        assert svc.reload_if_changed() is True
        assert len(watchers()) == n_before  # no watcher leak per reload
    finally:
        svc._watcher_stop.set()


def test_watcher_thread_reloads(tmp_path):
    path = str(tmp_path / "w.msgpack")
    _write_model(path, seed=4)
    svc = _service(path)
    before = _eta(svc)
    stop = svc.start_reload_watcher(0.05)
    try:
        _write_model(path, seed=5)
        deadline = time.time() + 10
        while time.time() < deadline:
            now = _eta(svc)
            if now is not None and now != before:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("watcher never swapped the model in")
    finally:
        stop.set()


def test_reload_under_concurrent_traffic(tmp_path):
    # Concurrent predict threads while models (point <-> quantile) swap
    # underneath: every response internally consistent, none failing.
    path = str(tmp_path / "hot.msgpack")
    _write_model(path, seed=0)
    svc = _service(path)
    stop = threading.Event()
    failures: list = []

    def traffic():
        while not stop.is_set():
            try:
                eta, _iso, bands = svc.predict_eta_quantiles(
                    weather="Sunny", traffic="Low", distance_m=8_000,
                    pickup_time=None)
                if eta is None:
                    failures.append("eta None mid-reload")
                elif not np.isfinite(eta):
                    failures.append(f"non-finite eta {eta}")
                elif bands and not (bands.get("p10", -np.inf) <= eta
                                    <= bands.get("p90", np.inf)):
                    failures.append(f"torn band {bands} eta {eta}")
            except Exception as e:  # the failure mode under test
                failures.append(f"{type(e).__name__}: {e}")
            time.sleep(0.001)  # leave the swapping thread some of the GIL

    threads = [threading.Thread(target=traffic) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for round_ in range(6):
            _write_model(path, seed=round_,
                         quantiles=(0.1, 0.5, 0.9) if round_ % 2 == 0
                         else ())
            assert svc.reload_if_changed() is True
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]


# ── tests/test_rollout.py: the golden-batch gate ─────────────────────


@pytest.fixture()
def swap_service(tmp_path):
    path = str(tmp_path / "m.msgpack")
    model, params = _write_model(path, seed=0)
    svc = _service(path)
    assert svc.available
    return svc, model, params, path


def _rewrite(path, model, fn, params):
    save_model(path, model, jax.tree_util.tree_map(fn, params))
    _touch(path)


def test_swap_rejects_divergent_artifact_keeps_serving(swap_service):
    svc, model, params, path = swap_service
    gen0, fp0 = svc.generation, svc.fingerprint
    _rewrite(path, model, lambda x: x + 1.0e6, params)
    assert svc.reload_if_changed() is False
    assert svc.available and svc.generation == gen0
    assert svc.fingerprint == fp0
    assert np.isfinite(_eta(svc))


def test_swap_accepts_close_artifact_and_bumps_generation(swap_service):
    svc, model, params, path = swap_service
    gen0, fp0 = svc.generation, svc.fingerprint
    _rewrite(path, model, lambda x: x * (1.0 + 1e-4), params)
    assert svc.reload_if_changed() is True
    assert svc.generation > gen0 and svc.fingerprint != fp0
    assert svc.stats["generation"] == svc.generation
    assert svc.stats["fingerprint"] == svc.fingerprint


def test_swap_rejects_nan_artifact(swap_service):
    svc, model, params, path = swap_service
    gen0 = svc.generation
    _rewrite(path, model, lambda x: np.full_like(x, np.nan), params)
    assert svc.reload_if_changed() is False
    assert svc.available and svc.generation == gen0


def test_swap_divergence_bound_is_configurable(tmp_path):
    path = str(tmp_path / "m.msgpack")
    model, params = _write_model(path, seed=0)
    svc = _service(path, swap_max_divergence=0.0)
    _rewrite(path, model, lambda x: x + 1.0e6, params)
    assert svc.reload_if_changed() is True


def test_golden_gate_scores_on_the_replacement(swap_service):
    """The verdict comes from the replacement's own batcher (the live
    one sees only the divergence compare)."""
    svc, model, params, path = swap_service
    fresh = _service(path)
    flushes = fresh._batcher.stats["flushes"]
    ok, verdict = svc._verify_swap(fresh)
    assert ok and verdict["divergence"] == 0.0
    assert fresh._batcher.stats["flushes"] > flushes


# ── the road GNN ─────────────────────────────────────────────────────


@pytest.fixture()
def gnn_router(tmp_path, monkeypatch):
    monkeypatch.setenv("ROUTEST_ROUTE_CACHE", "1")
    path = str(tmp_path / "gnn.msgpack")
    router = RoadRouter(n_nodes=96, seed=3, gnn_path=path,
                        use_transformer=False, device="cpu")
    assert router.leg_cost_model == "freeflow"
    return router, path


def _write_gnn(router, path, seed, nan=False, shift=0.0):
    """A random GNN for ``router``'s graph; ``shift`` added to every
    parameter prices every edge far above the free-flow floor."""
    model = RoadGNN(n_nodes=router.n_nodes, hidden=8, n_rounds=1,
                    policy=F32_POLICY)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(shift),
        model.init(jax.random.PRNGKey(seed)))
    if nan:
        params = jax.tree_util.tree_map(lambda x: np.full_like(x, np.nan),
                                        params)
    save_gnn(path + ".tmp", model, params, router.graph_dict())
    os.replace(path + ".tmp", path)
    _touch(path)


def _route(router):
    pts = router.coords[[0, 40, 80]]
    return router.route_legs(pts, hour=8)


def _road_swaps(result):
    return get_registry().counter(
        "rtpu_road_model_swaps_total", "",
        ("result",)).labels(result=result).value


def test_gnn_swap_install_reject_accept_delete(gnn_router, monkeypatch):
    router, path = gnn_router
    legs0 = _route(router)
    assert legs0.cost_model == "freeflow"
    gen0 = router._model_gen
    # first install: the finiteness gate alone
    _write_gnn(router, path, seed=0)
    accepted = _road_swaps("accepted")
    legs1 = _route(router)
    assert legs1.cost_model == "gnn" and router._model_gen == gen0 + 1
    assert _road_swaps("accepted") == accepted + 1
    live = router._gnn
    table = router.edge_time_s(8).copy()
    # a NaN replacement is rejected; the old GNN keeps pricing
    rejected = _road_swaps("rejected")
    _write_gnn(router, path, seed=1, nan=True)
    _route(router)
    assert router._gnn is live and router._model_gen == gen0 + 1
    assert _road_swaps("rejected") == rejected + 1
    np.testing.assert_array_equal(router.edge_time_s(8), table)
    # a truncated file is rejected the same way
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 3])
    _touch(path)
    _route(router)
    assert router._gnn is live and _road_swaps("rejected") == rejected + 2
    # a replacement far from the live pricer is rejected …
    _write_gnn(router, path, seed=2, shift=1.0)
    _route(router)
    assert router._gnn is live and _road_swaps("rejected") == rejected + 3
    # … a close one is accepted, and the cache key moves with it
    _write_gnn(router, path, seed=2)
    legs2 = _route(router)
    assert router._gnn is not live and router._model_gen == gen0 + 2
    assert legs2.cost_model == "gnn"
    assert not np.array_equal(router.edge_time_s(8), table)
    # with the bound off, finiteness alone decides
    monkeypatch.setenv("RTPU_ROAD_SWAP_MAX_DIV", "0")
    _write_gnn(router, path, seed=2, shift=1.0)
    _route(router)
    assert router._model_gen == gen0 + 3
    assert router.edge_time_s(8).min() > 300.0
    # a deleted artifact stops GNN pricing
    removed = _road_swaps("removed")
    os.remove(path)
    legs3 = _route(router)
    assert legs3.cost_model == "freeflow" and router._gnn is None
    assert router._model_gen == gen0 + 4
    assert _road_swaps("removed") == removed + 1
