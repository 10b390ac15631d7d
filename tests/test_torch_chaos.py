"""Fault injection: the port's ``routest_tpu_torch.chaos`` against the JAX
package's ``routest_tpu.chaos`` on the same ``(spec, seed)``.

Parsing, the per-point injection streams (one ``random.Random`` per
point seeded with ``(seed << 32) ^ crc32(name)``), fire counts, limits,
``skew`` magnitudes and the engine snapshot are held equal call for
call; the config loader on the same environments likewise. Then the
port's fault points: ``device.compute`` fails every waiter of the flush
and leaves the batcher healthy for the next one, ``model.load`` degrades
the service like a corrupt file with the JAX service's error text, and
``store.http`` drives the resilient store through the same outcomes as
the JAX store. Latency rules carry 0 ms, so nothing here sleeps."""

import threading
import time

import numpy as np
import pytest
import torch

from routest_tpu import chaos as jchaos
from routest_tpu.core.config import load_chaos_config as jload_chaos_config
from routest_tpu.obs import ledger as jledger
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.core.config import load_chaos_config
from routest_tpu_torch.obs import ledger as tledger

SPECS = [
    ("p:error=0.5,drop=0.2", 7),
    ("p:error=0.5,drop=0.2", 8),
    ("p:latency=0.3/0,error=0.05;q:drop=0.5@3", 0),
    ("p:skew=0.4/12.5,error=0.1@2;q:skew=1.0/-3", 123456789),
    ("device.compute:error=1@2", 0),
    ("store.http:error=1.0@40;gateway.forward.r1:drop=0.2", 99),
]

MALFORMED = [
    "store.http:error=banana;;nocolon;ok.point:drop=0.5;x:badkind=1.0;"
    "y:error=2.0",
    "p:error=nan;q:latency=1/-5;r:drop=0.1@-1;s:skew=0.5/abc",
    "",
    " ; ;",
]


@pytest.fixture(autouse=True)
def _private_obs(monkeypatch, tmp_path):
    """Each test records chaos changes into fresh ledgers and bundles
    into its own directory, and leaves both packages' process engines
    unset."""
    from routest_tpu.obs import recorder as jrecorder
    from routest_tpu_torch.obs import recorder as trecorder

    monkeypatch.setattr(jledger, "_ledger", jledger.ChangeLedger(
        jledger.LedgerConfig(publish=False)))
    monkeypatch.setattr(tledger, "_ledger", tledger.ChangeLedger(
        tledger.LedgerConfig(publish=False)))
    for mod, sub in ((jrecorder, "jax"), (trecorder, "torch")):
        monkeypatch.setattr(mod, "_recorder", mod.FlightRecorder(
            mod.RecorderConfig(dir=str(tmp_path / sub), followup_s=0.0)))
    yield
    jchaos.configure(None)
    tchaos.configure(None)


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive
    (transient threads of other modules' apps end within seconds)."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rules(parsed):
    return {name: [(r.kind, r.prob, r.arg_ms, r.limit) for r in rules]
            for name, rules in parsed.items()}


@pytest.mark.parametrize("spec", [s for s, _ in SPECS] + MALFORMED)
def test_spec_parses_as_the_jax_package(spec):
    assert _rules(tchaos.parse_spec(spec)) == _rules(jchaos.parse_spec(spec))


def _stream(mod, spec, seed, points, n):
    eng = mod.ChaosEngine(spec=spec, seed=seed)
    out = []
    for i in range(n):
        point = points[i % len(points)]
        try:
            out.append((point, "skew", eng.inject(point)))
        except mod.ChaosConnectionDrop:
            out.append((point, "drop", None))
        except mod.ChaosError:
            out.append((point, "error", None))
    return out, eng.snapshot()


@pytest.mark.parametrize("spec,seed", SPECS)
def test_injection_stream_is_the_jax_package_call_for_call(spec, seed):
    points = sorted(tchaos.parse_spec(spec)) + ["unconfigured"]
    want, want_snap = _stream(jchaos, spec, seed, points, 96)
    got, got_snap = _stream(tchaos, spec, seed, points, 96)
    assert got == want
    assert got_snap == want_snap
    assert any(kind != "skew" or v for _, kind, v in got) or \
        "@" in spec  # the stream actually injected something


def test_per_point_streams_are_independent():
    # Adding a point to the spec never perturbs another point's stream.
    a, _ = _stream(tchaos, "p:error=0.5", 3, ["p"], 40)
    b, _ = _stream(tchaos, "p:error=0.5;q:drop=0.9", 3, ["p"], 40)
    assert a == b


def test_disabled_engine_injects_nothing():
    for mod in (jchaos, tchaos):
        eng = mod.ChaosEngine(spec="p:error=1.0", seed=0, enabled=False)
        assert eng.inject("p") == 0.0 and not eng.enabled
    assert tchaos.ChaosEngine(spec="", seed=0).enabled is False


@pytest.mark.parametrize("env", [
    {},
    {"RTPU_CHAOS_SPEC": "p:error=1"},
    {"RTPU_CHAOS_SPEC": "p:error=1", "RTPU_CHAOS_SEED": "42"},
    {"RTPU_CHAOS_SPEC": "p:error=1", "RTPU_CHAOS_SEED": "x"},
    {"RTPU_CHAOS_SPEC": "p:error=1", "RTPU_CHAOS": "0"},
    {"RTPU_CHAOS_SPEC": "  "},
])
def test_config_loader_matches(env):
    assert load_chaos_config(env).__dict__ == \
        jload_chaos_config(env).__dict__


def test_change_ledger_records_arm_and_first_fires():
    kinds = []
    for mod, led in ((jchaos, jledger), (tchaos, tledger)):
        eng = mod.ChaosEngine(spec="p:error=1.0@3,skew=1.0/2", seed=1)
        for _ in range(5):
            try:
                eng.inject("p")
            except mod.ChaosError:
                pass
        eng.record("replica.kill", "error")
        kinds.append([(e["kind"], e.get("detail", {}).get("kind"))
                      for e in led.get_change_ledger().events()
                      if e["kind"].startswith("chaos.")])
    assert kinds[1] == kinds[0]
    assert [k for k, _ in kinds[1]] == ["chaos.arm", "chaos.fire",
                                        "chaos.fire", "chaos.fire"]


def test_current_engine_is_none_until_live():
    assert tchaos.current_engine() is None
    tchaos.configure(tchaos.ChaosEngine(spec="p:error=1", seed=0))
    assert tchaos.current_engine() is not None
    tchaos.configure(tchaos.ChaosEngine(spec="", seed=0))
    assert tchaos.current_engine() is None


# ── the port's fault points ───────────────────────────────────────────

def _score_calls():
    calls = []

    def score(x):
        calls.append(x.shape)
        return x.sum(axis=1)

    return calls, score


def test_device_compute_fails_all_waiters_then_recovers():
    from routest_tpu.serve.ml_service import DynamicBatcher as JBatcher
    from routest_tpu_torch.serve.ml_service import DynamicBatcher

    outcomes = []
    for mod, batcher_cls in ((jchaos, JBatcher), (tchaos, DynamicBatcher)):
        mod.configure(mod.ChaosEngine(spec="device.compute:error=1.0@1",
                                      seed=0))
        calls, score = _score_calls()
        # A long window: the flush starts when the four waiters' 8 rows
        # are queued, so all four ride the one faulted flush.
        b = batcher_cls(score, buckets=(8,), max_batch=8,
                        max_wait_ms=5000.0)
        errors = []

        def submit(rows):
            try:
                b.submit(rows)
            except mod.ChaosError as e:
                errors.append(str(e))

        waiters = [threading.Thread(target=submit,
                                    args=(np.ones((2, 4), np.float32),))
                   for _ in range(4)]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join(timeout=10.0)
        assert not any(w.is_alive() for w in waiters)
        # The injected fault preempted the device call; every waiter of
        # that flush saw it, and the slab serves the next flush whole.
        first_calls = list(calls)
        out = b.submit(np.full((8, 4), 2.0, np.float32))
        outcomes.append((sorted(errors), first_calls, out.tolist(),
                         calls[len(first_calls):]))
    assert outcomes[1] == outcomes[0]
    errors, first_calls, out, later = outcomes[1]
    assert len(errors) == 4 and first_calls == [] and out == [8.0] * 8
    assert later == [(8, 4)]


def test_device_compute_skew_shifts_every_row():
    from routest_tpu_torch.serve.ml_service import DynamicBatcher

    tchaos.configure(tchaos.ChaosEngine(
        spec="device.compute:skew=1.0/2.5@1", seed=0))
    _, score = _score_calls()
    b = DynamicBatcher(score, buckets=(8,), max_batch=8, max_wait_ms=1.0)
    assert b.submit(np.ones((2, 4), np.float32)).tolist() == [6.5, 6.5]
    assert b.submit(np.ones((2, 4), np.float32)).tolist() == [4.0, 4.0]


def test_model_load_degrades_like_a_corrupt_file():
    from routest_tpu.core.config import ServeConfig as JServeConfig
    from routest_tpu.serve.ml_service import EtaService as JEtaService
    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.serve.ml_service import EtaService

    spec = "model.load:error=1.0@1"
    jchaos.configure(jchaos.ChaosEngine(spec=spec, seed=0))
    tchaos.configure(tchaos.ChaosEngine(spec=spec, seed=0))
    path = "artifacts/eta_mlp.msgpack"
    jsvc = JEtaService(JServeConfig(batch_buckets=(8,)), model_path=path)
    tsvc = EtaService(ServeConfig(batch_buckets=(8,)), model_path=path,
                      device="cpu")
    assert not tsvc.available and not jsvc.available
    assert tsvc.load_error == jsvc.load_error
    assert tsvc.load_error.startswith("chaos injected at model.load")


@pytest.mark.parametrize("spec,n_ops", [
    ("store.http:error=1.0@2", 6),
    ("store.http:drop=1.0@9", 8),
    ("store.http:error=0.5", 12),
])
def test_store_http_outcomes_match(spec, n_ops, monkeypatch):
    from routest_tpu.serve import store as jstore
    from routest_tpu_torch.serve import store as tstore

    def run(mod, store_mod):
        mod.configure(mod.ChaosEngine(spec=spec, seed=5))
        store = store_mod.ResilientStore(
            store_mod.InMemoryStore(), retries=1, backoff_base_s=0.0,
            breaker_threshold=3, cooldown_s=3600.0, journal_limit=64)
        out = []
        for i in range(n_ops):
            try:
                rid = store.insert_request({"origin_id": i, "stops": {}})
                out.append(("insert", rid is not None, store.degraded))
            except Exception as e:
                out.append(("insert", type(e).__name__, store.degraded))
            try:
                out.append(("list", len(store.list_history(50))))
            except Exception as e:
                out.append(("list", type(e).__name__))
        res = store.resilience()
        out.append({k: res[k] for k in ("breaker", "journal_depth")
                    if k in res})
        mod.configure(None)
        return out

    assert run(tchaos, tstore) == run(jchaos, jstore)
