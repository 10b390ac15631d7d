"""The change ledger: the port's ``obs/ledger.py`` against the JAX
package's on the same changes.

The same recorded and ingested events give the same rings, queries,
snapshots and — for the same paging scopes and times — the same suspect
rankings; bus frames are ingested, deduplicated and refused alike; the
cross-region bridge forwards the same frames. ``attach_bus`` on the
port's in-memory bus publishes local changes and taps foreign ones, and
its thread ends on ``stop()``."""

import threading
import time

import pytest
import torch

from routest_tpu.core.config import LedgerConfig as JLedgerConfig
from routest_tpu.core.config import load_ledger_config as jload_ledger_config
from routest_tpu.obs import ledger as jledger
from routest_tpu.obs.registry import MetricsRegistry as JRegistry
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu_torch.core.config import LedgerConfig, load_ledger_config
from routest_tpu_torch.obs import ledger as tledger
from routest_tpu_torch.obs.registry import MetricsRegistry
from routest_tpu_torch.serve.bus import InMemoryBus

PACKAGES = {"jax": (jledger, JLedgerConfig, JRegistry, JBus),
            "torch": (tledger, LedgerConfig, MetricsRegistry, InMemoryBus)}

T0 = 1_800_000_000.0

CHANGES = [
    ("model.swap", {"replica": "r1", "version": "v2"}, {"generation": 3},
     T0 - 800),
    ("live.flip", {}, {"epoch": 4, "obs_edges": 120}, T0 - 300),
    ("chaos.arm", {"replica": "r2"}, {"spec": "p:error=1"}, T0 - 200),
    ("model.road_swap", {"replica": "r1"}, {"generation": 2}, T0 - 120),
    ("wire.enable", {"region": "ap"}, {"paths": ["/api/matrix"]}, T0 - 60),
    ("rollout.phase", {"version": "v3", "region": "eu"},
     {"phase": "canary"}, T0 - 30),
    ("autoscale.grow", {"bucket": "64"}, {"to": 3}, T0 - 5),
    ("future.kind", {}, None, T0 - 1),
    ("model.swap", {"replica": "r3"}, None, T0 - 2000),  # outside window
]

FOREIGN = [
    {"change": {"kind": "model.swap", "ts": T0 - 10, "id": "other:1",
                "replica": "r9"}},
    {"change": {"kind": "model.swap", "ts": T0 - 10, "id": "other:1"}},
    {"change": {"kind": "live.flip", "ts": "yesterday", "id": "other:2"}},
    {"change": {"kind": 7, "ts": T0, "id": "other:3"}},
    {"change": {"kind": "live.flip", "ts": True, "id": "other:4"}},
    {"nochange": 1},
    "garbage",
    {"change": {"kind": "chaos.fire", "ts": T0 - 3}},
]

SCOPES = [
    {}, {"replica": "r1"}, {"replica": "r2", "version": "v2"},
    {"region": "eu", "version": "v3"}, {"bucket": "64"},
    {"offender": {"replica": "r1"}, "rid": "ignored-alias-order"},
]


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


def _ledger(k, **cfg):
    mod, cfg_cls, reg_cls, _ = PACKAGES[k]
    led = mod.ChangeLedger(cfg_cls(publish=False, **cfg),
                           registry=reg_cls())
    led._source = "src"      # event ids compare across the packages
    led.set_context(replica="r1", version="v1")
    for kind, labels, detail, ts in CHANGES:
        led.record(kind, detail=detail, ts=ts, **labels)
    ingested = [led.ingest(f) for f in FOREIGN]
    return led, ingested


def test_rings_queries_and_snapshots_match():
    out = {}
    for k in PACKAGES:
        led, ingested = _ledger(k)
        out[k] = (ingested, led.events(), led.snapshot(),
                  [led.query(**q) for q in (
                      {}, {"kind": "model"}, {"replica": "r1"},
                      {"since": T0 - 100}, {"limit": 2},
                      {"version": "v3", "region": "eu"})])
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("scope", SCOPES)
@pytest.mark.parametrize("window_s,limit", [(900.0, 5), (100.0, 3),
                                            (3000.0, 20)])
def test_suspect_rankings_match(scope, window_s, limit):
    ranks = {}
    for k, (mod, *_rest) in PACKAGES.items():
        led, _ = _ledger(k)
        ranks[k] = mod.rank_suspects(
            led.events(), T0, scope=mod.scope_from_detail(scope),
            window_s=window_s, limit=limit)
    assert ranks["torch"] == ranks["jax"]
    assert ranks["torch"]


def test_capacity_bounds_the_ring():
    for k in PACKAGES:
        led, _ = _ledger(k, capacity=4)
        assert len(led.events()) == 4
    assert _ledger("torch", capacity=4)[0].events() == \
        _ledger("jax", capacity=4)[0].events()


@pytest.mark.parametrize("env", [
    {}, {"RTPU_LEDGER": "0", "RTPU_LEDGER_CAPACITY": "x"},
    {"RTPU_LEDGER_WINDOW_S": "60", "RTPU_LEDGER_CHANNEL": "c",
     "RTPU_REGION": "eu", "RTPU_LEDGER_PUBLISH": "0"},
])
def test_config_loader_matches(env):
    assert load_ledger_config(env).__dict__ == \
        jload_ledger_config(env).__dict__


def test_record_change_uses_the_process_ledger(monkeypatch):
    led = tledger.ChangeLedger(LedgerConfig(publish=False),
                               registry=MetricsRegistry())
    monkeypatch.setattr(tledger, "_ledger", led)
    rec = tledger.record_change("model.swap", detail={"generation": 1})
    assert rec["kind"] == "model.swap" and rec in led.events()
    monkeypatch.setattr(tledger, "_ledger", tledger.ChangeLedger(
        LedgerConfig(enabled=False), registry=MetricsRegistry()))
    assert tledger.record_change("model.swap") is None


def test_bridge_forwards_as_the_jax_bridge():
    frames = [{"change": {"kind": "model.swap", "ts": T0, "id": "a:1"}},
              {"change": {"kind": "live.flip", "ts": T0, "id": "a:2"},
               "origin_region": "eu"},
              {"change": {"kind": "live.flip", "ts": T0, "id": "a:3"},
               "origin_region": "ap"},
              {"bad": 1}]
    out = {}
    for k, (mod, _, _, bus_cls) in PACKAGES.items():
        src, dst = bus_cls(), bus_cls()
        got = []
        with dst.subscribe("rtpu.changes") as sub:
            bridge = mod.LedgerBridge("eu", "us", src, dst)
            handled = [bridge.handle(f) for f in frames]
            while True:
                item = sub.get(timeout=0.01)
                if item is None:
                    break
                got.append(item)
        out[k] = (handled, got, bridge.snapshot())
    assert out["torch"] == out["jax"]


def test_attach_bus_publishes_and_taps_foreign_changes():
    bus = InMemoryBus()
    a = tledger.ChangeLedger(LedgerConfig(), registry=MetricsRegistry())
    b = tledger.ChangeLedger(LedgerConfig(), registry=MetricsRegistry())
    # Two processes' ledgers: one process here, so name the sources.
    a._source, b._source = "proc-a", "proc-b"
    try:
        a.attach_bus(bus)
        b.attach_bus(bus)
        a.attach_bus(bus)     # idempotent: still one tap
        # The taps subscribe on their own threads: wait until both listen.
        deadline = time.monotonic() + 5.0
        while len(bus._subscribers.get("rtpu.changes", ())) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        rec = a.record("model.swap", detail={"generation": 9})
        deadline = time.monotonic() + 5.0
        while not b.events() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [e["id"] for e in b.events()] == [rec["id"]]
        assert [e["id"] for e in a.events()] == [rec["id"]]  # no echo
    finally:
        a.stop()
        b.stop()
