"""Cross-region probe bridge: the port's ``live/bridge.py`` against the
JAX package's, case for case.

The bridge cases of ``tests/test_region.py`` — origin stamping and the
return leg's drop, a three-region ring forwarding transitively then
stopping, two live bridges in a ring without amplification, refusal of
one region and of malformed frames, the ``region.bridge`` chaos drop —
run once per package with one set of expectations. The three
``rtpu_region_bridge_*`` families the port declares match the JAX
ones, and a JAX bridge A→B with a port bridge B→A over two TCP brokers
(one of each package) forward each frame exactly once. Every bridge,
subscription and broker a test starts is stopped."""

import threading
import time
import types

import pytest

from routest_tpu import chaos as jchaos
from routest_tpu.live import bridge as jbridge
from routest_tpu.obs import get_registry as jregistry
from routest_tpu.serve.bus import InMemoryBus as JBus
from routest_tpu.serve.netbus import NetBus as JNetBus
from routest_tpu.serve.netbus import start_broker as jstart_broker
from routest_tpu_torch import chaos as tchaos
from routest_tpu_torch.live import bridge as tbridge
from routest_tpu_torch.obs import get_registry as tregistry
from routest_tpu_torch.serve.bus import InMemoryBus as TBus
from routest_tpu_torch.serve.netbus import NetBus as TNetBus
from routest_tpu_torch.serve.netbus import start_broker as tstart_broker

PKGS = {
    "jax": types.SimpleNamespace(ProbeBridge=jbridge.ProbeBridge, Bus=JBus,
                                 chaos=jchaos, registry=jregistry,
                                 metrics=jbridge._bridge_metrics),
    "port": types.SimpleNamespace(ProbeBridge=tbridge.ProbeBridge, Bus=TBus,
                                  chaos=tchaos, registry=tregistry,
                                  metrics=tbridge._bridge_metrics),
}
FAMILIES = ("rtpu_region_bridge_frames_total",
            "rtpu_region_bridge_dropped_total",
            "rtpu_region_bridge_lag_seconds",
            "rtpu_region_bridge_resubscribes_total")


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 15.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


def _wait(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def _frame(i=0):
    return {"t": time.time(), "driver": f"d{i}", "obs": [[i, 5.0]]}


def _drain(sub):
    out = []
    while True:
        got = sub.get(timeout=0.05)
        if got is None:
            return out
        out.append(got)


def test_bridge_stamps_origin_and_suppresses_return(pkg):
    bus_a, bus_b = pkg.Bus(), pkg.Bus()
    ab = pkg.ProbeBridge("a", "b", bus_a, bus_b)
    ba = pkg.ProbeBridge("b", "a", bus_b, bus_a)
    sub_b = bus_b.subscribe(ab.channel)
    assert ab.handle(_frame()) is True
    bridged = sub_b.get(timeout=1.0)
    assert bridged["origin_region"] == "a"
    assert ba.handle(bridged) is False
    assert ba.dropped == 1
    sub_b.close()


def test_bridge_three_ring_forwards_transitively_then_terminates(pkg):
    buses = {n: pkg.Bus() for n in "abc"}
    ab = pkg.ProbeBridge("a", "b", buses["a"], buses["b"])
    bc = pkg.ProbeBridge("b", "c", buses["b"], buses["c"])
    ca = pkg.ProbeBridge("c", "a", buses["c"], buses["a"])
    sub_b = buses["b"].subscribe(ab.channel)
    sub_c = buses["c"].subscribe(ab.channel)
    assert ab.handle(_frame()) is True
    hop1 = sub_b.get(timeout=1.0)
    assert hop1["origin_region"] == "a"
    assert bc.handle(hop1) is True
    hop2 = sub_c.get(timeout=1.0)
    assert hop2["origin_region"] == "a"
    assert ca.handle(hop2) is False
    sub_b.close()
    sub_c.close()


def test_bridge_ring_regression_no_amplification(pkg):
    bus_a, bus_b = pkg.Bus(), pkg.Bus()
    ab = pkg.ProbeBridge("a", "b", bus_a, bus_b)
    ba = pkg.ProbeBridge("b", "a", bus_b, bus_a)
    sub_a = bus_a.subscribe(ab.channel)
    sub_b = bus_b.subscribe(ab.channel)
    ab.start()
    ba.start()
    try:
        n = 5
        for i in range(n):
            bus_a.publish(ab.channel, _frame(i))
        assert _wait(lambda: ab.forwarded == n)
        assert _wait(lambda: ba.dropped == n)
        time.sleep(0.2)
        assert ab.forwarded == n
        assert ba.forwarded == 0
        assert len(_drain(sub_a)) == n
        assert len(_drain(sub_b)) == n
        assert ab.snapshot() == {"src": "a", "dst": "b",
                                 "channel": ab.channel, "forwarded": n,
                                 "dropped": 0, "running": True}
    finally:
        ab.stop()
        ba.stop()
        sub_a.close()
        sub_b.close()
    assert ab.snapshot()["running"] is False


def test_bridge_rejects_same_region_and_malformed(pkg):
    bus = pkg.Bus()
    with pytest.raises(ValueError):
        pkg.ProbeBridge("a", "a", bus, bus)
    ab = pkg.ProbeBridge("a", "b", pkg.Bus(), pkg.Bus())
    assert ab.handle("not a dict") is False
    assert ab.handle({"t": 1.0}) is False
    assert ab.dropped == 2


def test_bridge_chaos_point_drops_one_frame(pkg):
    pkg.chaos.configure(pkg.chaos.ChaosEngine(
        spec="region.bridge:error=1.0@1", seed=7))
    try:
        ab = pkg.ProbeBridge("a", "b", pkg.Bus(), pkg.Bus())
        assert ab.handle(_frame(0)) is False
        assert ab.handle(_frame(1)) is True
    finally:
        pkg.chaos.configure(None)


def _family_state(pkg, src, dst):
    """The bridge families' declarations and this direction's series."""
    pkg.metrics()
    snap = pkg.registry().snapshot()
    out = {}
    for name in FAMILIES:
        fam = snap[name]
        series = sorted(
            (tuple(sorted(s["labels"].items())),
             s.get("value", s.get("count")))
            for s in fam["series"]
            if s["labels"].get("src") == src
            and s["labels"].get("dst") == dst)
        out[name] = (fam["type"], fam["help"], series)
    return out


def test_bridge_metric_families_match_jax():
    """The same frames through each package's bridge (a direction no
    other test uses) leave the same families, help texts, label sets and
    counts in each package's registry."""
    states = {}
    for name, pkg in PKGS.items():
        pkg.chaos.configure(pkg.chaos.ChaosEngine(
            spec="region.bridge:error=1.0@1", seed=3))
        try:
            ab = pkg.ProbeBridge("fam-a", "fam-b", pkg.Bus(), pkg.Bus())
            results = [ab.handle(_frame(0)),                 # chaos
                       ab.handle(_frame(1)),                 # forwarded
                       ab.handle({"t": 1.0}),                # malformed
                       ab.handle(dict(_frame(2), origin_region="fam-b")),
                       ab.handle(dict(_frame(3), origin_region="fam-c"))]
        finally:
            pkg.chaos.configure(None)
        assert results == [False, True, False, False, True]
        states[name] = _family_state(pkg, "fam-a", "fam-b")
    assert states["port"] == states["jax"]
    frames = states["port"]["rtpu_region_bridge_frames_total"][2]
    assert frames == [((("dst", "fam-b"), ("src", "fam-a")), 2.0)]
    dropped = dict(states["port"]["rtpu_region_bridge_dropped_total"][2])
    assert dropped == {
        (("dst", "fam-b"), ("reason", reason), ("src", "fam-a")): 1.0
        for reason in ("chaos", "malformed", "loop")}


def test_cross_package_ring_forwards_each_frame_once():
    """A JAX bridge a→b and a port bridge b→a over two TCP brokers (a's
    from the JAX package, b's from the port): every frame published on
    either side reaches the other exactly once, stamped with its origin,
    and nothing comes back."""
    broker_a, _ = jstart_broker()
    broker_b, _ = tstart_broker()
    url_a = f"tcp://127.0.0.1:{broker_a.port}"
    url_b = f"tcp://127.0.0.1:{broker_b.port}"
    buses = [JNetBus(url_a), JNetBus(url_b), TNetBus(url_b), TNetBus(url_a)]
    ab = jbridge.ProbeBridge("a", "b", buses[0], buses[1])
    ba = tbridge.ProbeBridge("b", "a", buses[2], buses[3])
    watch_a = TNetBus(url_a).subscribe(ab.channel)
    watch_b = JNetBus(url_b).subscribe(ab.channel)
    ab.start()
    ba.start()
    try:
        # Both subscriptions are live once a marker has crossed each way.
        for bridge, bus in ((ab, buses[0]), (ba, buses[2])):
            deadline = time.monotonic() + 10.0
            while bridge.forwarded == 0 and time.monotonic() < deadline:
                bus.publish(ab.channel, {"t": time.time(), "obs": [],
                                         "driver": "marker"})
                time.sleep(0.05)
        assert ab.forwarded and ba.forwarded
        assert _wait(lambda: ab.dropped == ba.forwarded
                     and ba.dropped == ab.forwarded)
        time.sleep(0.2)
        _drain(watch_a)
        _drain(watch_b)
        f0, d0 = (ab.forwarded, ba.forwarded), (ab.dropped, ba.dropped)
        n = 4
        for i in range(n):
            buses[0].publish(ab.channel, _frame(i))       # on a
            buses[2].publish(ab.channel, _frame(100 + i))  # on b
        assert _wait(lambda: ab.forwarded - f0[0] == n
                     and ba.forwarded - f0[1] == n)
        assert _wait(lambda: ab.dropped - d0[0] == n
                     and ba.dropped - d0[1] == n)
        time.sleep(0.3)
        got_a, got_b = _drain(watch_a), _drain(watch_b)
        assert (ab.forwarded - f0[0], ba.forwarded - f0[1]) == (n, n)
        # a sees its n originals and n frames from b, stamped "b"
        assert sorted(f["driver"] for f in got_a
                      if f.get("origin_region") == "b") == \
            sorted(f"d{100 + i}" for i in range(n))
        assert sorted(f["driver"] for f in got_a
                      if "origin_region" not in f) == \
            sorted(f"d{i}" for i in range(n))
        assert len(got_a) == 2 * n
        assert sorted(f["driver"] for f in got_b
                      if f.get("origin_region") == "a") == \
            sorted(f"d{i}" for i in range(n))
        assert len(got_b) == 2 * n
    finally:
        ab.stop()
        ba.stop()
        watch_a.close()
        watch_b.close()
        for broker in (broker_a, broker_b):
            broker.shutdown()
            broker.server_close()
