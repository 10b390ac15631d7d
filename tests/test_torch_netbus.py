"""The cross-process SSE broker: the port's ``serve/netbus.py`` crossed
with the JAX package's, and the port's ``make_bus``.

Every client/broker pairing (port or JAX client on a port or JAX
broker) gives the same transcript: frames and per-channel event ids,
``Last-Event-ID`` resumes from the replay ring, the ring's bound, the
epoch check on a stale resume id, the publish replay buffer across a
broker restart and a reconnecting subscription that outlives one.
``make_bus("tcp://…")`` gives the port's ``NetBus``; ``redis://`` is
refused; a configured broker that does not answer fails (the JAX
package falls back to an in-memory bus there — the divergence is
pinned). Every broker, socket and thread a test starts is stopped."""

import socket
import threading
import time

import pytest

from routest_tpu.serve import bus as jbus
from routest_tpu.serve import netbus as jnet
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.serve import bus as tbus
from routest_tpu_torch.serve import netbus as tnet
from routest_tpu_torch.serve.app import create_app

PACKAGES = {"jax": jnet, "port": tnet}
PAIRS = [(c, b) for c in PACKAGES for b in PACKAGES]


@pytest.fixture(scope="module", autouse=True)
def _no_threads_left():
    """Fails the module if a thread its tests started is still alive."""
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    deadline = time.monotonic() + 10.0
    for t in left:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not [t.name for t in left if t.is_alive()]


def _stop(broker):
    """Stop a broker and every connection it holds (its handler threads
    end on the closed sockets)."""
    with broker._subs_lock:
        handlers = {h for hs in broker._subs.values() for h in hs}
    broker.shutdown()
    broker.server_close()
    for h in handlers:
        try:
            h.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


def _close(bus):
    bus._reset()


def _drain(sub, n, timeout=3.0):
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        data = sub.get(timeout=0.2)
        if data is not None:
            out.append((data, sub.last_id))
    return out


def _transcript(client_mod, broker_mod):
    broker, _ = broker_mod.start_broker()
    url = f"tcp://127.0.0.1:{broker.port}"
    pub = client_mod.NetBus(url)
    try:
        out = {"ping": pub.ping(), "kind": pub.kind}
        sub = client_mod.NetBus(url).subscribe("drv-7")
        out["receivers"] = [pub.publish("drv-7", {"i": i, "s": "x" * i})
                            for i in range(5)]
        out["live"] = _drain(sub, 5)
        assert sub.get(timeout=0.05) is None
        sub.close()
        # Last-Event-ID: only ids past it replay, then live events.
        resumed = client_mod.NetBus(url).subscribe("drv-7",
                                                   last_event_id=2)
        pub.publish("drv-7", {"i": 5})
        out["resumed"] = _drain(resumed, 4)
        resumed.close()
        # The ring keeps the newest HISTORY events per channel.
        for i in range(broker_mod.Broker.HISTORY + 10):
            pub.publish("ring", {"i": i})
        late = client_mod.NetBus(url).subscribe("ring", last_event_id=0)
        out["ring_first"] = _drain(late, 1)
        late.close()
        # A resume id from another broker epoch replays the whole ring.
        stale = client_mod.NetBus(url)._raw_subscribe(
            "drv-7", last_event_id=5, epoch="not-this-one")
        out["stale_epoch"] = [d for d, _ in _drain(stale, 6)]
        stale.close()
        # Other channels see nothing; channel names are data.
        other = client_mod.NetBus(url).subscribe("drv-8")
        pub.publish("drv-7", {"i": 6})
        out["isolated"] = other.get(timeout=0.1)
        other.close()
        return out
    finally:
        _close(pub)
        _stop(broker)


def test_transcripts_match_across_packages():
    got = {pair: _transcript(PACKAGES[pair[0]], PACKAGES[pair[1]])
           for pair in PAIRS}
    want = got[("jax", "jax")]
    assert want["live"] == [({"i": i, "s": "x" * i}, i + 1)
                            for i in range(5)]
    assert [i for _, i in want["resumed"]] == [3, 4, 5, 6]
    assert want["ring_first"] == [({"i": 10}, 11)]
    assert want["isolated"] is None
    for pair, transcript in got.items():
        assert transcript == want, pair


def _replay_across_restart(client_mod, broker_mod):
    broker, _ = broker_mod.start_broker()
    port = broker.port
    bus = client_mod.NetBus(f"tcp://127.0.0.1:{port}", reconnect_s=0.2)
    sub = client_mod.NetBus(f"tcp://127.0.0.1:{port}",
                            reconnect_s=5.0).subscribe("trk")
    broker2 = None
    try:
        bus.publish("trk", {"phase": "before"})
        out = {"before": _drain(sub, 1)}
        _stop(broker)
        bus._reset()
        # Broker down: publishes buffer, never raise, and say 0.
        out["down"] = [bus.publish("trk", {"phase": "down", "i": i})
                       for i in range(3)]
        out["depth"] = bus.replay_depth
        broker2, _ = broker_mod.start_broker(port=port)
        deadline = time.monotonic() + 30.0
        while bus.replay_depth and time.monotonic() < deadline:
            time.sleep(0.05)
        out["drained"] = bus.replay_depth
        # The reconnecting subscription resubscribes on the new epoch
        # and replays the new broker's ring: the buffered frames.
        out["after"] = [d for d, _ in _drain(sub, 3, timeout=20.0)]
        return out
    finally:
        sub.close()
        _close(bus)
        _stop(broker2 if broker2 is not None else broker)


@pytest.mark.parametrize("client,broker", PAIRS)
def test_replay_buffer_and_reconnect_across_a_broker_restart(client,
                                                             broker):
    got = _replay_across_restart(PACKAGES[client], PACKAGES[broker])
    assert got == {
        "before": [({"phase": "before"}, 1)], "down": [0, 0, 0],
        "depth": 3, "drained": 0,
        "after": [{"phase": "down", "i": i} for i in range(3)]}


def test_make_bus_gives_the_netbus_on_a_tcp_url(monkeypatch):
    broker, _ = tnet.start_broker()
    monkeypatch.setenv("RTPU_NETBUS_RECONNECT_S", "7.5")
    try:
        bus = tbus.make_bus(f"tcp://127.0.0.1:{broker.port}")
        assert isinstance(bus, tnet.NetBus) and bus.kind == "netbus"
        assert bus._reconnect_s == 7.5
        sub = bus.subscribe("c")
        assert isinstance(sub, tnet._ReconnectingSubscription)
        assert bus.publish("c", {"a": 1}) == 1
        assert sub.get(timeout=2.0) == {"a": 1}
        sub.close()
        _close(bus)
    finally:
        _stop(broker)


def _unanswered(url, password="s3cret-pw"):
    """``url`` (a redis:// or rediss:// form) with a user and password,
    its host and port moved to a local port where nothing listens."""
    scheme, rest = url.split("://", 1)
    db = rest.partition("/")[2]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return (f"{scheme}://default:{password}@localhost:{port}"
            + (f"/{db}" if db else ""))


@pytest.mark.parametrize("url", ["redis://localhost:6379/0",
                                 "rediss://cache.example:6380"])
def test_make_bus_refuses_redis(url):
    """A Redis server that does not answer fails ``make_bus`` (the JAX
    package falls back to memory), the password redacted."""
    with pytest.raises(RuntimeError, match="does not answer") as err:
        tbus.make_bus(_unanswered(url))
    assert "s3cret-pw" not in str(err.value)
    assert "default:<redacted>@localhost:" in str(err.value)


def _dead_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def test_an_unreachable_broker_fails_where_jax_falls_back():
    url = _dead_url()
    with pytest.raises(RuntimeError, match="does not answer"):
        tbus.make_bus(url)
    with pytest.raises(RuntimeError, match="does not answer"):
        create_app(Config(serve=ServeConfig(device="cpu", redis_url=url)),
                   eta_service=object(), store=object())
    # The reference serves a single-process bus instead.
    assert isinstance(jbus.make_bus(url), jbus.InMemoryBus)
