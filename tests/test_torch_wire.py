"""The RTW1 binary wire path: the port's ``serve/wirecodec.py``,
``serve/wirechannel.py``, ``EtaService.predict_eta_wire`` and the app's
content-type negotiation, against the JAX package's.

- Frames: every encoder gives the JAX encoder's bytes for the same
  seeded arrays, each package decodes the other's frames, and every
  ``WireError`` case raises in both with the same message.
- Serving: on the port's app, wire answers are bitwise its JSON answers
  on the same rows (minutes, bands and completion stamps; NaN rows as
  null / NaT), through the fast lane's blob keys (1,000 rows with
  duplicates, wire first so the JSON request reads what the wire request
  cached, both against an app with no cache) and through chunking past
  the largest bucket (5,000 rows at buckets 8/64). Decoded minutes agree
  with the JAX app's within the f32 class of ``tests/test_ops_fused.py``
  (rtol 1e-4 / atol 1e-3). The 400 and 503 error frames are byte-equal
  to the JAX app's, and the 415 JSON equal.
- Channel: the cases of ``tests/test_wire_serving.py`` with the port's
  server under the JAX client and the JAX server under the port's
  client; the port's app served over its channel to the JAX client.

Servers bind port 0 and every thread a test starts is joined.
"""

import datetime as dt
import json
import os
import threading
import time

import numpy as np
import pytest
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.serve import deadline as jdeadline
from routest_tpu.serve import wirechannel as jchan
from routest_tpu.serve import wirecodec as jwc
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig
from routest_tpu_torch.data.features import encode_requests
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.serve import deadline as tdeadline
from routest_tpu_torch.serve import wirechannel as tchan
from routest_tpu_torch.serve import wirecodec as twc
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
BUCKETS = (8, 64)
WIRE_CT = "application/x-rtpu-wire"
F32 = (1e-4, 1e-3)


# ── frames ───────────────────────────────────────────────────────────


def _eta_request(seed, n=33):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 12)).astype(np.float32),
            rng.integers(0, 2 ** 48, size=n).astype(np.int64))


def _eta_response(seed, n=17, bands=True):
    rng = np.random.default_rng(seed)
    minutes = rng.uniform(1, 90, n)
    minutes[::5] = np.nan
    comp = rng.integers(0, 2 ** 48, size=n).astype(np.int64)
    comp[::5] = twc.COMPLETION_NAT
    b = ({"p10": minutes - 1.0, "p90": minutes + 2.5} if bands else {})
    return minutes, comp, b


_MATRIX_RESULT = {"durations_s": [[414.4, None], [1.0, 2.0]],
                  "distances_m": [[1.5, 2.5], [None, 3.25]],
                  "sources": [0, 1], "destinations": [1, 2],
                  "vehicle_type": "car", "road_graph": False,
                  "leg_cost_model": "haversine"}
_PTS = np.array([[14.6, 121.0], [14.61, 121.02], [14.59, 120.98]])
_OPTS = {"sources": [0], "destinations": [1, 2], "vehicle_type": "car"}

FRAMES = {
    "generic": lambda m: m.encode_frame(3, {
        "f32": np.arange(7, dtype=np.float32),
        "f64": np.linspace(-1, 1, 5),
        "i64": np.array([-(2 ** 62), 0, 2 ** 62], np.int64),
        "raw": b"\x00\xffhello"}),
    "eta_request": lambda m: m.encode_eta_request(*_eta_request(0)),
    "eta_request_empty": lambda m: m.encode_eta_request(
        np.zeros((0, 12), np.float32), np.zeros(0, np.int64)),
    "eta_response": lambda m: m.encode_eta_response(*_eta_response(1)),
    "eta_response_point": lambda m: m.encode_eta_response(
        *_eta_response(2, bands=False)),
    "matrix_request": lambda m: m.encode_matrix_request(_PTS, _OPTS),
    "matrix_response": lambda m: m.encode_matrix_response(_MATRIX_RESULT),
    "error": lambda m: m.encode_error_frame(503, "model unavailable"),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_byte_identical(name):
    assert FRAMES[name](twc) == FRAMES[name](jwc)


@pytest.mark.parametrize("decoder", [
    "decode_eta_request", "decode_eta_response", "decode_matrix_request",
    "decode_matrix_response", "decode_error_frame"])
def test_each_package_decodes_the_others_frames(decoder):
    frame = {"decode_eta_request": "eta_request",
             "decode_eta_response": "eta_response",
             "decode_matrix_request": "matrix_request",
             "decode_matrix_response": "matrix_response",
             "decode_error_frame": "error"}[decoder]
    kw = ({"max_bytes": 1 << 20, "max_rows": 64}
          if decoder == "decode_eta_request" else {})
    for enc, dec in ((twc, jwc), (jwc, twc)):
        got = getattr(dec, decoder)(FRAMES[frame](enc), **kw)
        want = getattr(enc, decoder)(FRAMES[frame](enc), **kw)
        if decoder == "decode_eta_request":
            got, want = ({k: v.tobytes() for k, v in f.columns.items()}
                         for f in (got, want))
        elif decoder == "decode_eta_response":
            got, want = ({"minutes": f["minutes"].tobytes(),
                          "completion_ms": f["completion_ms"].tobytes(),
                          "bands": {k: v.tobytes()
                                    for k, v in f["bands"].items()}}
                         for f in (got, want))
        assert got == want


def _corrupt(m):
    """Malformed buffers → (decoder name, buffer, kwargs)."""
    good = m.encode_frame(1, {"a": np.arange(10, dtype=np.float32),
                              "b": np.arange(4, dtype=np.int64)})
    one = m.encode_frame(1, {"a": np.zeros(2, np.float32)})
    bad_dtype = bytearray(m.encode_frame(1, {"a": np.zeros(4, np.float32)}))
    bad_dtype[4 + 1 + 2 + 2 + 1] = 250
    feats, pickup = _eta_request(3)
    big = 1 << 20
    cases = {f"truncated_{cut}": ("decode_frame", good[:cut],
                                  {"max_bytes": big})
             for cut in (0, 3, 4, 6, 9, 10, 20, len(good) - 1)}
    cases.update({
        "trailing": ("decode_frame", good + b"\x00", {"max_bytes": big}),
        "magic": ("decode_frame", b"XXXX" + good[4:], {"max_bytes": big}),
        "dtype": ("decode_frame", bytes(bad_dtype), {"max_bytes": big}),
        "duplicate": ("decode_frame",
                      one[:5] + (2).to_bytes(2, "little") + one[7:]
                      + one[7:], {"max_bytes": big}),
        "oversized": ("decode_frame", good, {"max_bytes": 16}),
        "junk": ("decode_eta_request", b"RTW1junk",
                 {"max_bytes": big, "max_rows": 64}),
        "rows": ("decode_eta_request", m.encode_eta_request(feats, pickup),
                 {"max_bytes": big, "max_rows": 32}),
        "pickup_length": ("decode_eta_request", m.encode_frame(
            m.K_ETA_REQUEST, {"features": feats.ravel(),
                              "pickup_ms": pickup[:10]}),
            {"max_bytes": big, "max_rows": 64}),
        "feature_width": ("decode_eta_request", m.encode_frame(
            m.K_ETA_REQUEST, {"features": feats.ravel()[:-1],
                              "pickup_ms": pickup}),
            {"max_bytes": big, "max_rows": 64}),
        "missing_column": ("decode_eta_request", m.encode_frame(
            m.K_ETA_REQUEST, {"features": feats.ravel()}),
            {"max_bytes": big, "max_rows": 64}),
        "wrong_kind": ("decode_eta_request",
                       m.encode_eta_response(*_eta_response(4)),
                       {"max_bytes": big, "max_rows": 64}),
        "error_as_eta": ("decode_eta_response",
                         m.encode_error_frame(503, "model unavailable"), {}),
        "error_as_matrix": ("decode_matrix_response",
                            m.encode_error_frame(400, "bad"), {}),
        "matrix_meta": ("decode_matrix_request", m.encode_frame(
            m.K_MATRIX_REQUEST, {"points": _PTS.ravel(), "meta": b"[1]"}),
            {"max_bytes": big}),
        "not_error": ("decode_error_frame", one, {}),
    })
    return cases


@pytest.mark.parametrize("case", sorted(_corrupt(twc)))
def test_wire_errors_match(case):
    messages = []
    for m in (twc, jwc):
        decoder, buf, kw = _corrupt(m)[case]
        with pytest.raises(m.WireError) as info:
            getattr(m, decoder)(buf, **kw)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


# ── serving ──────────────────────────────────────────────────────────


def _body_and_frame(n, seed, dup=False, nan_rows=()):
    """A columnar JSON body and the same rows as an RTW1 request."""
    rng = np.random.default_rng(seed)
    weather = ["Sunny", "Cloudy", "Stormy", "Windy", "Fog"]
    traffic = ["Low", "Medium", "High", "Jam", "Gridlock"]
    base = dt.datetime(2026, 1, 5)
    body = {"distance_m": rng.uniform(100, 40_000, n).round(1).tolist(),
            "weather": [weather[i] for i in rng.integers(0, 5, n)],
            "traffic": [traffic[i] for i in rng.integers(0, 5, n)],
            "driver_age": rng.integers(18, 70, n).astype(float).tolist(),
            "pickup_time": [(base + dt.timedelta(minutes=int(m))).isoformat()
                            for m in rng.integers(0, 7 * 24 * 60, n)]}
    if dup:  # every row appears twice: followers ride their leader
        for key in body:
            body[key] = body[key][: n // 2] * 2
    for i in nan_rows:
        body["distance_m"][i] = float("nan")
    pickups = [dt.datetime.fromisoformat(p) for p in body["pickup_time"]]
    feats = encode_requests(
        weather=body["weather"], traffic=body["traffic"],
        weekday=[p.weekday() for p in pickups],
        hour=[p.hour for p in pickups],
        distance_km=[d / 1000.0 for d in body["distance_m"]],
        driver_age=body["driver_age"])
    pickup_ms = np.asarray([np.datetime64(p, "ms") for p in pickups],
                           "datetime64[ms]").astype(np.int64)
    return body, twc.encode_eta_request(np.asarray(feats, np.float32),
                                        pickup_ms)


def _json_post(client, body):
    # json.dumps keeps NaN as the NaN token, which both apps parse
    return client.post("/api/predict_eta_batch", data=json.dumps(body),
                       content_type="application/json")


def _wire_columns(raw):
    out = twc.decode_eta_response(raw)
    cols = {"eta_minutes_ml": np.round(out["minutes"], 4)}
    for lvl, vals in out["bands"].items():
        cols[f"eta_minutes_ml_{lvl}"] = np.round(vals, 4)
    ms = np.asarray(out["completion_ms"], np.int64)
    iso = np.datetime_as_string(ms.astype("datetime64[ms]"), unit="s")
    return cols, [None if m == twc.COMPLETION_NAT else str(s)
                  for m, s in zip(ms, iso)], out


def _json_columns(payload):
    cols = {k: np.asarray([np.nan if v is None else v for v in vals],
                          np.float64)
            for k, vals in payload.items() if k.startswith("eta_minutes_ml")}
    return cols, payload["eta_completion_time_ml"]


def _assert_bitwise(wire_raw, json_payload):
    wcols, wiso, _ = _wire_columns(wire_raw)
    jcols, jiso = _json_columns(json_payload)
    assert sorted(wcols) == sorted(jcols)
    for key in jcols:
        assert wcols[key].tobytes() == jcols[key].tobytes(), key
    assert wiso == jiso


@pytest.fixture()
def wire_env(monkeypatch):
    monkeypatch.setenv("RTPU_WIRE", "1")


def _port_app(cache=True):
    svc = EtaService(ServeConfig(batch_buckets=BUCKETS, fastlane_cache=cache),
                     model_path=ARTIFACT, device="cpu")
    return create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=svc)


def _jax_app(path=ARTIFACT):
    svc = JEtaService(JServeConfig(batch_buckets=BUCKETS), model_path=path)
    return jax_create_app(JConfig(), eta_service=svc)


@pytest.fixture(scope="module")
def apps():
    """(port app, port app without the prediction cache, JAX app), all
    with the wire path on."""
    old = os.environ.get("RTPU_WIRE")
    os.environ["RTPU_WIRE"] = "1"
    try:
        built = (_port_app(), _port_app(cache=False), _jax_app())
    finally:
        if old is None:
            os.environ.pop("RTPU_WIRE")
        else:
            os.environ["RTPU_WIRE"] = old
    yield built
    for app in built:
        if app.dispatch.reopt is not None:
            app.dispatch.reopt.stop()


@pytest.mark.parametrize("n,dup,nan_rows", [
    (40, False, ()), (40, False, (3, 17)), (1000, True, ()),
    (5000, False, (4999,))], ids=["small", "nan_rows", "blob_1000_dup",
                                  "chunked_5000"])
def test_wire_is_bitwise_json_in_the_port(apps, n, dup, nan_rows):
    tapp, nocache, _ = apps
    body, frame = _body_and_frame(n, seed=n + len(nan_rows), dup=dup,
                                  nan_rows=nan_rows)
    c = Client(tapp)
    blob_rows = get_registry().counter(
        "rtpu_wire_copies_avoided_total").labels()
    before = blob_rows.value
    rw = c.post("/api/predict_eta_batch", data=frame, content_type=WIRE_CT)
    assert rw.status_code == 200 and rw.content_type == WIRE_CT
    # the fast lane keyed the wire rows off the frame's bytes
    # (requests up to its 1,024-row bound, and only when no row was NaN)
    assert blob_rows.value - before == (n if n <= 1024 and not nan_rows
                                        else 0)
    rj = _json_post(c, body)
    assert rj.status_code == 200
    _assert_bitwise(rw.get_data(), rj.get_json())
    fresh = _json_post(Client(nocache), body)
    _assert_bitwise(rw.get_data(), fresh.get_json())
    minutes = twc.decode_eta_response(rw.get_data())["minutes"]
    assert np.isnan(minutes[list(nan_rows)]).all()
    assert np.isfinite(np.delete(minutes, list(nan_rows))).all()


def test_wire_matches_the_jax_app_within_f32(apps):
    tapp, _, japp = apps
    _, frame = _body_and_frame(300, seed=7)
    got, want = (Client(a).post("/api/predict_eta_batch", data=frame,
                                content_type=WIRE_CT) for a in (tapp, japp))
    assert got.status_code == want.status_code == 200
    g, w = (twc.decode_eta_response(r.get_data()) for r in (got, want))
    assert sorted(g["bands"]) == sorted(w["bands"]) == ["p10", "p90"]
    for key in ("minutes", "p10", "p90"):
        gv = g["minutes"] if key == "minutes" else g["bands"][key]
        wv = w["minutes"] if key == "minutes" else w["bands"][key]
        np.testing.assert_allclose(gv, wv, rtol=F32[0], atol=F32[1])
    # a stamp moves only when the minutes cross a millisecond
    assert np.abs(g["completion_ms"] - w["completion_ms"]).max() <= \
        60_000 * F32[1] * 2 + 1


def test_wire_matrix_is_json_and_close_to_jax(apps):
    tapp, _, japp = apps
    frame = twc.encode_matrix_request(_PTS, _OPTS)
    tc = Client(tapp)
    rw = tc.post("/api/matrix", data=frame, content_type=WIRE_CT)
    assert rw.status_code == 200 and rw.content_type == WIRE_CT
    wm = twc.decode_matrix_response(rw.get_data())
    jm = tc.post("/api/matrix", json={
        "points": [{"lat": a, "lon": b} for a, b in _PTS], **_OPTS})
    assert wm == jm.get_json()
    xm = twc.decode_matrix_response(Client(japp).post(
        "/api/matrix", data=frame, content_type=WIRE_CT).get_data())
    assert sorted(xm) == sorted(wm)
    for key in ("distances_m", "durations_s"):
        np.testing.assert_allclose(wm[key], xm[key], rtol=1e-6, atol=0.1)


@pytest.mark.parametrize("path,payload", [
    ("/api/predict_eta_batch", b"RTW1junk"),
    ("/api/predict_eta_batch", b""),
    ("/api/matrix", b"RTW1junk"),
    ("/api/matrix", "one_point"),
], ids=["eta_junk", "eta_empty", "matrix_junk", "matrix_one_point"])
def test_400_error_frames_byte_equal_jax(apps, path, payload):
    tapp, _, japp = apps
    if payload == "one_point":
        payload = twc.encode_matrix_request(_PTS[:1], {})
    got, want = (Client(a).post(path, data=payload, content_type=WIRE_CT)
                 for a in (tapp, japp))
    assert got.status_code == want.status_code == 400
    assert got.content_type == want.content_type == WIRE_CT
    assert got.get_data() == want.get_data()


def test_503_error_frame_byte_equal_jax(wire_env, tmp_path):
    missing = str(tmp_path / "missing.msgpack")
    svc = EtaService(ServeConfig(batch_buckets=BUCKETS), model_path=missing,
                     device="cpu")
    tapp = create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=svc)
    japp = _jax_app(missing)
    try:
        _, frame = _body_and_frame(10, seed=1)
        got, want = (Client(a).post("/api/predict_eta_batch", data=frame,
                                    content_type=WIRE_CT)
                     for a in (tapp, japp))
        assert got.status_code == want.status_code == 503
        assert got.get_data() == want.get_data()
        assert twc.decode_error_frame(got.get_data()) == \
            (503, "model unavailable")
    finally:
        for app in (tapp, japp):
            app.dispatch.reopt.stop()


def test_415_when_the_wire_path_is_off(monkeypatch):
    monkeypatch.delenv("RTPU_WIRE", raising=False)
    tapp, japp = _port_app(), _jax_app()
    try:
        assert tapp.wire_handlers == {} == japp.wire_handlers
        _, frame = _body_and_frame(10, seed=2)
        for path in ("/api/predict_eta_batch", "/api/matrix"):
            got, want = (Client(a).post(path, data=frame,
                                        content_type=WIRE_CT)
                         for a in (tapp, japp))
            assert got.status_code == want.status_code == 415
            assert got.get_json() == want.get_json()
            assert "RTPU_WIRE" in got.get_json()["error"]
    finally:
        for app in (tapp, japp):
            app.dispatch.reopt.stop()


# ── the channel, crossed ─────────────────────────────────────────────

# (server package, client package)
CROSSED = [((tchan, tdeadline), jchan), ((jchan, jdeadline), tchan)]
CROSSED_IDS = ["port_server-jax_client", "jax_server-port_client"]


def _join(*threads):
    for t in threads:
        t.join(10)
        assert not t.is_alive()


@pytest.mark.parametrize("server,client", CROSSED, ids=CROSSED_IDS)
def test_channel_multiplexes_on_one_connection(server, client):
    chan, _ = server
    order = []

    def handler(frame):
        delay = float(frame.decode())
        time.sleep(delay)
        order.append(delay)
        return 200, frame

    srv = chan.WireChannelServer({"/h": handler}, "127.0.0.1", 0)
    srv.start()
    try:
        cli = client.WireChannelClient("127.0.0.1", srv.port)
        outs = [None, None]

        def call(i, delay):
            outs[i] = cli.request("/h", str(delay).encode(), timeout=30.0)

        slow = threading.Thread(target=call, args=(0, 0.5))
        slow.start()
        time.sleep(0.05)
        fast = threading.Thread(target=call, args=(1, 0.0))
        fast.start()
        _join(slow, fast)
        assert outs[0] == (200, b"0.5") and outs[1] == (200, b"0.0")
        assert order == [0.0, 0.5]  # no head-of-line blocking
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("server,client", CROSSED, ids=CROSSED_IDS)
def test_channel_deadline_and_error_frames(server, client):
    chan, deadline = server

    def slow(frame):
        time.sleep(0.05)
        if deadline.expired():
            raise deadline.DeadlineExceeded("budget burned")
        return 200, frame

    srv = chan.WireChannelServer({"/slow": slow}, "127.0.0.1", 0)
    srv.start()
    try:
        cli = client.WireChannelClient("127.0.0.1", srv.port)
        status, body = cli.request("/slow", b"x", deadline_ms=0)
        assert (status, twc.decode_error_frame(body)[0]) == (504, 504)
        status, _ = cli.request("/slow", b"x", deadline_ms=10.0)
        assert status == 504
        assert cli.request("/slow", b"x", deadline_ms=5_000.0) == (200, b"x")
        status, body = cli.request("/nope", b"x")
        assert status == 404
        assert "no wire handler" in twc.decode_error_frame(body)[1]
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("server,client", CROSSED, ids=CROSSED_IDS)
def test_channel_dead_socket_fails_loudly_then_reconnects(server, client):
    chan, _ = server
    srv = chan.WireChannelServer({"/e": lambda f: (200, f)}, "127.0.0.1", 0)
    srv.start()
    before = set(threading.enumerate())
    cli = client.WireChannelClient("127.0.0.1", srv.port)
    assert cli.request("/e", b"a") == (200, b"a")
    reader = [t for t in threading.enumerate()
              if t not in before and t.name.startswith("wirechannel-read-")]
    port = srv.port
    srv.stop()
    with pytest.raises(client.WireChannelError):
        cli.request("/e", b"b", timeout=3.0)
    # The dead socket's reader thread reports its death too, and when the
    # failed send killed the socket first, that second kill can come
    # late. The JAX client's kill fails every pending request, not only
    # the dead socket's, so under load a late one failed the reconnected
    # request below: with that client the reader must end first. The
    # port's client fails only the dead socket's requests
    # (test_a_late_kill_of_a_dead_socket_spares_the_new_channel), so its
    # crossings reconnect without waiting, racing the late kill.
    if client is jchan:
        _join(*reader)
    srv2 = None
    deadline = time.monotonic() + 10
    while srv2 is None:
        try:
            srv2 = chan.WireChannelServer({"/e": lambda f: (200, f)},
                                          "127.0.0.1", port)
            srv2.start()
        except OSError:
            srv2 = None
            assert time.monotonic() < deadline, "port never freed"
            time.sleep(0.1)
    try:
        assert cli.request("/e", b"c") == (200, b"c")
        cli.close()
    finally:
        srv2.stop()


@pytest.mark.parametrize("server", [tchan, jchan], ids=["port", "jax"])
def test_a_late_kill_of_a_dead_socket_spares_the_new_channel(server):
    """The port's client. A socket dies twice when a send on it fails
    first (the request path kills it) and its reader thread, woken by
    that kill, kills it again; under load the reader can run after the
    client has reconnected and sent on the new channel. That late kill
    must fail only the dead socket's requests: failing every pending one
    made ``test_channel_dead_socket_fails_loudly_then_reconnects`` fail
    its reconnect with the old socket's error under the suite's load."""
    gate = threading.Event()

    def slow(frame):
        gate.wait(10)
        return 200, frame

    srv = server.WireChannelServer({"/e": lambda f: (200, f), "/slow": slow},
                                   "127.0.0.1", 0)
    srv.start()
    cli = tchan.WireChannelClient("127.0.0.1", srv.port)
    try:
        assert cli.request("/e", b"a") == (200, b"a")
        old = cli._sock
        cli._kill(old, "send failed")           # the request path's kill
        out = []
        call = threading.Thread(target=lambda: out.append(
            cli.request("/slow", b"c", timeout=10)))
        call.start()
        deadline = time.monotonic() + 10
        while not (cli._pending and cli._sock not in (None, old)):
            assert time.monotonic() < deadline, "no request on a new channel"
            time.sleep(0.01)
        cli._kill(old, "peer closed the wire channel")   # the reader's
        gate.set()
        _join(call)
        assert out == [(200, b"c")]
    finally:
        gate.set()
        cli.close()
        srv.stop()


@pytest.mark.parametrize("server,client", CROSSED, ids=CROSSED_IDS)
def test_channel_rejects_oversized_messages(server, client):
    chan, _ = server
    srv = chan.WireChannelServer({"/e": lambda f: (200, f)}, "127.0.0.1", 0,
                                 max_frame_bytes=1024)
    srv.start()
    try:
        cli = client.WireChannelClient("127.0.0.1", srv.port)
        with pytest.raises(client.WireChannelError):
            cli.request("/e", b"\x00" * (1 << 20), timeout=5.0)
        cli.close()
    finally:
        srv.stop()


def test_channel_close_ends_its_threads():
    """Closing the port's client wakes its reader and ends the server's
    connection thread: no thread of a closed channel is left behind."""
    before = set(threading.enumerate())
    srv = tchan.WireChannelServer({"/e": lambda f: (200, f)}, "127.0.0.1", 0)
    srv.start()
    try:
        cli = tchan.WireChannelClient("127.0.0.1", srv.port)
        assert cli.request("/e", b"a") == (200, b"a")
        names = ("wirechannel-conn-", f"wirechannel-read-{srv.port}")
        ours = [t for t in set(threading.enumerate()) - before
                if t.name.startswith(names)]
        assert sorted(t.name[:17] for t in ours) == [
            "wirechannel-conn-", "wirechannel-read-"]
        cli.close()
        _join(*ours)
    finally:
        srv.stop()


def test_port_app_over_its_channel_to_the_jax_client(apps):
    tapp, _, _ = apps
    body, frame = _body_and_frame(64, seed=11)
    srv = tchan.WireChannelServer(tapp.wire_handlers, "127.0.0.1", 0)
    srv.start()
    try:
        cli = jchan.WireChannelClient("127.0.0.1", srv.port)
        status, raw = cli.request("/api/predict_eta_batch", frame)
        assert status == 200
        _assert_bitwise(raw, _json_post(Client(tapp), body).get_json())
        status, raw = cli.request("/api/predict_eta_batch", b"RTW1junk")
        assert status == 400
        assert "malformed" in jwc.decode_error_frame(raw)[1]
        cli.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("collide", [False, True], ids=["free", "taken"])
def test_server_entry_serves_the_channel(monkeypatch, collide):
    """``python -m routest_tpu_torch.serve``'s ``main`` with
    ``RTPU_WIRE=1`` starts the channel on ``RTPU_WIRE_PORT``; a port
    already taken is logged and the HTTP negotiation still serves."""
    import socket

    from routest_tpu_torch.serve import __main__ as entry

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    wire_port = blocker.getsockname()[1]
    if collide:
        blocker.listen(1)
    else:
        blocker.close()
    for name, value in {"ETA_MODEL_PATH": ARTIFACT, "ROUTEST_DEVICE": "cpu",
                        "RTPU_WIRE": "1", "RTPU_WIRE_PORT": str(wire_port),
                        "RTPU_BATCH_BUCKETS": "8,64", "RTPU_DISPATCH": "0",
                        "ROUTEST_WARM_BUCKETS": "0"}.items():
        monkeypatch.setenv(name, value)
    body, frame = _body_and_frame(20, seed=5)
    seen = {}

    def serve(app, host, port):
        # stands in for the blocking server: the channel is up now
        seen["http"] = Client(app).post("/api/predict_eta_batch",
                                        data=frame, content_type=WIRE_CT)
        seen["json"] = _json_post(Client(app), body)
        if not collide:
            cli = jchan.WireChannelClient("127.0.0.1", wire_port)
            seen["channel"] = cli.request("/api/predict_eta_batch", frame)
            cli.close()
        return 0

    class _Log:
        def __init__(self):
            self.events = []

        def _add(self, event, **fields):
            self.events.append(event)

        info = warning = error = debug = _add

    log = _Log()
    monkeypatch.setattr(entry, "run_with_graceful_shutdown", serve)
    monkeypatch.setattr(entry, "_log", log)
    try:
        entry.main()
    finally:
        blocker.close()
    assert seen["http"].status_code == 200
    _assert_bitwise(seen["http"].get_data(), seen["json"].get_json())
    assert ("wire_channel_bind_failed" in log.events) is collide
    if not collide:
        assert seen["channel"] == (200, seen["http"].get_data())
