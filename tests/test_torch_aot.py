"""The port's per-bucket serving entries against the JAX package's AOT
ones, on the CPU.

- ``RTPU_SERVE_AOT`` and ``ROUTEST_ROUTER_AOT`` parse as the JAX
  package's over one table of strings.
- ``scoring_info()`` and ``/api/health``'s ``checks.model.scoring``
  carry the JAX keys ``aot`` / ``aot_buckets``: the port's CPU service
  captures nothing (``false`` / ``[]``), and with ``RTPU_SERVE_AOT=0``
  both packages read so.
- The ETA bucket table (``serve/graphs.py``) under 8 threads of random
  submits, with a stand-in replay that computes on the CPU: every waiter
  gets its own rows' answer, never a view of a static buffer, also while
  the table is released mid-run — the twin of
  ``tests/test_scoring_artifact.py::test_donation_safe_staging_slab_fuzz``.
- The overlay solve captured per bucket (``_OverlayGraph``), replayed
  through a stand-in capture whose "graph" re-runs the captured function
  and writes its outputs into the captured ones in place (a CUDA
  graph's static buffers, on the CPU): distances and predecessors
  bitwise the JAX router's AOT solve and the port's eager solve at
  buckets 2 and 16 and at a size that is no bucket, with the eager
  loop's count of host checks. JAX test setting:
  ``generate_road_graph(n_nodes=900, seed=23)``, cell target 64.
- ``ROUTEST_TILE_URL``: both apps' ``tiles`` answers equal with the knob
  unset, a tile server up, one unreachable and one that does not speak
  HTTP; the chip-identity keys of ``checks.tpu`` as the JAX app's.
"""

import http.server
import socket
import threading
import types

import numpy as np
import pytest
import torch
from werkzeug.test import Client

from routest_tpu.core.config import Config as JConfig
from routest_tpu.core.config import ServeConfig as JServeConfig
from routest_tpu.core.config import load_config as jload_config
from routest_tpu.data.road_graph import generate_road_graph
from routest_tpu.optimize import road_router as jrr
from routest_tpu.serve import app as japp_mod
from routest_tpu.serve.app import create_app as jax_create_app
from routest_tpu.serve.ml_service import EtaService as JEtaService
from routest_tpu_torch.core.config import Config, ServeConfig, load_config
from routest_tpu_torch.optimize import hierarchy as th
from routest_tpu_torch.optimize import road_router as trr
from routest_tpu_torch.serve import app as tapp_mod
from routest_tpu_torch.serve import graphs
from routest_tpu_torch.serve.app import create_app
from routest_tpu_torch.serve.ml_service import DynamicBatcher, EtaService

ARTIFACT = "artifacts/eta_mlp.msgpack"
KNOB_VALUES = ("", "0", "off", "auto", "2,16", "3, 9,x,0")


# ── the knobs ─────────────────────────────────────────────────────────

@pytest.mark.parametrize("raw", KNOB_VALUES)
def test_serve_aot_knob_parses_as_jax(raw, monkeypatch):
    monkeypatch.setenv("RTPU_SERVE_AOT", raw)
    assert load_config().serve.serve_aot is jload_config().serve.serve_aot


@pytest.mark.parametrize("raw", KNOB_VALUES)
def test_router_aot_knob_parses_as_jax(raw, monkeypatch):
    monkeypatch.setenv("ROUTEST_ROUTER_AOT", raw)
    assert trr.router_aot_buckets() == jrr.RoadRouter._aot_buckets()


# ── scoring_info and health ───────────────────────────────────────────

@pytest.fixture(scope="module")
def apps():
    mp = pytest.MonkeyPatch()
    for name, value in {"ROUTEST_WARM_BUCKETS": "0", "RTPU_SLO_TICK_S": "0",
                        "RTPU_LEDGER_PUBLISH": "0"}.items():
        mp.setenv(name, value)
    jeta = JEtaService(JServeConfig(batch_buckets=(8,)), model_path=ARTIFACT)
    teta = EtaService(ServeConfig(device="cpu", batch_buckets=(8,)),
                      model_path=ARTIFACT)
    japp = jax_create_app(JConfig(), eta_service=jeta)
    tapp = create_app(Config(serve=ServeConfig(device="cpu")),
                      eta_service=teta)
    yield japp, tapp, jeta, teta
    for app in (japp, tapp):
        for part in (app.slo, app.timeline, app.efficiency,
                     app.change_ledger):
            if part is not None:
                part.stop()
        if app.dispatch is not None and app.dispatch.reopt is not None:
            app.dispatch.reopt.stop()
    tapp.close()
    mp.undo()


def test_scoring_aot_keys_on_the_cpu(apps):
    """The JAX CPU service compiles its buckets; the port's captures
    nothing there: the same keys and types, false / []."""
    japp, tapp, jeta, teta = apps
    want = jeta.scoring_info()
    got = teta.scoring_info()
    assert want["aot"] is True and want["aot_buckets"] == [8]
    assert got["aot"] is False and got["aot_buckets"] == []
    jh = Client(japp).get("/api/health").get_json()
    th_ = Client(tapp).get("/api/health").get_json()
    jscore = jh["checks"]["model"]["scoring"]
    tscore = th_["checks"]["model"]["scoring"]
    assert {k: type(v) for k, v in tscore.items() if k.startswith("aot")} \
        == {k: type(v) for k, v in jscore.items() if k.startswith("aot")}
    assert (tscore["aot"], tscore["aot_buckets"]) == (False, [])


def test_scoring_aot_keys_with_serve_aot_off():
    jeta = JEtaService(JServeConfig(batch_buckets=(8,), serve_aot=False),
                       model_path=ARTIFACT)
    teta = EtaService(ServeConfig(device="cpu", batch_buckets=(8,),
                                  serve_aot=False), model_path=ARTIFACT)
    want, got = jeta.scoring_info(), teta.scoring_info()
    assert (got["aot"], got["aot_buckets"]) \
        == (want["aot"], want["aot_buckets"]) == (False, [])
    rows = np.zeros((3, 12), np.float32)
    np.testing.assert_allclose(teta.predict_batch(rows),
                               jeta.predict_batch(rows), rtol=1e-5)
    teta.close()


def test_device_identity_keys_as_jax(apps):
    japp, tapp = apps[:2]
    keys = {"device_kind", "peak_tflops_bf16", "peak_hbm_gbps", "last_bench"}
    jtpu = Client(japp).get("/api/health").get_json()["checks"]["tpu"]
    ttpu = Client(tapp).get("/api/health").get_json()["checks"]["tpu"]
    assert keys & set(ttpu) == keys & set(jtpu) == {"device_kind"}
    assert ttpu["device_kind"] == jtpu["device_kind"] == "cpu"


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),
    ("cpu", (None, None)), ("TPU v5 lite", (None, None))])
def test_chip_peaks_table(name, want):
    from routest_tpu_torch.utils.cuda_timing import chip_peaks

    assert chip_peaks(name) == want


# ── ROUTEST_TILE_URL ──────────────────────────────────────────────────

class _Tiles(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200 if self.path.endswith(".png") else 404)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def tile_server():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Tiles)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


@pytest.fixture(scope="module")
def not_http():
    """A listener that answers every connection with a non-HTTP line."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    stop = threading.Event()

    def serve():
        sock.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                continue
            with conn:
                conn.sendall(b"-ERR not a tile server\r\n")

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{sock.getsockname()[1]}/0/0/0.png"
    stop.set()
    thread.join(timeout=5)
    sock.close()


def _closed_port_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}/0/0/0.png"


@pytest.mark.parametrize("case", ["unset", "up", "404", "unreachable",
                                  "not_http"])
def test_tiles_status_as_jax(case, tile_server, not_http, monkeypatch):
    url = {"unset": None, "up": tile_server + "/0/0/0.png",
           "404": tile_server + "/missing", "unreachable": _closed_port_url(),
           "not_http": not_http}[case]
    if url is None:
        monkeypatch.delenv("ROUTEST_TILE_URL", raising=False)
    else:
        monkeypatch.setenv("ROUTEST_TILE_URL", url)
    want = japp_mod._tiles_status(types.SimpleNamespace(
        _tiles_cache=(0.0, None)))
    got = tapp_mod._tiles_status([0.0, None])
    assert got == want == {"unset": "static", "up": True}.get(case, False)


def test_tiles_status_cached_30s(tile_server, monkeypatch):
    monkeypatch.setenv("ROUTEST_TILE_URL", tile_server + "/0/0/0.png")
    cache = [0.0, None]
    assert tapp_mod._tiles_status(cache) is True
    monkeypatch.setenv("ROUTEST_TILE_URL", _closed_port_url())
    assert tapp_mod._tiles_status(cache) is True     # cached
    cache[0] -= 31.0
    assert tapp_mod._tiles_status(cache) is False


def test_tiles_through_both_apps(apps, tile_server, monkeypatch):
    monkeypatch.setenv("ROUTEST_TILE_URL", tile_server + "/0/0/0.png")
    japp, tapp = apps[:2]
    assert (Client(tapp).get("/api/health").get_json()["tiles"]
            is Client(japp).get("/api/health").get_json()["tiles"] is True)


# ── the ETA bucket table's buffer discipline ─────────────────────────

def _table(buckets, n_feat=12):
    """A GraphTable whose replays compute on the CPU into the static
    output: ``(x * 2 + 1).sum(axis=1)`` per row, as the JAX fuzz."""
    counts = {"replays": 0, "eager": 0}

    def forward(x):
        return (x * 2.0 + 1.0).sum(axis=1)

    entries = {}
    for b in buckets:
        h_in = np.zeros((b, n_feat), np.float32)
        h_out = np.zeros((b,), np.float32)

        def replay(h_in=h_in, h_out=h_out):
            h_out[...] = forward(h_in)

        def on_replay():
            counts["replays"] += 1

        entries[b] = graphs.BucketGraph(b, h_in, h_out, replay,
                                        on_replay=on_replay)

    def eager(x):
        counts["eager"] += 1
        return forward(np.asarray(x, np.float32))

    return graphs.GraphTable(entries, eager), entries, counts


def test_bucket_table_fuzz_no_static_alias():
    table, entries, counts = _table((4, 16, 64))
    batcher = DynamicBatcher(table, buckets=(4, 16, 64), max_batch=64,
                             max_wait_ms=5.0)
    rng = np.random.default_rng(13)
    n_threads, iters = 8, 25
    payloads = [[rng.uniform(-50, 50, size=(int(rng.integers(1, 9)), 12))
                 .astype(np.float32) for _ in range(iters)]
                for _ in range(n_threads)]
    statics = [a for e in entries.values() for a in (e.h_in, e.h_out)]
    failures = []
    barrier = threading.Barrier(n_threads)

    def worker(t):
        barrier.wait()
        for k, rows in enumerate(payloads[t]):
            if t == 0 and k == iters // 2:
                table.release()        # mid-run: later flushes go eager
            got = batcher.submit(rows)
            want = (rows * 2.0 + 1.0).sum(axis=1)
            if (got.shape != want.shape
                    or not np.allclose(got, want, rtol=1e-5, atol=1e-2)
                    or any(np.shares_memory(got, a) for a in statics)):
                failures.append((t, k, rows.shape))
                return

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert counts["replays"] > 0 and counts["eager"] > 0
    assert all(e.released and e.h_in is None for e in entries.values())


def test_bucket_table_exact_lengths_only():
    table, _, counts = _table((8,))
    x = np.ones((8, 12), np.float32)
    out = table(x)
    assert counts == {"replays": 1, "eager": 0}
    table(np.ones((7, 12), np.float32))
    assert counts == {"replays": 1, "eager": 1}
    out[:] = -1.0                       # the caller owns its copy
    np.testing.assert_array_equal(table(x), np.full(8, 36.0, np.float32))
    assert table.buckets == (8,)


# ── the overlay solve, captured per bucket ────────────────────────────

def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        dst.copy_(src)


class _StandInGraph:
    """A CUDA graph's replay on the CPU: re-run the captured function and
    write its outputs into the captured (static) ones in place."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        _copy_into(self.out, self.fn())


def _stand_in_capture(fn, device):
    for _ in range(2):
        fn()
    out = fn()
    return _StandInGraph(fn, out), out


def _checks():
    return (th._relax_ell.calls + th.relax_from.calls,
            th._relax_ell.sweeps + th.relax_from.sweeps,
            th._relax_ell.checks + th.relax_from.checks)


@pytest.fixture(scope="module")
def routers():
    mp = pytest.MonkeyPatch()
    mp.setenv("ROUTEST_HIER_MIN_NODES", "1")
    mp.setenv("ROUTEST_HIER_CELL_TARGET", "64")
    mp.setenv("ROUTEST_ROUTER_AOT", "2,16")
    mp.setenv("ROUTEST_ROUTE_CACHE", "0")
    graph = generate_road_graph(n_nodes=900, seed=23)
    jr = jrr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False)
    tr = trr.RoadRouter(graph=graph, use_gnn=False, use_transformer=False,
                        device="cpu")
    mp.setattr(graphs, "capture", _stand_in_capture)
    tr._capture_solves()
    yield jr, tr
    mp.undo()


def test_router_captured_buckets_and_solver_info(routers):
    jr, tr = routers
    assert sorted(jr._aot) == sorted(tr._aot) == [2, 16]
    info, jinfo = tr.solver_info, jr.solver_info
    assert list(info) == list(jinfo)
    assert info["aot_buckets"] == jinfo["aot_buckets"] == [2, 16]
    assert info["aot_compile_s"] > 0


@pytest.mark.parametrize("n_src", [2, 16, 3, 9])
def test_captured_overlay_solve_bitwise(routers, n_src):
    """Buckets 2 and 16 replay; 3 (bucket 4) solves eagerly in the port
    and jitted in JAX; 9 pads to 16 and replays."""
    jr, tr = routers
    src = np.random.default_rng(n_src).integers(0, tr.n_nodes, n_src)
    jd, jp = jr.shortest(src)
    before = _checks()
    td, tp = tr.shortest(src)
    replayed = np.subtract(_checks(), before)
    graph, tr._aot = tr._aot, {}
    try:
        before = _checks()
        ed, ep = tr.shortest(src)
        eager = np.subtract(_checks(), before)
    finally:
        tr._aot = graph
    for d, p in ((td, tp), (ed, ep)):
        assert d.dtype == jd.dtype and p.dtype == jp.dtype == np.int32
        assert d.tobytes() == jd.tobytes() and p.tobytes() == jp.tobytes()
    # the same loops, sweeps and host checks as the eager solve
    assert tuple(replayed) == tuple(eager) and eager[2] > 0


def test_captured_solve_through_the_program_steps(routers):
    """One bucket's program replayed twice with different sources: the
    second answer does not carry state from the first."""
    _, tr = routers
    g = tr._aot[16]
    rng = np.random.default_rng(5)
    a = rng.integers(0, tr.n_nodes, 16)
    b = rng.integers(0, tr.n_nodes, 16)
    solve = tr._make_overlay_solve(tr._hier)
    for src in (a, b, a):
        got_d, got_p = g.solve(src.astype(np.int64), 16)
        dist, pred = solve(*tr._hier.prep_sources(src),
                           torch.from_numpy(src.astype(np.int64)))
        want_d, want_p = trr.RoadRouter._fetch(dist, pred)
        assert got_d.tobytes() == want_d.tobytes()
        assert got_p.tobytes() == want_p.tobytes()
