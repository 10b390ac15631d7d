"""Incident correlation on the card: every page names its suspect
change → artifacts/incidents_cuda.json.

The port's counterpart of ``scripts/bench_incidents.py``. Three injected
incidents flow through the port's real pipeline — state changes recorded
into the process ``ChangeLedger``, a page edge fired by the real
machinery, the ``FlightRecorder`` ranking suspects into the bundle's
``suspects.json`` — and the injected cause must rank first:

- ``bad_deploy``        a version serving 500s (the JAX script's stub
                        workers) rolled out by the port's
                        ``RolloutController`` over its ``Gateway`` and
                        ``ReplicaSupervisor``; the ``canary_error_rate``
                        rollback bundle must rank the rollout's own
                        ``rollout.phase`` first, matched on the version,
                        above live-flip noise recorded beside it;
- ``jammed_customize``  ``live.customize:error=1.0`` armed through the
                        port's ``chaos`` jams the port's
                        ``MetricCustomizer``; the port's ``SloEngine``
                        pages, and the jam must rank first, never a
                        legitimate pre-jam flip;
- ``region_kill``       ``GeoFront.kill_region("east")`` over two stub
                        regions; a reachability SLO pages naming the dead
                        region, and ``region.kill`` must rank first,
                        matched on the region;
- ``clean_window``      ≥ 20 real customize flips and ≥ 2 verified model
                        swaps of an ``EtaService`` on the card (the
                        golden-batch gate scores through the fused
                        kernel) under a healthy SLO engine: zero pages,
                        zero false attributions.

Each scenario installs a private ledger and recorder, restored on exit
(:class:`_Obs`). The checks are the JAX script's, by name, computed by
:func:`judge` from the record's own keys. The record adds the fused
launches the clean window's service made (``launches``) and the card's
name and power limit. ``--cpu`` scores the clean window on the CPU for a
rehearsal; without a card and without ``--cpu`` the script exits 2.

Usage: python3 scripts/bench_incidents_cuda.py [--quick] [--cpu]
       [--seed 42] [--scenarios bad_deploy jammed_customize region_kill
        clean_window] [--out artifacts/incidents_cuda.json]
       [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import http.server
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

# The JAX script's stub worker (bench_incidents.py:58-98), byte for byte:
# a canary that answers every POST with 500 when STUB_FAIL=1.
_STUB_WORKER = """
import http.server, json, os
VERSION = os.environ.get("RTPU_VERSION") or None
FAIL = os.environ.get("STUB_FAIL") == "1"
class H(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a):
        pass
    def _send(self, code, payload):
        b = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(b)))
        self.end_headers()
        self.wfile.write(b)
    def do_GET(self):
        bare = self.path.split("?", 1)[0]
        if bare == "/api/health":
            self._send(200, {"checks": {"model": {
                "status": "ok", "generation": 1,
                "fingerprint": "stub-" + (VERSION or "none")}},
                "status": "ok"})
        elif bare == "/api/version":
            self._send(200, {"version_label": VERSION,
                             "build": {"version": "stub"},
                             "model": {"generation": 1,
                                       "fingerprint":
                                       "stub-" + (VERSION or "none")}})
        else:
            self._send(200, {"ok": True, "version": VERSION})
    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.rfile.read(n)
        if FAIL:
            self._send(500, {"error": "stub failure", "version": VERSION})
        else:
            self._send(200, {"eta_minutes_ml": 1.0, "version": VERSION})
srv = http.server.ThreadingHTTPServer(("127.0.0.1", int(os.environ["PORT"])), H)
srv.daemon_threads = True
srv.serve_forever()
"""

# The JAX script's settings (bench_incidents.py:275-311, 583-600).
BAD_VERSION = "v2-err"
ROLLOUT = {"canary_fraction": 0.25, "canary_replicas": 1, "bake_s": 30.0,
           "tick_s": 0.1, "max_unavailable": 1, "min_canary_requests": 5,
           "max_error_rate": 0.05, "max_error_ratio": 3.0,
           "latency_threshold_ms": 1500.0, "max_latency_regression": 0.25,
           "crash_restarts": 2, "boot_timeout_s": 20.0,
           "health_timeout_s": 5.0, "drain_timeout_s": 5.0}
JAM_SPEC = "live.customize:error=1.0"
JAM_KINDS = ("live.customize_failed", "chaos.fire", "chaos.arm")
DEAD_REGION = "east"
MIN_FLIPS, MIN_SWAPS = 20, 2
PAGE_TICKS = 60
HOST_NOTE = ("attribution is a pure function of the ledger and the page "
             "scope, so the checks are host-independent; only "
             "wall-seconds (rollout convergence, ticks to page) are "
             "time-shared host numbers")


def phase_sizes(quick: bool) -> tuple:
    """The JAX script's ``(clean_ticks, clean_flips)``."""
    return (8, 20) if quick else (15, 30)


def _post(base, path, payload, timeout=15.0):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _Pump:
    """Background client pumping the gateway so the canary comparison
    has traffic to judge."""

    def __init__(self, base, interval_s=0.005):
        self.base = base
        self.interval_s = interval_s
        self.statuses = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                status, _ = _post(self.base, "/api/predict_eta", {},
                                  timeout=10)
                self.statuses.append(status)
            except Exception:
                pass
            time.sleep(self.interval_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


# ── per-scenario obs install (swap-and-restore) ──────────────────────


class _Obs:
    """A private ChangeLedger + FlightRecorder of the port installed
    process-wide for one scenario, restored on exit."""

    def __init__(self, workdir: str, name: str) -> None:
        from routest_tpu_torch.core.config import (LedgerConfig,
                                                   RecorderConfig)
        from routest_tpu_torch.obs.ledger import (ChangeLedger,
                                                  configure_change_ledger)
        from routest_tpu_torch.obs.recorder import (FlightRecorder,
                                                    configure_recorder)
        from routest_tpu_torch.obs.registry import MetricsRegistry

        self._configure_ledger = configure_change_ledger
        self._configure_recorder = configure_recorder
        self.dir = os.path.join(workdir, name)
        self.ledger = ChangeLedger(
            config=LedgerConfig(enabled=True, capacity=512,
                                window_s=900.0, max_suspects=5,
                                publish=False, channel="rtpu.changes",
                                incidents_kept=64, region=""),
            registry=MetricsRegistry())
        self.recorder = FlightRecorder(RecorderConfig(
            dir=self.dir, min_interval_s=0.0, followup_s=0.0))
        self.recorder.register_change_ledger(self.ledger)

    def __enter__(self):
        self._prev_ledger = self._configure_ledger(self.ledger)
        self._configure_recorder(self.recorder)
        return self

    def __exit__(self, *exc):
        self._configure_ledger(self._prev_ledger)
        self._configure_recorder(None)

    def incident(self, reason: str):
        """Newest incident with ``reason`` → (incident, suspects from
        the bundle's suspects.json) or (None, [])."""
        incs = [i for i in self.recorder.incidents_snapshot()
                if i.get("reason") == reason]
        if not incs:
            return None, []
        inc = incs[-1]
        path = os.path.join(self.dir, inc["bundle"], "suspects.json")
        try:
            with open(path) as f:
                return inc, json.load(f)["suspects"]
        except OSError:
            return inc, []


def _thin_suspects(suspects, n=3):
    return [{"kind": s["event"]["kind"], "score": s["score"],
             "matched": s["matched"], "mismatched": s["mismatched"],
             "age_s": s["age_s"],
             "labels": {k: s["event"][k]
                        for k in ("replica", "version", "region",
                                  "bucket") if s["event"].get(k)}}
            for s in suspects[:n]]


def _flip_noise(count: int) -> None:
    """Legitimate fleet-wide flips recorded beside the incident — the
    ranker must keep them below the true cause."""
    from routest_tpu_torch.obs.ledger import record_change

    for i in range(count):
        record_change("live.flip", detail={"epoch": 1000 + i,
                                           "obs_edges": 12})


# ── the JAX script's verdicts, on a scenario's record ────────────────


def _top(out: dict) -> dict:
    suspects = out.get("suspects") or []
    return suspects[0] if suspects else {}


def judge(name: str, out: dict) -> dict:
    """The JAX scenario's checks (names and rules) from its record:
    ``suspects`` thinned as :func:`_thin_suspects` thins them (the
    labels an event carries), ``paged`` whether the incident was found
    (the JAX record keeps its ``page_scope``; a found incident always
    has one), ``clean_paged`` whether the clean phase paged (the JAX
    record keeps no such key: it reads as False), ``swaps_accepted``
    the reloads that returned True (the JAX record keeps only the
    ledger's count, ``verified_swaps``) and ``incident_suspects`` each
    clean-window incident's suspect count."""
    top = _top(out)
    kind = top.get("kind")
    labels = top.get("labels") or {}
    matched = top.get("matched") or ()
    paged = bool(out.get("paged", out.get("page_scope") is not None)
                 and out.get("suspects"))
    if name == "bad_deploy":
        return {
            "rolled_back": out.get("final_state") == "rolled_back",
            "paged_with_suspects": paged,
            "true_cause_ranked_first": kind == "rollout.phase",
            "offending_version_matched": bool(
                top and labels.get("version") == BAD_VERSION
                and "version" in matched),
            "noise_below_cause": bool(top and kind != "live.flip"),
        }
    if name == "jammed_customize":
        return {
            "clean_window_quiet": not out.get("clean_paged", False)
            and (out.get("clean_flips") or 0) > 0,
            "paged_with_suspects": paged,
            "true_cause_ranked_first": kind in JAM_KINDS,
            "no_flip_blamed": bool(top and kind != "live.flip"),
        }
    if name == "region_kill":
        return {
            "clean_window_quiet": not out.get("clean_paged", False),
            "paged_with_suspects": paged,
            "dead_region_named": bool(
                out.get("paged", out.get("page_scope") is not None)
                and (out.get("page_scope") or {}).get("dead_region")
                == DEAD_REGION),
            "true_cause_ranked_first": kind == "region.kill",
            "region_matched": bool(
                top and labels.get("region") == DEAD_REGION
                and "region" in matched),
        }
    if name == "clean_window":
        swaps = out.get("swaps_accepted", out.get("verified_swaps", 0))
        return {
            "enough_flips": out.get("flips", 0) >= MIN_FLIPS,
            "enough_swaps": swaps >= MIN_SWAPS
            and out.get("verified_swaps", 0) >= MIN_SWAPS,
            "zero_pages": out.get("incidents", 0) == 0,
            "zero_false_attributions": all(
                not n for n in out.get("incident_suspects", ())),
        }
    raise KeyError(name)


def _finish(name: str, out: dict) -> dict:
    out["checks"] = judge(name, out)
    out["pass"] = all(out["checks"].values())
    return out


# ── a minimal real customize loop (jam + clean-window scenarios) ─────


class _TinyRouter:
    """The slice of the router surface MetricCustomizer touches:
    ``edge_time_s`` + ``install_live_metric``. The live.flip ledger
    record comes from the real customizer path; only the metric
    install is stubbed (the full path is proven by
    ``bench_live_traffic_cuda.py``)."""

    def __init__(self, n_edges: int = 16) -> None:
        import numpy as np

        self._base = np.full(n_edges, 5.0, dtype=np.float32)
        self.installs = 0

    def edge_time_s(self, hour):
        return self._base

    def install_live_metric(self, metric, epoch, route=True):
        self.installs += 1
        return {"epoch": epoch}


def _customizer():
    import numpy as np

    from routest_tpu_torch.live.customize import MetricCustomizer
    from routest_tpu_torch.live.state import CongestionState

    state = CongestionState(np.full(16, 5.0, dtype=np.float32),
                            half_life_s=30, stale_s=600)
    return MetricCustomizer(_TinyRouter(), state, interval_s=1,
                            min_obs_edges=0)


def _engine():
    """A real SloEngine with tight windows so the bench ticks through
    a synthetic clock instead of sleeping."""
    from routest_tpu_torch.core.config import SloConfig
    from routest_tpu_torch.obs.registry import MetricsRegistry
    from routest_tpu_torch.obs.slo import SloEngine

    return SloEngine(SloConfig(tick_s=1.0, fast_window_s=10.0,
                               slow_window_s=30.0, page_burn=2.0,
                               warn_burn=1.0), component="bench",
                     metrics_registry=MetricsRegistry())


def _customize_objective(engine, cust, obs):
    """The cycle-availability objective over ``cust``'s cycles →
    ``tick(now)``: one customize cycle, then one engine tick."""
    from routest_tpu_torch.obs.slo import SloObjective

    cycles = {"total": 0, "bad": 0}
    engine.add_objective(SloObjective(
        "availability:customize", "availability", 0.99,
        lambda: (cycles["total"], cycles["bad"]),
        detail={"surface": "live.customize"}))
    engine.on_page.append(obs.recorder.on_slo_page)

    def tick(now):
        cycles["total"] += 1
        if not cust.run_once(now=now)["flipped"]:
            cycles["bad"] += 1
        engine.tick(now=now)

    return tick


# ── scenario: bad deploy via rollout ─────────────────────────────────


def scenario_bad_deploy(args, workdir: str) -> dict:
    """A version serving 500s canaries out through the port's rollout
    state machine; the canary_error_rate rollback bundle must open with
    the rollout's own phase transition as suspect #1."""
    from routest_tpu_torch.core.config import FleetConfig, RolloutConfig
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.rollout import RolloutController
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    with _Obs(workdir, "bad_deploy") as obs:
        ports = [harness.free_port() for _ in range(2)]
        sup = ReplicaSupervisor(
            ports, command=lambda p: [sys.executable, "-c", _STUB_WORKER],
            probe_interval_s=0.15, backoff_base_s=0.2, backoff_cap_s=1.0)
        sup.start()
        if not sup.ready(timeout=30):
            sup.drain(timeout=10)
            raise RuntimeError("stub fleet never became ready")
        gw = Gateway([("127.0.0.1", p) for p in ports],
                     FleetConfig(hedge=False), supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            _flip_noise(3)
            ctl = RolloutController(sup, gw, RolloutConfig(**ROLLOUT))
            with _Pump(base, interval_s=0.002):
                if not ctl.start(BAD_VERSION, env={
                        "RTPU_VERSION": BAD_VERSION, "STUB_FAIL": "1"}):
                    raise RuntimeError("the rollout did not start")
                final = ctl.wait(timeout=90)
            inc, suspects = obs.incident("rollout_rollback")
            rollback = next((h for h in ctl.snapshot()["history"]
                             if h.get("event") == "rollback"), None)
            return _finish("bad_deploy", {
                "final_state": final,
                "rollback_trigger": (rollback or {}).get("trigger"),
                "ledger": obs.ledger.snapshot()["kinds"],
                "page_scope": (inc or {}).get("detail"),
                "paged": inc is not None,
                "suspects": _thin_suspects(suspects),
            })
        finally:
            gw.drain(timeout=5)
            sup.drain(timeout=10)


# ── scenario: chaos-jammed customize cycle ───────────────────────────


def scenario_jammed_customize(args, workdir: str) -> dict:
    """Healthy customize cycles, then chaos jams the refresh point; the
    cycle-availability SLO burns into a real page whose bundle must
    blame the jam, not the legitimate flips before it."""
    from routest_tpu_torch import chaos

    with _Obs(workdir, "jammed_customize") as obs:
        cust = _customizer()
        tick = _customize_objective(_engine(), cust, obs)
        now = 1000.0
        # Healthy window first: real flips, burn stays zero.
        for _ in range(args.clean_ticks):
            tick(now)
            now += 1.0
        flips_before = cust.flips
        paged_clean = bool(obs.recorder.incidents_snapshot())
        # Jam: every cycle now dies at the chaos point (recorded as
        # chaos.arm + chaos.fire + live.customize_failed).
        chaos.configure(chaos.ChaosEngine(spec=JAM_SPEC, seed=args.seed))
        try:
            ticks_to_page = None
            for i in range(PAGE_TICKS):
                tick(now)
                now += 1.0
                if obs.recorder.incidents_snapshot():
                    ticks_to_page = i + 1
                    break
        finally:
            chaos.configure(None)
        inc, suspects = obs.incident("slo_page")
        return _finish("jammed_customize", {
            "clean_flips": flips_before,
            "clean_paged": paged_clean,
            "ticks_to_page": ticks_to_page,
            "ledger": obs.ledger.snapshot()["kinds"],
            "page_scope": (inc or {}).get("detail"),
            "paged": inc is not None,
            "suspects": _thin_suspects(suspects),
        })


# ── scenario: region kill at the geo-front ───────────────────────────


class _StubRegion:
    """One region as the front's health poll sees it: /up + /api/live."""

    def __init__(self) -> None:
        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"ok": True, "enabled": False}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def scenario_region_kill(args, workdir: str) -> dict:
    """kill_region("east") on a two-region geo-front of the port; a
    reachability SLO pages naming the dead region and region.kill must
    rank first, matched on the region label, above fleet-wide flip
    noise."""
    from routest_tpu_torch.obs.slo import SloObjective
    from routest_tpu_torch.serve.fleet.geofront import GeoFront, RegionHandle

    with _Obs(workdir, "region_kill") as obs:
        east, west = _StubRegion(), _StubRegion()
        front = GeoFront([RegionHandle(DEAD_REGION, east.base,
                                       kill=east.stop),
                          RegionHandle("west", west.base)])
        front.serve("127.0.0.1", 0)
        try:
            polls = {"total": 0, "bad": 0}

            def sample():
                regions = front.snapshot()["regions"]
                polls["total"] += len(regions)
                polls["bad"] += sum(1 for st in regions.values()
                                    if not st["up"])
                return polls["total"], polls["bad"]

            engine = _engine()
            engine.add_objective(SloObjective(
                "reachability:regions", "availability", 0.99, sample,
                detail={"surface": "geofront health"}))

            def page(name, detail):
                down = [n for n, st in
                        front.snapshot()["regions"].items()
                        if not st["up"]]
                obs.recorder.on_slo_page(name, {
                    **detail, "dead_region": ",".join(down) or None})

            engine.on_page.append(page)
            now = 1000.0
            for _ in range(args.clean_ticks):
                engine.tick(now=now)
                now += 1.0
            paged_clean = bool(obs.recorder.incidents_snapshot())
            _flip_noise(5)
            front.kill_region(DEAD_REGION)
            ticks_to_page = None
            for i in range(PAGE_TICKS):
                engine.tick(now=now)
                now += 1.0
                if obs.recorder.incidents_snapshot():
                    ticks_to_page = i + 1
                    break
            inc, suspects = obs.incident("slo_page")
            return _finish("region_kill", {
                "clean_paged": paged_clean,
                "ticks_to_page": ticks_to_page,
                "ledger": obs.ledger.snapshot()["kinds"],
                "page_scope": (inc or {}).get("detail"),
                "paged": inc is not None,
                "suspects": _thin_suspects(suspects),
            })
        finally:
            front.drain(timeout=5)
            west.stop()


# ── scenario: clean window — zero pages, zero false attributions ─────


def _small_artifact(path: str, seed: int) -> None:
    """The JAX script's ``EtaMLP(hidden=(8,), policy=F32_POLICY)`` at
    ``seed``, written in the shipped artifact format (RTPU1)."""
    import torch

    from routest_tpu_torch.core.dtypes import F32_POLICY
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.checkpoint import save_model

    torch.manual_seed(seed)
    save_model(path, EtaMLP(hidden=(8,), policy=F32_POLICY))


def scenario_clean_window(args, workdir: str) -> dict:
    """≥20 legitimate metric flips (real customize cycles) and ≥2
    verified model swaps (a real ``EtaService`` on the card, its
    golden-batch gate scoring through the fused kernel) under a healthy
    ticking SLO engine: the ledger fills, nothing pages, and no incident
    attributes anything."""
    from routest_tpu_torch.core.config import ServeConfig
    from routest_tpu_torch.ops.fused_mlp import fused_eta_forward
    from routest_tpu_torch.serve.ml_service import EtaService

    with _Obs(workdir, "clean_window") as obs:
        # Real verified swaps: each perturbed artifact passes the
        # golden-batch gate and records model.swap from the accept path.
        path = os.path.join(workdir, "clean_model.msgpack")
        original = os.path.join(workdir, "clean_model_0.msgpack")
        _small_artifact(original, args.seed)
        shutil.copy(original, path)
        launches0 = fused_eta_forward.launches
        svc = EtaService(ServeConfig(device=args.device), model_path=path)
        if not svc.available:
            raise RuntimeError(f"EtaService failed to load the model: "
                               f"{svc.load_error}")
        swaps, gate_launches = 0, 0
        try:
            for k in range(1, 3):
                harness.map_artifact(original, path,
                                     lambda x, k=k: x * (1.0 + 1e-4 * k))
                st = os.stat(path)
                os.utime(path, ns=(st.st_atime_ns,
                                   st.st_mtime_ns + 1_000_000 * k))
                before = fused_eta_forward.launches
                if svc.reload_if_changed():
                    swaps += 1
                gate_launches += fused_eta_forward.launches - before
        finally:
            svc.close()
        launches = fused_eta_forward.launches - launches0
        # Real flips under a healthy SLO tick.
        tick = _customize_objective(_engine(), _customizer(), obs)
        now = 1000.0
        for _ in range(max(args.clean_flips, MIN_FLIPS)):
            tick(now)
            now += 1.0
        kinds = obs.ledger.snapshot()["kinds"]
        incidents = obs.recorder.incidents_snapshot()
        return _finish("clean_window", {
            "flips": kinds.get("live.flip", 0),
            "verified_swaps": kinds.get("model.swap", 0),
            "swaps_accepted": swaps,
            "ledger": kinds,
            "incidents": len(incidents),
            "incident_suspects": [len(i.get("suspects") or ())
                                  for i in incidents],
            "kernel": svc.kernel,
            "launches": launches,
            "gate_launches": gate_launches,
        })


SCENARIOS = {
    "bad_deploy": scenario_bad_deploy,
    "jammed_customize": scenario_jammed_customize,
    "region_kill": scenario_region_kill,
    "clean_window": scenario_clean_window,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--scenarios", nargs="*", default=None,
                        choices=sorted(SCENARIOS))
    parser.add_argument("--cpu", action="store_true",
                        help="score the clean window on the CPU "
                             "(a rehearsal); without it the script "
                             "needs a card")
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "incidents_cuda"),
                        help="scratch directory of the scenarios' "
                             "bundles and artifacts")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "incidents_cuda.json; build/"
                             "incidents_cpu.json with --cpu)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_incidents_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "incidents_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "incidents_cpu.json")
    args.clean_ticks, args.clean_flips = phase_sizes(args.quick)
    os.makedirs(args.cache_dir, exist_ok=True)

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="incidents-", dir=args.cache_dir)
    results = {}
    try:
        plan = args.scenarios or list(SCENARIOS)
        for i, name in enumerate(plan):
            print(f"[{i + 1}/{len(plan)}] scenario {name}…", flush=True)
            t = time.perf_counter()
            try:
                results[name] = SCENARIOS[name](args, workdir)
            except Exception as e:
                results[name] = {"error": f"{type(e).__name__}: {e}",
                                 "pass": False}
            results[name]["wall_s"] = round(time.perf_counter() - t, 1)
            r = results[name]
            print(f"  {name}: {'PASS' if r.get('pass') else 'FAIL'} "
                  f"({r['wall_s']}s) {r.get('checks', r.get('error'))}",
                  flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    record = {
        "generated_unix": int(t0),
        "quick": bool(args.quick),
        "card": harness.card_identity(args.device),
        "host": {"cpu_count": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "host_note": HOST_NOTE,
        "config": {"seed": args.seed, "quick": args.quick,
                   "clean_ticks": args.clean_ticks,
                   "clean_flips": args.clean_flips},
        "scenarios": results,
    }
    if args.scenarios:
        record["partial"] = f"--scenarios {' '.join(args.scenarios)}"
    record["checks"] = {k: bool(v.get("pass")) for k, v in results.items()}
    record["launches"] = sum(int(v.get("launches") or 0)
                             for v in results.values())
    record["all_pass"] = bool(results) and all(record["checks"].values())
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print("checks: " + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                                for k, v in record["checks"].items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, launches "
            f"{record['launches']}, {record['wall_s']}s)", flush=True)
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
