"""Dispatch workload end to end on the card → artifacts/dispatch_cuda.json.

The port's counterpart of ``scripts/bench_dispatch.py``, three parts:

- ``batch_scaling`` — dispatch solves/s through the port's batched
  solver on the card (``solve_host_dispatch_batch``, the program behind
  the dispatch batcher) at batch sizes 1→16, each row verified at
  per-problem parity (``solve_host_dispatch`` per problem on the same
  device, exact trip equality). The claim: merged drains beat batch=1
  on solves/s — the whole point of cross-request coalescing.
- ``corridor_jam`` — a live 2-replica fleet of the port on the card
  (supervisor + ``python -m routest_tpu_torch.serve`` workers +
  gateway + broker bus + probe drivers) under open-loop user load; two
  confirmed dispatches, one riding a named corridor and one far from
  it. The corridor jams (``CongestionScenario`` — slower probe
  observations, never a side channel), the live metric flips, and the
  re-optimization loop must re-solve EXACTLY the affected dispatch and
  push ``plan_update`` over its SSE channel within a bounded window,
  user SLO green throughout. The user load sends from a process of its
  own (:func:`cuda_harness.open_loop`, paced as phase 18 paces its
  generator); a scenario whose generator lagged (``send_delay`` p99
  past the load's latency p50) is recorded ``generator_lagged`` and
  fails.
- ``wrong_plan_fault`` — one replica rolls onto seeded
  ``dispatch.solve:skew`` chaos (well-formed 200 plans, solved over a
  silently perturbed cost matrix). Nothing on the serving path can see
  it; the blackbox prober's ``dispatch`` kind (host re-solve of the
  SAME matrix, on the CPU in this process) must page
  ``correctness:dispatch``. In a two-replica fleet it does not: the
  prober's retry of a divergent answer goes through the round-robin
  gateway to the healthy replica (ROADMAP Queue C 16, a fault of the
  reference the port copies), and the record says so.

The synthetic extract and its overlay (``ROUTEST_HIER_CACHE``, the v4
cache file) persist under ``--cache-dir`` (default
``artifacts/bench_cache/dispatch_cuda``) across scenarios and runs.
The record names the torch device, the card and its power limit.
``--cpu`` runs everything on the CPU for a rehearsal; without a card
and without ``--cpu`` the script exits 2 and names the missing device.

Usage: python3 scripts/bench_dispatch_cuda.py [--quick] [--cpu]
       [--out artifacts/dispatch_cuda.json] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as bp  # noqa: E402  (Fleet/extract/load harness)

BATCH_SIZES = [1, 2, 4, 8, 16]
N_STOPS = 12
JAM_SPEED_FACTOR = 0.25        # corridor traffic at quarter speed
JAM_WIDTH_M = 1500.0
PLAN_UPDATE_BOUND_S = 120.0
PAGE_BOUND_S = 90.0
# skew=1.0/80: up to 80% per-leg cost error. /40 is NOT enough — the
# probe problem happens to admit a different-order, equal-cost plan at
# that magnitude (the prober correctly judges on cost, and passes);
# /80 lands the served plan measurably worse under the true matrix.
DISPATCH_SKEW_SPEC = "dispatch.solve:skew=1.0/80"
DISPATCH_PROBE_TOL = 0.005


# ── part 1: batch scaling at oracle parity ───────────────────────────


def _problem(rng, n=N_STOPS, windows=False):
    pts = np.round(rng.random((n + 1, 2)) * 60.0, 3)
    dist = np.round(np.sqrt(
        ((pts[:, None] - pts[None]) ** 2).sum(-1)), 3).astype(np.float32)
    demands = rng.integers(1, 4, n).astype(np.float32)
    tw_open = tw_close = None
    if windows:
        tw_open = np.zeros(n, np.float32)
        tw_close = np.full(n, 1e4, np.float32)
    return dict(dist=dist, demands=demands, capacity=7.0,
                max_distance=500.0, tw_open=tw_open, tw_close=tw_close)


def _same_plan(a: dict, b: dict) -> bool:
    return (a["trips"] == b["trips"]
            and a["spill_lane"] == b["spill_lane"]
            and a["unroutable"] == b["unroutable"])


def batch_scaling(quick: bool, device: str) -> dict:
    from routest_tpu_torch.optimize.vrp import (solve_host_dispatch,
                                                solve_host_dispatch_batch)

    target_s = 1.5 if quick else 4.0
    rows = []
    for bsz in BATCH_SIZES:
        rng = np.random.default_rng(2026_00 + bsz)
        probs = [_problem(rng, windows=(i % 4 == 3)) for i in range(bsz)]
        args = (
            [p["dist"] for p in probs],
            [p["demands"] for p in probs],
            [p["capacity"] for p in probs],
            [p["max_distance"] for p in probs],
        )
        kw = dict(tw_opens=[p["tw_open"] for p in probs],
                  tw_closes=[p["tw_close"] for p in probs], device=device)
        # Oracle first: each problem solved alone.
        oracles = [solve_host_dispatch(
            p["dist"], p["demands"], p["capacity"], p["max_distance"],
            tw_open=p["tw_open"], tw_close=p["tw_close"], device=device)
            for p in probs]
        # Warm the (batch, stops) bucket, then estimate reps for the
        # timing window.
        t0 = time.perf_counter()
        results = solve_host_dispatch_batch(*args, **kw)
        warm_s = time.perf_counter() - t0
        parity = all(_same_plan(r, o) for r, o in zip(results, oracles))
        t0 = time.perf_counter()
        est = None
        for _ in range(3):
            solve_host_dispatch_batch(*args, **kw)
        est = (time.perf_counter() - t0) / 3
        reps = max(4, int(round(target_s / max(est, 1e-4))))
        t0 = time.perf_counter()
        for _ in range(reps):
            solve_host_dispatch_batch(*args, **kw)
        elapsed = time.perf_counter() - t0
        rows.append({
            "batch": bsz, "stops": N_STOPS, "reps": reps,
            "solves_per_s": round(bsz * reps / elapsed, 2),
            "ms_per_drain": round(elapsed / reps * 1000, 3),
            "ms_per_solve": round(elapsed / (reps * bsz) * 1000, 3),
            "warm_s": round(warm_s, 3),
            "oracle_parity": bool(parity),
        })
        print(f"  batch={bsz:>2}: {rows[-1]['solves_per_s']:>9} "
              f"solves/s  parity={parity}", flush=True)
    checks = {
        "rows_ge_3": len(rows) >= 3,
        "all_rows_oracle_parity": all(r["oracle_parity"] for r in rows),
        "throughput_scales_with_batch":
            rows[-1]["solves_per_s"] > rows[0]["solves_per_s"],
    }
    return {"rows": rows, "checks": checks,
            "pass": all(checks.values())}


# ── SSE tap: collect plan_update events off a replica's feed ─────────


class SseTap:
    """One ``/api/realtime_feed`` subscription that PARSES events (the
    loadgen ``SseClients`` only counts them): every ``data:`` payload
    is kept, and :meth:`plan_updates` filters the re-opt pushes."""

    def __init__(self, base: str, channel: str) -> None:
        parts = urllib.parse.urlsplit(base)
        self._host, self._port = parts.hostname, parts.port
        self._path = f"/api/realtime_feed?channel={channel}"
        self.channel = channel
        self.events: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=30.0)
        try:
            conn.request("GET", self._path)
            resp = conn.getresponse()
            if resp.status != 200:
                return
            sock = conn.sock or getattr(
                getattr(resp.fp, "raw", None), "_sock", None)
            if sock is not None:
                sock.settimeout(None)
            self._sock = sock
            buf = b""
            while not self._stop.is_set():
                chunk = resp.read1(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.startswith(b"data:"):
                        continue
                    try:
                        ev = json.loads(line[5:].strip())
                    except ValueError:
                        continue
                    with self._lock:
                        self.events.append(ev)
        except (http.client.HTTPException, OSError):
            pass
        finally:
            conn.close()

    def plan_updates(self) -> list:
        with self._lock:
            return [e for e in self.events
                    if isinstance(e, dict)
                    and e.get("event") == "plan_update"]

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                import socket as _socket

                self._sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=5.0)


class CorridorSweep:
    """Deterministic corridor coverage: one synthetic driver per tick
    observing EVERY corridor edge at its scenario-priced speed. The
    random-walk ambiance fleet makes the metric live everywhere; the
    sweep guarantees the jam is *seen* promptly on the edges that
    matter (a real jam is observed by the drivers stuck in it)."""

    def __init__(self, publish, corridor, length_m, road_class,
                 scenario, tick_s: float = 1.0) -> None:
        from routest_tpu_torch.live.probes import DEFAULT_CHANNEL

        self._publish = publish
        self._channel = DEFAULT_CHANNEL
        self._edges = np.asarray(corridor, np.int64)
        self._length = np.asarray(length_m, np.float64)[self._edges]
        self._rc = np.asarray(road_class, np.int64)[self._edges]
        self._scenario = scenario
        self._tick_s = tick_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from routest_tpu_torch.data.road_graph import true_edge_time_s

        while not self._stop.wait(self._tick_s):
            now = time.time()
            hour = time.localtime(now).tm_hour
            t = true_edge_time_s(
                self._length, self._rc,
                np.full(len(self._edges), hour, np.int64))
            if self._scenario.active(now):
                t = t / self._scenario.speed_factor
            speeds = self._length / np.maximum(t, 1e-6)
            for lo in range(0, len(self._edges), 48):
                obs = [[int(e), round(float(s), 4)]
                       for e, s in zip(self._edges[lo:lo + 48],
                                       speeds[lo:lo + 48])]
                try:
                    self._publish(self._channel, {
                        "t": now, "hour": hour,
                        "driver": f"sweep{lo}", "obs": obs})
                except Exception:
                    return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


# ── part 2: corridor jam → re-dispatch exactly the affected ──────────


def _seg_dist_m(sites, a, b) -> np.ndarray:
    """Distance (m) from each (lat, lon) site to segment a→b."""
    coords = np.asarray(sites, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lat0 = np.radians((a[0] + b[0]) / 2.0)
    scale = np.asarray([111_194.9, 111_194.9 * np.cos(lat0)])
    p = (coords - a) * scale
    seg = (b - a) * scale
    seg_len2 = float(seg @ seg)
    t = np.clip((p @ seg) / max(seg_len2, 1e-9), 0.0, 1.0)
    return np.sqrt(((p - t[:, None] * seg[None, :]) ** 2).sum(axis=1))


def _dispatch_body(depot, stops, driver: str) -> dict:
    return {
        "source_point": {"lat": float(depot[0]), "lon": float(depot[1])},
        "destination_points": [
            {"lat": float(la), "lon": float(lo), "payload": 1}
            for la, lo in stops],
        "driver_details": {"driver_name": driver, "vehicle_type": "car",
                           "vehicle_capacity": 9,
                           "maximum_distance": 500_000},
        "confirm": True,
        "sim_seed": 3,
    }


def scenario_corridor_jam(extract, cache_dir, rate, quick, device) -> dict:
    from routest_tpu_torch.data.locations import SEED_LOCATIONS
    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.live.probes import (CongestionScenario,
                                               ProbeFleet, corridor_edges)
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.serve.netbus import NetBus

    work = tempfile.mkdtemp(prefix="dispatch-jam-")
    out: dict = {"scenario": "corridor_jam"}
    fleet = bp.Fleet(live=True, extract=extract, cache_dir=cache_dir,
                     work_dir=work, device=device)
    load_stop = threading.Event()
    load_records: list = []
    taps, sweep, probe_fleet = [], None, None
    try:
        # Open-loop user load through the gateway for the run's length
        # — the jam is a dispatch-plane incident; the user SLO must not
        # notice it.
        def _load():
            while not load_stop.is_set():
                try:
                    load_records.extend(bp.open_loop(
                        fleet.base, rate, 10.0, stop=load_stop))
                except Exception:
                    pass

        load_thread = threading.Thread(target=_load, daemon=True)
        t_load = time.monotonic()
        load_thread.start()

        # Corridor geometry: the jam rides a→b; the calm dispatch sits
        # around the seed site FARTHEST from that segment.
        # geometry only: this process's router stays on the CPU
        router = RoadRouter(graph=load_osm(extract), use_gnn=False,
                            use_transformer=False, device="cpu")
        g = router.graph_dict()
        a = (SEED_LOCATIONS[2][1], SEED_LOCATIONS[2][2])
        b = (SEED_LOCATIONS[11][1], SEED_LOCATIONS[11][2])
        sites = [(s[1], s[2]) for s in SEED_LOCATIONS]
        far = _seg_dist_m(sites, a, b)
        c = sites[int(np.argmax(far))]
        corridor = corridor_edges(g["node_coords"], g["senders"],
                                  g["receivers"], a, b,
                                  width_m=JAM_WIDTH_M)
        out["corridor"] = {"a": list(a), "b": list(b),
                           "edges": int(len(corridor)),
                           "width_m": JAM_WIDTH_M,
                           "calm_site": list(c),
                           "calm_dist_to_corridor_m":
                               round(float(far.max()), 1)}
        scenario = CongestionScenario(corridor,
                                      speed_factor=JAM_SPEED_FACTOR)
        scenario.set_active(False)

        # Ambiance fleet (random walk, scenario-priced) + the corridor
        # sweep, both over the broker bus the workers ingest from.
        bus_fleet = NetBus(f"tcp://127.0.0.1:{fleet.broker.port}")
        bus_sweep = NetBus(f"tcp://127.0.0.1:{fleet.broker.port}")
        probe_fleet = ProbeFleet(g, fleet._driver_count,
                                 bus_fleet.publish, seed=42,
                                 obs_per_tick=6, scenario=scenario)
        probe_fleet.start(tick_s=1.0)
        sweep = CorridorSweep(bus_sweep.publish, corridor,
                              g["length_m"], g["road_class"], scenario)
        time.sleep(12.0 if quick else 20.0)   # estimates settle

        # Two confirmed dispatches on replica 0 (the registry is
        # per-replica; SSE taps subscribe to the owner directly, while
        # user load keeps flowing through the gateway).
        replica = f"http://127.0.0.1:{fleet.ports[0]}"
        t_ab = np.linspace(0.18, 0.82, 4)
        jam_stops = [(a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1]))
                     for t in t_ab]
        calm_stops = [(c[0] + 0.004 * (k + 1), c[1] + 0.003 * (k % 2))
                      for k in range(4)]
        taps = [SseTap(replica, "dina-jam"), SseTap(replica, "dina-calm")]
        metrics0 = fleet.metrics()
        jam_resp = bp.post(f"{replica}/api/dispatch",
                            _dispatch_body(a, jam_stops, "dina-jam"),
                            timeout=300.0)
        calm_resp = bp.post(f"{replica}/api/dispatch",
                             _dispatch_body(c, calm_stops, "dina-calm"),
                             timeout=300.0)
        jam_id = jam_resp["dispatch_id"]
        calm_id = calm_resp["dispatch_id"]
        out["dispatches"] = {
            "jam": {"id": jam_id, "cost_s": jam_resp["cost"],
                    "epoch": jam_resp["epoch"]},
            "calm": {"id": calm_id, "cost_s": calm_resp["cost"],
                     "epoch": calm_resp["epoch"]}}

        # Clean window: metric keeps flipping from ambient noise; no
        # plan may churn (re-opt's "exactly the degraded" contract).
        time.sleep(10.0)
        pre_jam = [e["dispatch_id"] for t in taps
                   for e in t.plan_updates()]
        out["clean_window_updates"] = pre_jam

        # Jam. Detection = jammed observations → EWMA → customize flip
        # → re-opt tick → batched re-solve → plan_update over SSE.
        t_jam = time.monotonic()
        scenario.set_active(True)
        detect_s = None
        while time.monotonic() - t_jam < PLAN_UPDATE_BOUND_S:
            if any(e["dispatch_id"] == jam_id
                   for e in taps[0].plan_updates()):
                detect_s = round(time.monotonic() - t_jam, 1)
                break
            time.sleep(0.5)
        time.sleep(8.0)   # grace: catch any spurious calm re-solve
        jam_updates = [e for e in taps[0].plan_updates()
                       if e["dispatch_id"] == jam_id]
        stray = ([e["dispatch_id"] for e in taps[1].plan_updates()]
                 + [e["dispatch_id"] for e in taps[0].plan_updates()
                    if e["dispatch_id"] != jam_id])
        out["page"] = {"detect_s": detect_s,
                       "bound_s": PLAN_UPDATE_BOUND_S}
        out["plan_updates"] = {"jam": len(jam_updates), "stray": stray}
        if jam_updates:
            out["first_update_reason"] = jam_updates[0].get("reason")

        # Owner-replica dispatch surface + gateway user SLO.
        out["dispatch_state"] = {
            k: v for k, v in bp.fetch(f"{replica}/api/dispatch",
                                      timeout=30).items()
            if k in ("epoch", "batcher", "reopt")}
        out["fused_launches"] = bp.launch_delta(metrics0, fleet.metrics())
        gw_slo = fleet.gw.slo
        if gw_slo is not None:
            gw_slo.tick()
            out["user_slo_state"] = gw_slo.worst_state()
        out["user_load"] = _stop_load(load_stop, load_thread, load_records,
                                      t_load)
        checks = {
            "clean_before_jam": not pre_jam,
            "plan_update_within_bound": detect_s is not None,
            "exactly_the_affected": bool(jam_updates) and not stray,
            "user_slo_ok": out.get("user_slo_state", "ok") == "ok",
        }
        out["checks"] = checks
        out["generator_lagged"] = out["user_load"]["generator_lagged"]
        out["pass"] = bp.passed(all(checks.values()), out["user_load"])
    finally:
        load_stop.set()
        for t in taps:
            t.stop()
        if sweep is not None:
            sweep.stop()
        if probe_fleet is not None:
            probe_fleet.stop()
        try:
            load_thread.join(timeout=20)
        except (NameError, RuntimeError):
            pass
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    return out


def _stop_load(load_stop, load_thread, records, t_load) -> dict:
    """Stop the background user load and read its pace: the open-loop
    summary's figures with the harness's verdict (``generator_lagged``
    past :data:`cuda_harness.PACE_LIMIT`)."""
    from routest_tpu_torch.loadgen import summarize

    load_stop.set()
    load_thread.join(timeout=20)
    rep = summarize(records, time.monotonic() - t_load, len(records))
    return dict(bp.pace_check(rep), sent=rep["sent"], ok=rep["ok"],
                errors=rep["errors"],
                latency_p99_ms=(rep.get("latency") or {}).get("p99_ms"))


# ── part 3: wrong-plan fault → dispatch probe pages ──────────────────


def wait_for_dispatch_page(prober, bound_s: float) -> dict:
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound_s:
        obj = prober.slo.snapshot()["objectives"].get(
            "correctness:dispatch")
        if obj and obj["state"] == "page":
            return {"paged": True,
                    "detect_s": round(time.monotonic() - t0, 2)}
        time.sleep(0.2)
    return {"paged": False, "detect_s": None}


def scenario_wrong_plan_fault(extract, cache_dir, rate, quick,
                              device) -> dict:
    import dataclasses

    work = tempfile.mkdtemp(prefix="dispatch-fault-")
    out: dict = {"scenario": "wrong_plan_fault"}
    fleet = bp.Fleet(live=False, extract=extract, cache_dir=cache_dir,
                     work_dir=work, device=device)
    load_stop = threading.Event()
    load_records: list = []
    try:
        # The dispatch probe judges plan cost under the TRUE matrix;
        # the /80 skew's divergence is ~2.4%, so pin the tolerance
        # well under it (and far above f32 noise).
        fleet.prober_cfg = dataclasses.replace(
            fleet.prober_cfg, route_tolerance_rel=DISPATCH_PROBE_TOL)
        prober = fleet.arm_prober()

        def _load():
            while not load_stop.is_set():
                try:
                    load_records.extend(bp.open_loop(
                        fleet.base, rate, 10.0, stop=load_stop))
                except Exception:
                    pass

        load_thread = threading.Thread(target=_load, daemon=True)
        t_load = time.monotonic()
        load_thread.start()
        deadline = time.time() + (30 if quick else 60)
        while time.time() < deadline:
            snap = prober.snapshot()["probes"]
            if snap.get("dispatch", {}).get("verdict") == "pass":
                break
            time.sleep(1.0)
        out["baseline_verdicts"] = {
            k: v.get("verdict")
            for k, v in prober.snapshot()["probes"].items()}

        victim = fleet.replica_rids()[0]
        faulty_rid = fleet.inject_replacement(
            victim, {"RTPU_CHAOS_SPEC": DISPATCH_SKEW_SPEC,
                     "RTPU_CHAOS_SEED": "5"},
            version="v-wrong-plan")
        out.update({"victim": victim, "faulty_rid": faulty_rid,
                    "chaos_spec": DISPATCH_SKEW_SPEC})
        page = wait_for_dispatch_page(prober, PAGE_BOUND_S)
        out["page"] = dict(page, bound_s=PAGE_BOUND_S)
        out["dispatch_probe"] = prober.snapshot()["probes"].get(
            "dispatch")
        bundles = bp.correctness_bundles(fleet.recorder_dir)
        out["bundle"] = bp.judge_fault_bundle(bundles, faulty_rid)
        gw_slo = fleet.gw.slo
        if gw_slo is not None:
            gw_slo.tick()
            out["user_slo_state"] = gw_slo.worst_state()
        out["user_load"] = _stop_load(load_stop, load_thread, load_records,
                                      t_load)
        checks = {
            "baseline_dispatch_pass":
                out["baseline_verdicts"].get("dispatch") == "pass",
            "dispatch_probe_paged": bool(page["paged"]),
            "user_slo_ok": out.get("user_slo_state", "ok") == "ok",
        }
        out["checks"] = checks
        out["generator_lagged"] = out["user_load"]["generator_lagged"]
        out["pass"] = bp.passed(all(checks.values()), out["user_load"])
    finally:
        load_stop.set()
        try:
            load_thread.join(timeout=20)
        except (NameError, RuntimeError):
            pass
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    return out


# ── record ───────────────────────────────────────────────────────────


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="smaller extract + shorter phases (CI)")
    parser.add_argument("--cpu", action="store_true",
                        help="solve and serve on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the script "
                             "needs a card")
    parser.add_argument("--nodes", type=int, default=6000)
    parser.add_argument("--rate", type=float, default=2.0)
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "artifacts", "bench_cache", "dispatch_cuda"))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "dispatch_cuda.json; build/dispatch_cpu.json "
                             "with --cpu)")
    parser.add_argument("--scenario", default=None,
                        choices=("batch_scaling", "corridor_jam",
                                 "wrong_plan_fault"),
                        help="run one part (debug)")
    args = parser.parse_args()
    device = bp.require_card(args.cpu, "bench_dispatch_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "dispatch_cuda.json") \
            if device == "cuda" \
            else os.path.join(REPO, "build", "dispatch_cpu.json")
    if args.quick:
        args.nodes = min(args.nodes, 4000)

    os.makedirs(args.cache_dir, exist_ok=True)
    # the replicas (and this process) load the overlay from here
    os.environ["ROUTEST_HIER_CACHE"] = os.path.join(args.cache_dir,
                                                    "hier")

    t0 = time.time()
    record: dict = {}
    checks: dict = {}

    if args.scenario in (None, "batch_scaling"):
        print(f"[1/4] batch scaling at per-problem parity on {device}…",
              flush=True)
        t = time.perf_counter()
        try:
            record["batch_scaling"] = batch_scaling(args.quick, device)
        except Exception as e:
            record["batch_scaling"] = {
                "pass": False, "rows": [],
                "error": f"{type(e).__name__}: {e}"}
        record["batch_scaling"]["wall_s"] = round(
            time.perf_counter() - t, 1)
        checks["batch_scaling"] = bool(record["batch_scaling"]["pass"])

    scenarios: dict = {}
    if args.scenario in (None, "corridor_jam", "wrong_plan_fault"):
        print(f"[2/4] extract + overlay cache ({args.nodes:,} nodes)…",
              flush=True)
        extract = bp.build_extract(args.nodes, args.cache_dir)
        plan = [
            ("corridor_jam", lambda: scenario_corridor_jam(
                extract, args.cache_dir, args.rate, args.quick, device)),
            ("wrong_plan_fault", lambda: scenario_wrong_plan_fault(
                extract, args.cache_dir, args.rate, args.quick, device)),
        ]
        for i, (name, run) in enumerate(plan):
            if args.scenario and name != args.scenario:
                continue
            print(f"[{i + 3}/4] scenario {name}…", flush=True)
            t = time.perf_counter()
            try:
                scenarios[name] = run()
            except Exception as e:
                scenarios[name] = {"scenario": name, "pass": False,
                                   "error": f"{type(e).__name__}: {e}"}
            scenarios[name]["wall_s"] = round(time.perf_counter() - t, 1)
            checks[name] = bool(scenarios[name].get("pass"))
            pace = scenarios[name].get("user_load") or {}
            print(f"  {name}: "
                  f"{'PASS' if checks[name] else 'FAIL'} "
                  f"({scenarios[name]['wall_s']}s; send_delay p99 "
                  f"{pace.get('send_delay_p99_ms')} ms, limit "
                  f"{pace.get('pace_limit_ms')} ms, lagged "
                  f"{pace.get('generator_lagged')})", flush=True)
    record["scenarios"] = scenarios

    record.update({
        "generated_unix": int(t0),
        "card": bp.card_identity(device),
        "host": {"cpus": bp._cores(), "platform": sys.platform},
        "config": {
            "nodes": args.nodes, "rate_rps": args.rate,
            "batch_sizes": BATCH_SIZES, "stops": N_STOPS,
            "jam_speed_factor": JAM_SPEED_FACTOR,
            "jam_width_m": JAM_WIDTH_M,
            "plan_update_bound_s": PLAN_UPDATE_BOUND_S,
            "page_bound_s": PAGE_BOUND_S,
            "dispatch_skew_spec": DISPATCH_SKEW_SPEC,
            "dispatch_probe_tolerance": DISPATCH_PROBE_TOL,
            "cache_dir": os.path.relpath(args.cache_dir, REPO),
            "quick": bool(args.quick),
        },
        "checks": checks,
    })
    if args.scenario:
        record["partial"] = f"--scenario {args.scenario} (debug run)"
    record["all_pass"] = (bool(checks) and all(checks.values())
                          and (args.scenario is not None
                               or len(checks) == 3))
    record["wall_s"] = round(time.time() - t0, 1)
    bp.write_record(args.out, record)
    print(f"\n[4/4] checks: "
          + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                     for k, v in checks.items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, "
            f"{record['wall_s']}s)", flush=True)
    # _exit, not sys.exit: sim/probe daemon threads racing interpreter
    # teardown must not turn a written verdict into a crash.
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
