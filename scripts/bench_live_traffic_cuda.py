"""Live traffic on the card, end to end → artifacts/live_traffic_cuda.json.

The port's counterpart of ``scripts/bench_live_traffic.py``: a real
fleet of the port (supervisor + one ``python -m routest_tpu_torch.serve``
replica on the card with ``RTPU_LIVE=1`` + in-process gateway + the
port's TCP broker) serves a generated street extract
(:func:`cuda_harness.build_extract`) under the open-loop mixed load
generator — sent from processes of its own
(:func:`cuda_harness.run_open_loop_process`) — while a seeded probe
fleet streams per-edge speed observations. A third of the way in the
script jams a corridor; the run passes, by the JAX script's checks
(:func:`live_checks`), iff

- the served ETA and route for an OD pair across the corridor shift,
  within the staleness bound (two estimator half-lives + two customize
  intervals + 15 s, :func:`staleness_bound`);
- the post-flip served duration matches a scipy Dijkstra oracle on the
  replica's own exported metric (``/api/live?metric=1``, rel 2e-3);
- no client 5xx and both tiers' SLO engines stay green across ≥ 3
  metric flips and ≥ 3 verified road-GNN swaps — the port's
  ``ContinuousTrainer`` runs in this process on the card and lands its
  artifacts through the router's verified swap;
- customizing the overlay beats its full build,

and the generator kept its pace (``send_delay`` p99 ≤ latency p50 of
the run, :func:`cuda_harness.pace_check`): a lagged run never passes.

The record holds the JAX record's keys and checks, the device the
trainer ran on, the fused launches the replica made, the card's name
and power limit. ``--cpu`` serves the replica (and trains) on the CPU
for a rehearsal; without a card and without ``--cpu`` the script exits
2.

Usage: python3 scripts/bench_live_traffic_cuda.py [--nodes 20000]
       [--duration 180] [--drivers 160] [--quick] [--cpu]
       [--out artifacts/live_traffic_cuda.json] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

MODEL = harness.MODEL

# The JAX script's scenario (bench_live_traffic.py:166-200, 287-290):
# a corridor between two seed sites, narrow enough that parallel streets
# offer detours, jammed to a quarter of its speed; the mixed workload.
CORRIDOR_SITES = (2, 11)
CORRIDOR_WIDTH_M = 220.0
JAM_SPEED_FACTOR = 0.25
CHANNEL = "rtpu.probes"
MIX = {"request_route": 0.25, "predict_eta": 0.45, "history": 0.1,
       "update_tracker": 0.1, "probe": 0.1}
# Detection = two consecutive samples at ≥ 1.10× the baseline median.
SHIFT_THRESHOLD = 1.10
ORACLE_REL = 2e-3
# The JAX script's --quick caps.
QUICK = {"nodes": 10_000, "duration": 100.0, "drivers": 96,
         "customize_s": 6.0}


def staleness_bound(half_life_s: float, customize_s: float) -> float:
    """The JAX script's default bound on probe injection → served
    effect: two estimator half-lives (EWMA convergence) + two customize
    intervals (one may be mid-flight at injection) + a 15 s ingest and
    sampler margin."""
    return 2 * half_life_s + 2 * customize_s + 15.0


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else float("nan")


def analyze(samples, t_inject: float) -> dict:
    """The JAX script's staleness and shift analysis of the probe OD's
    served timeline."""
    good = [s for s in samples if "duration_s" in s]
    pre = [s for s in good if s["t"] < t_inject]
    post = [s for s in good if s["t"] >= t_inject]
    base_dur = _median([s["duration_s"] for s in pre])
    base_dist = _median([s["distance_m"] for s in pre])
    base_overlap = _median([s["overlap"] for s in pre])
    detect_t = None
    for i in range(len(post) - 1):
        if (post[i]["duration_s"] >= base_dur * SHIFT_THRESHOLD
                and post[i + 1]["duration_s"] >= base_dur * SHIFT_THRESHOLD):
            detect_t = post[i]["t"]
            break
    staleness_s = (detect_t - t_inject) if detect_t is not None else None
    tail = [s for s in post if detect_t is not None and s["t"] >= detect_t]
    tail_dur = _median([s["duration_s"] for s in tail])
    tail_dist = _median([s["distance_m"] for s in tail])
    tail_overlap = _median([s["overlap"] for s in tail])
    eta_shift = (tail_dur / base_dur - 1.0) if base_dur else 0.0
    dist_changed = (abs(tail_dist - base_dist) / base_dist > 0.002
                    if base_dist and not math.isnan(tail_dist) else False)
    overlap_dropped = (not math.isnan(tail_overlap)
                       and not math.isnan(base_overlap)
                       and tail_overlap <= base_overlap - 0.05)
    return {"samples": len(good), "base_dur": base_dur,
            "base_dist": base_dist, "base_overlap": base_overlap,
            "tail_dur": tail_dur, "tail_dist": tail_dist,
            "tail_overlap": tail_overlap, "eta_shift": eta_shift,
            "staleness_s": staleness_s,
            "route_shift": bool(dist_changed or overlap_dropped)}


def live_checks(*, eta_shift, route_shift, staleness_s, bound_s,
                oracle_pass, client_5xx, slo_green, flips, swaps_accepted,
                customize_s, full_build_s) -> dict:
    """The JAX script's nine checks."""
    return {
        "eta_shifted": eta_shift >= 0.10,
        "route_shifted": bool(route_shift),
        "staleness_within_bound": (staleness_s is not None
                                   and staleness_s <= bound_s),
        "oracle_parity": bool(oracle_pass),
        "zero_client_5xx": client_5xx == 0,
        "slo_green_both_tiers": bool(slo_green),
        "metric_flips_ge_3": flips >= 3,
        "verified_swaps_ge_3": swaps_accepted >= 3,
        "customize_beats_full_build": (customize_s is not None
                                       and full_build_s is not None
                                       and customize_s < full_build_s),
    }


def slo_spec(slo_ms: float) -> str:
    return (f"/api/request_route:latency_ms={slo_ms:.0f},"
            f"latency_target=0.9,availability=0.99;"
            f"/api/predict_eta:latency_ms=2500,latency_target=0.9,"
            f"availability=0.99")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nodes", type=int, default=20_000)
    parser.add_argument("--duration", type=float, default=180.0)
    parser.add_argument("--drivers", type=int, default=160)
    parser.add_argument("--rps", type=float, default=1.5)
    parser.add_argument("--customize-s", type=float, default=8.0)
    parser.add_argument("--half-life-s", type=float, default=15.0)
    parser.add_argument("--staleness-bound", type=float, default=None,
                        help="max allowed probe-injection → served-effect "
                             "latency (default: staleness_bound())")
    parser.add_argument("--retrain-steps", type=int, default=10)
    parser.add_argument("--obs-per-tick", type=int, default=6)
    parser.add_argument("--slo-ms", type=float, default=8000.0)
    parser.add_argument("--quick", action="store_true",
                        help="10k extract, 100 s, 96 drivers, customize "
                             "6 s (the JAX script's preset; an explicit "
                             "smaller --duration still applies)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--cpu", action="store_true",
                        help="serve the replica and train on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "live_traffic_cuda"))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "live_traffic_cuda.json; build/"
                             "live_traffic_cpu.json with --cpu)")
    return parser


def apply_quick(args) -> None:
    """The JAX script's ``--quick`` caps, then the staleness bound."""
    if args.quick:
        args.nodes = min(args.nodes, QUICK["nodes"])
        args.duration = min(args.duration, QUICK["duration"])
        args.drivers = min(args.drivers, QUICK["drivers"])
        args.customize_s = min(args.customize_s, QUICK["customize_s"])
    if args.staleness_bound is None:
        args.staleness_bound = staleness_bound(args.half_life_s,
                                               args.customize_s)


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_live_traffic_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts",
                                "live_traffic_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "live_traffic_cpu.json")
    apply_quick(args)

    import numpy as np

    from routest_tpu_torch.core.config import FleetConfig
    from routest_tpu_torch.data.locations import SEED_LOCATIONS
    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.live.ingest import ProbeIngester
    from routest_tpu_torch.live.probes import (CongestionScenario,
                                               ProbeFleet, corridor_edges)
    from routest_tpu_torch.live.state import CongestionState
    from routest_tpu_torch.live.trainer import ContinuousTrainer
    from routest_tpu_torch.loadgen import (MixedWorkload, RateCurve,
                                           SseClients, poisson_schedule,
                                           summarize)
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
    from routest_tpu_torch.serve.netbus import NetBus, start_broker

    t_run = time.time()
    os.makedirs(args.cache_dir, exist_ok=True)
    work_dir = tempfile.mkdtemp(prefix="live-traffic-")
    hier_cache = os.path.join(args.cache_dir, "hier")
    gnn_path = os.path.join(work_dir, "road_gnn_live.msgpack")
    os.environ["ROUTEST_HIER_CACHE"] = hier_cache
    os.environ["RTPU_RECORDER_DIR"] = os.path.join(work_dir, "postmortems")
    spec = slo_spec(args.slo_ms)
    # the in-process gateway's engine reads it too
    os.environ["RTPU_SLO_OBJECTIVES"] = spec

    print(f"[1/6] {args.nodes:,}-node extract + overlay cache…", flush=True)
    t0 = time.perf_counter()
    extract = harness.build_extract(args.nodes, args.cache_dir)
    oracle_router = RoadRouter(graph=load_osm(extract), use_gnn=False,
                               use_transformer=False, device="cpu")
    extract_s = time.perf_counter() - t0
    n_edges = len(oracle_router.senders)
    a = (SEED_LOCATIONS[CORRIDOR_SITES[0]][1],
         SEED_LOCATIONS[CORRIDOR_SITES[0]][2])
    b = (SEED_LOCATIONS[CORRIDOR_SITES[1]][1],
         SEED_LOCATIONS[CORRIDOR_SITES[1]][2])
    corridor = corridor_edges(oracle_router.coords, oracle_router.senders,
                              oracle_router.receivers, a, b,
                              width_m=CORRIDOR_WIDTH_M)
    print(f"  {oracle_router.n_nodes:,} nodes, {n_edges:,} edges, corridor "
          f"{len(corridor)} edges ({extract_s:.1f} s)", flush=True)

    def corridor_overlap(coords_lonlat) -> float:
        """Share of a served polyline's vertices inside the corridor
        band (drops when routes detour)."""
        pts = np.asarray(coords_lonlat, np.float64)
        if len(pts) == 0:
            return 0.0
        latlon = pts[:, ::-1]
        lat0 = math.radians((a[0] + b[0]) / 2.0)
        scale = np.asarray([111_194.9, 111_194.9 * math.cos(lat0)])
        p = (latlon - np.asarray(a)) * scale
        seg = (np.asarray(b) - np.asarray(a)) * scale
        t = np.clip((p @ seg) / float(seg @ seg), 0.0, 1.0)
        d = np.sqrt(((p - t[:, None] * seg[None, :]) ** 2).sum(axis=1))
        return float((d <= CORRIDOR_WIDTH_M).mean())

    print(f"[2/6] broker + fleet (1 replica on {args.device} + gateway)…",
          flush=True)
    broker, _bt = start_broker()
    bus_url = f"tcp://127.0.0.1:{broker.port}"
    env = harness.server_env(
        args.device, ROAD_GRAPH_OSM=extract, ROUTEST_HIER_CACHE=hier_cache,
        ROUTEST_MESH="0", ROUTEST_WARM_BUCKETS="0", ETA_MODEL_PATH=MODEL,
        ROAD_GNN_PATH=gnn_path, REDIS_URL=bus_url,
        RTPU_SLO_OBJECTIVES=spec, RTPU_LIVE="1", RTPU_LIVE_CHANNEL=CHANNEL,
        RTPU_LIVE_CUSTOMIZE_S=str(args.customize_s),
        RTPU_LIVE_HALF_LIFE_S=str(args.half_life_s),
        RTPU_LIVE_MIN_OBS_EDGES="50")
    ports = [harness.free_port()]
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0)
    sup.start()
    gw = httpd = None
    fleet = ingester = trainer = sse = None
    retrain_thread = None
    swap_stop = threading.Event()
    sample_stop = threading.Event()
    samples: list = []
    boot_s = None
    try:
        t0 = time.perf_counter()
        if not sup.ready(timeout=600):
            raise RuntimeError("fleet worker never became ready")
        boot_s = time.perf_counter() - t0
        replica_base = f"http://127.0.0.1:{ports[0]}"
        gw = Gateway([("127.0.0.1", p) for p in ports],
                     FleetConfig(hedge=False, max_inflight=32,
                                 queue_depth=64), supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        print("[3/6] warming the replica, arming probes and the trainer…",
              flush=True)
        od_body = {
            "source_point": {"lat": a[0], "lon": a[1]},
            "destination_points": [{"lat": b[0], "lon": b[1],
                                    "payload": 1}],
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 100,
                               "maximum_distance": 900_000},
            "road_graph": True,
        }
        t0 = time.perf_counter()
        harness.post(f"{base}/api/request_route", od_body, timeout=600)
        warm_s = time.perf_counter() - t0
        deadline = time.time() + 300
        while time.time() < deadline:
            if harness.fetch(f"{replica_base}/api/live").get("ready"):
                break
            time.sleep(0.5)
        else:
            raise RuntimeError("replica live service never armed")
        metrics0 = harness.fetch(f"{replica_base}/api/metrics")

        scenario = CongestionScenario(corridor,
                                      speed_factor=JAM_SPEED_FACTOR)
        probe_bus = NetBus(bus_url)
        fleet = ProbeFleet(oracle_router.graph_dict(), args.drivers,
                           probe_bus.publish, seed=args.seed,
                           channel=CHANNEL, obs_per_tick=args.obs_per_tick,
                           scenario=scenario)
        fleet.start(tick_s=1.0)
        # This process's estimator feeding the continuous trainer (its
        # own subscription on the stream the replica folds).
        train_bus = NetBus(bus_url)
        state = CongestionState(oracle_router.freeflow_time_s,
                                half_life_s=args.half_life_s,
                                stale_s=600.0)
        ingester = ProbeIngester(train_bus, state, oracle_router.length_m,
                                 channel=CHANNEL)
        ingester.start()
        trainer = ContinuousTrainer(oracle_router, state, gnn_path,
                                    steps=args.retrain_steps, min_obs=400,
                                    device=args.device)

        def retrain_loop() -> None:
            while not swap_stop.wait(2.0):
                trainer.run_once()

        retrain_thread = threading.Thread(target=retrain_loop, daemon=True)
        retrain_thread.start()

        def sample_loop() -> None:
            while not sample_stop.is_set():
                try:
                    t = time.time()
                    feat = harness.post(f"{base}/api/request_route",
                                        od_body, timeout=120)
                    summary = feat.get("properties", {}).get("summary", {})
                    samples.append({
                        "t": t,
                        "duration_s": float(summary.get("duration", 0)),
                        "distance_m": float(summary.get("distance", 0)),
                        "overlap": corridor_overlap(
                            feat.get("geometry", {}).get("coordinates",
                                                         [])),
                    })
                except Exception as e:
                    samples.append({"t": time.time(),
                                    "error": f"{type(e).__name__}: {e}"})
                sample_stop.wait(1.5)

        threading.Thread(target=sample_loop, daemon=True).start()

        print(f"[4/6] open loop {args.rps} rps × {args.duration:.0f} s, "
              f"{args.drivers} probe drivers; corridor jam at "
              f"t+{args.duration / 3:.0f} s…", flush=True)
        workload = MixedWorkload(mix=MIX, seed=args.seed, road_graph=True,
                                 probe_edges=n_edges)
        sse = SseClients(base, 2, channel=workload.sse_channel)
        sse.__enter__()
        offsets = poisson_schedule(RateCurve.constant(args.rps),
                                   args.duration, seed=args.seed)
        requests = workload.sequence(len(offsets))
        started = threading.Event()
        clock = {}

        def inject_later() -> None:
            started.wait(timeout=300)
            # the schedule's offset 0 lies one runway after ``started``
            t_start = time.time() + harness.START_RUNWAY_S
            clock["t_inject"] = t_start + args.duration / 3.0
            delay = clock["t_inject"] - time.time()
            if delay > 0:
                time.sleep(delay)
            scenario.set_active(True)
            print(f"  corridor jam ACTIVE at "
                  f"t+{time.time() - t_start:.0f} s", flush=True)

        injector = threading.Thread(target=inject_later, daemon=True)
        injector.start()
        records, started_unix = harness.run_open_loop_process(
            [base], offsets, requests, workers=16,
            timeout=max(60.0, 4 * args.slo_ms / 1000), started=started)
        injector.join(timeout=60)
        t_start, t_inject = started_unix, clock["t_inject"]
        report = summarize(records, args.duration, len(offsets))
        pace = harness.pace_check(report)
        sample_stop.set()
        swap_stop.set()
        # let an in-flight retrain cycle finish before teardown
        retrain_thread.join(timeout=60.0)
        sse.__exit__()
        sse_events = sse.snapshot()

        print("[5/6] oracle check + fleet judgement…", flush=True)
        import scipy.sparse as sp
        from scipy.sparse.csgraph import dijkstra

        from routest_tpu_torch.data.road_graph import haversine_np

        oracle = {"checked": False}
        for _attempt in range(5):
            live0 = harness.fetch(f"{replica_base}/api/live?metric=1",
                                  timeout=120)
            feat = harness.post(f"{base}/api/request_route", od_body,
                                timeout=120)
            live1 = harness.fetch(f"{replica_base}/api/live")
            if live0.get("epoch") != live1.get("epoch"):
                continue  # flipped mid-check: retry at the next epoch
            metric = np.asarray(live0["edge_time_s"], np.float64)
            n = oracle_router.n_nodes
            adj = sp.coo_matrix(
                (metric, (oracle_router.senders, oracle_router.receivers)),
                shape=(n, n)).tocsr()
            src = oracle_router.snap(np.asarray([a, b], np.float32))
            want = dijkstra(adj, directed=True,
                            indices=np.asarray(src[:1], np.int64))
            snap_m = haversine_np(
                np.asarray([a[0], b[0]]), np.asarray([a[1], b[1]]),
                oracle_router.coords[src, 0], oracle_router.coords[src, 1])
            oracle_s = float(want[0, src[1]]) + float(snap_m.sum()) / 8.3
            served_s = float(feat["properties"]["summary"]["duration"])
            rel = abs(served_s - oracle_s) / max(oracle_s, 1.0)
            oracle = {"checked": True, "epoch": live0.get("epoch"),
                      "served_duration_s": round(served_s, 2),
                      "oracle_duration_s": round(oracle_s, 2),
                      "rel_err": round(rel, 6), "pass": rel < ORACLE_REL}
            break

        live_final = harness.fetch(f"{replica_base}/api/live", timeout=60)
        replica_metrics = harness.fetch(f"{replica_base}/api/metrics",
                                        timeout=60)
        replica_slo = harness.fetch(f"{replica_base}/api/slo", timeout=60)
        gw.slo.tick()
        gateway_slo = gw.slo.snapshot()
        health = harness.fetch(f"{replica_base}/api/health", timeout=60)
    finally:
        sample_stop.set()
        swap_stop.set()
        if retrain_thread is not None:
            retrain_thread.join(timeout=60.0)
        for part in (fleet, ingester):
            if part is not None:
                part.stop()
        try:
            if httpd is not None:
                gw.drain(timeout=5)
        finally:
            sup.drain(timeout=20)
            broker.shutdown()
            broker.server_close()
            shutil.rmtree(work_dir, ignore_errors=True)

    an = analyze(samples, t_inject)
    flips = int(live_final.get("customize", {}).get("flips", 0))
    registry = replica_metrics.get("registry", {})

    def _counter(name: str, **labels) -> int:
        total = 0
        for series in registry.get(name, {}).get("series", ()):
            if all(series.get("labels", {}).get(k) == v
                   for k, v in labels.items()):
                total += int(series.get("value", 0))
        return total

    swaps_accepted = _counter("rtpu_road_model_swaps_total",
                              result="accepted")
    client_5xx = sum(1 for r in records
                     if r.status is not None and r.status >= 500)
    slo_green = (gateway_slo.get("state") == "ok"
                 and replica_slo.get("state") == "ok")
    metric_info = live_final.get("metric") or {}
    customize_s = metric_info.get("customize_s")
    full_build_s = metric_info.get("full_build_s")
    checks = live_checks(
        eta_shift=an["eta_shift"], route_shift=an["route_shift"],
        staleness_s=an["staleness_s"], bound_s=args.staleness_bound,
        oracle_pass=oracle.get("pass"), client_5xx=client_5xx,
        slo_green=slo_green, flips=flips, swaps_accepted=swaps_accepted,
        customize_s=customize_s, full_build_s=full_build_s)
    customize_ratio = (round(full_build_s / customize_s, 2)
                       if checks["customize_beats_full_build"]
                       and customize_s else None)

    def _r(v, nd=1):
        return None if v is None or (isinstance(v, float)
                                     and math.isnan(v)) else round(v, nd)

    launches = (harness.replica_launches({"replica_metrics": {
        "r0": replica_metrics}}).get("r0", 0)
        - harness.replica_launches({"replica_metrics": {
            "r0": metrics0}}).get("r0", 0))
    passed = harness.passed(all(checks.values()), pace)
    record = {
        "generated_unix": int(t_run),
        "quick": bool(args.quick),
        "card": harness.card_identity(args.device),
        "host": {"cpus": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "extract_nodes": args.nodes,
        "graph_nodes": int(oracle_router.n_nodes),
        "edges": n_edges,
        "corridor_edges": int(len(corridor)),
        "drivers": args.drivers,
        "duration_s": args.duration,
        "customize_interval_s": args.customize_s,
        "half_life_s": args.half_life_s,
        "staleness_bound_s": args.staleness_bound,
        "extract_and_oracle_router_s": round(extract_s, 1),
        "replica_boot_s": _r(boot_s),
        "warm_first_request_s": round(warm_s, 1),
        "workload": workload.describe(),
        "load": report,
        "pace": pace,
        "sse_events": sse_events,
        "timeline": {
            "inject_at_s": round(t_inject - t_start, 1),
            "baseline_median_duration_s": _r(an["base_dur"]),
            "post_detect_median_duration_s": _r(an["tail_dur"]),
            "baseline_median_distance_m": _r(an["base_dist"]),
            "post_detect_median_distance_m": _r(an["tail_dist"]),
            "baseline_corridor_overlap": _r(an["base_overlap"], 3),
            "post_detect_corridor_overlap": _r(an["tail_overlap"], 3),
            "eta_shift_frac": round(an["eta_shift"], 4),
            "injection_to_served_effect_s": _r(an["staleness_s"]),
            "samples": an["samples"],
        },
        "oracle": oracle,
        "live": {"flips": flips,
                 "final_epoch": live_final.get("epoch"),
                 "ingest": live_final.get("ingest"),
                 "customize_s_last": customize_s,
                 "full_build_s": full_build_s,
                 "customize_speedup": customize_ratio,
                 "swaps_accepted": swaps_accepted,
                 "swaps_rejected": _counter(
                     "rtpu_road_model_swaps_total", result="rejected")},
        "trainer": {"device": str(trainer.device) if trainer else None,
                    "cycles": trainer.cycles if trainer else 0,
                    "steps_per_cycle": args.retrain_steps,
                    "last_result": (trainer.last_result
                                    if trainer else None)},
        "slo": {"gateway_state": gateway_slo.get("state"),
                "replica_state": replica_slo.get("state"),
                "green": slo_green},
        "client_5xx": client_5xx,
        "launches": launches,
        "road_router": (health.get("checks", {}).get("engine", {})
                        .get("road_router")),
        "checks": checks,
        "pass": passed,
        "wall_s": round(time.time() - t_run, 1),
    }
    harness.write_record(args.out, record)
    print(f"\n[6/6] checks: "
          + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                     for k, v in checks.items())
          + f" pace={'lagged' if pace['generator_lagged'] else 'kept'}")
    print(f"ETA shift {an['eta_shift']:+.0%}, injection→served "
          f"{record['timeline']['injection_to_served_effect_s']} s (bound "
          f"{args.staleness_bound:.0f} s), flips {flips}, verified swaps "
          f"{swaps_accepted}, customize {customize_s} s vs build "
          f"{full_build_s} s, trainer on {record['trainer']['device']}, "
          f"{launches} launches → {args.out} ({record['wall_s']} s)",
          flush=True)
    # _exit, not sys.exit: probe-fleet and ingester daemon threads racing
    # interpreter teardown must not turn a written verdict into a crash
    os._exit(0 if passed else 1)


if __name__ == "__main__":
    main()
