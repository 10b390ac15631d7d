"""Metro routing served from the card, under open-loop load →
artifacts/router_serving_cuda.json.

The port's counterpart of ``scripts/bench_router_serving.py``: one
replica of ``python -m routest_tpu_torch.serve`` on the card behind the
port's in-process ``Gateway`` (supervisor + worker process + gateway),
pointed at a metro-scale OSM extract (``ROAD_GRAPH_OSM``), answers
``/api/request_route`` with ``road_graph: true`` through the multi-level
overlay and ``/api/predict_eta`` through the fused kernel, under the
open-loop mixed generator (70% routes Zipf-skewed over the OD pairs,
30% ETAs) with the SLO engine judging the result. The overlay is built
in this process into ``ROUTEST_HIER_CACHE`` first, so the replica loads
it; the replica captures the overlay's solve for source buckets 2, 4,
16 and 32 (``ROUTEST_ROUTER_AOT``). Recorded beside the latency
percentiles: the route cache's hit rate and the solve batcher's merged
dispatches from the replica's health, its ``solver_info`` (capture
seconds included), and the fused launches it made
(``/api/metrics?replicas=1``).

``--compare-cache`` replays the identical offered load against a second
replica booted with ``ROUTEST_ROUTE_CACHE=0``. The open loop sends from
processes of its own (:func:`cuda_harness.run_open_loop_process`); a run
whose generator lagged (:func:`cuda_harness.pace_check`) never passes.

:func:`judge` holds the record to the JAX verdict, each a named check:
the script's pass rule (request_route p95 within the SLO, both SLO
engines ``ok``, error rate ≤ 1%) and the JAX slow test's assertions
(``tests/test_router_fastlane_bench.py::
test_router_serving_quick_cache_comparison``: a cache hit, the batcher
reported, no hit with the cache off, a cache-on mean latency more than
1.1× below cache-off). The record names the card and its power limit.
``--cpu`` serves on the CPU for a rehearsal; without a card and without
``--cpu`` the script exits 2.

Usage: python3 scripts/bench_router_serving_cuda.py [--nodes 250000]
       [--rps 1.0] [--duration 90] [--quick] [--slo-ms 2500]
       [--compare-cache] [--cpu] [--out artifacts/router_serving_cuda.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

MODEL = harness.MODEL

# The JAX script's plan (bench_router_serving.py:153-307).
NODES = 250_000
RPS, DURATION_S, SLO_MS, SEED = 1.0, 90.0, 2500.0, 42
QUICK_NODES, QUICK_DURATION_S = 50_000, 45.0
MIX = {"request_route": 0.7, "predict_eta": 0.3}
ROUTER_AOT = "2,4,16,32"
FLEET = {"hedge": False, "max_inflight": 32, "queue_depth": 64}
WARM_REQUESTS = 6
OPEN_LOOP_WORKERS = 16
# Its pass rule and the slow test's bounds.
ERROR_RATE_MAX = 0.01
CACHE_SPEEDUP_MIN = 1.1
HOST_CAVEAT = ("one replica on the card; the gateway, the generator's "
               "sender processes and the replica's HTTP server share the "
               "card's host: compare cache-on/off and batching ratios, not "
               "wall ms")


def slo_spec(slo_ms: float) -> str:
    """The JAX script's objectives: request_route at ``slo_ms`` p95 and
    99% availability, predict_eta at 1 s and 99.9%."""
    return (f"/api/request_route:latency_ms={slo_ms:.0f},"
            f"latency_target=0.95,availability=0.99;"
            f"/api/predict_eta:latency_ms=1000,latency_target=0.95,"
            f"availability=0.999")


def judge(record: dict) -> dict:
    """The JAX verdict on a record, as named checks: the script's pass
    rule, each open-loop run's pace, and the slow test's assertions."""
    load = record["load"]
    rc = record.get("route_cache") or {}
    checks = {
        "request_route_p95_within_slo": (record["request_route_p95_ms"]
                                         <= record["slo_threshold_ms"]),
        "slo_green": bool(record["slo"]["green"]),
        "error_rate_le_1pct": load["error_rate"] <= ERROR_RATE_MAX,
        "generator_kept_pace": not harness.pace_check(load)[
            "generator_lagged"],
        "route_cache_hit": rc.get("hit_rate", 0.0) > 0.0,
        "batch_reported": record.get("batch") is not None,
    }
    off = record.get("cache_off")
    if off is not None:
        off_rc = off.get("route_cache")
        checks["cache_off_generator_kept_pace"] = not harness.pace_check(
            off["load"])["generator_lagged"]
        checks["cache_off_no_hits"] = (off_rc is None
                                       or off_rc.get("hits", 0) == 0)
        checks["cache_speedup_mean_gt_1_1"] = (
            (record.get("cache_speedup_mean") or 0.0) > CACHE_SPEEDUP_MIN)
    return {k: bool(v) for k, v in checks.items()}


def build_extract(n_nodes: int, out_dir: str, device: str) -> str:
    """The JAX script's extract (:func:`cuda_harness.metro_streets`)
    written as OSM XML, re-read, and its overlay built into
    ``ROUTEST_HIER_CACHE`` on ``device``."""
    from routest_tpu_torch.data.osm import load_osm, save_osm
    from routest_tpu_torch.optimize.road_router import RoadRouter

    path = os.path.join(out_dir, f"metro_{n_nodes}.osm.gz")
    save_osm(path, harness.metro_streets(n_nodes))
    extract = load_osm(path)
    t0 = time.perf_counter()
    router = RoadRouter(graph=extract, use_gnn=False, use_transformer=False,
                        device=device)
    info = router.solver_info
    print(f"  overlay prebuilt in {time.perf_counter() - t0:.1f}s "
          f"({router.n_nodes:,} nodes, "
          f"{info.get('overlay', {}).get('n_levels')} levels, "
          f"hub_labels={info.get('hub_labels')})", flush=True)
    del router
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    return path


def run_phase(label: str, env: dict, workload, offsets, requests,
              slo_ms: float) -> dict:
    """Boot ONE replica + gateway under ``env``, warm it, replay the
    offered schedule from sender processes, and return the phase record
    (load report and pace, SLO states, the replica's health provenance
    and fused launches)."""
    from routest_tpu_torch.core.config import FleetConfig
    from routest_tpu_torch.loadgen import KeepAliveClient, summarize
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    ports = [harness.free_port()]
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0)
    t_boot = time.perf_counter()
    sup.start()
    gw = httpd = None
    try:
        if not sup.ready(timeout=600):
            raise RuntimeError(f"{label}: fleet worker never became ready")
        boot_s = time.perf_counter() - t_boot
        gw = Gateway([("127.0.0.1", p) for p in ports],
                     FleetConfig(**FLEET), supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        print(f"  [{label}] warming (the first road request builds the "
              f"replica's router from the cache)…", flush=True)
        client = KeepAliveClient(base, timeout=600.0)
        t0 = time.perf_counter()
        try:
            for req in workload.sequence(WARM_REQUESTS):
                client.send(req)
        finally:
            client.close()
        warm_s = time.perf_counter() - t0

        duration = float(offsets[-1]) if len(offsets) else 0.0
        print(f"  [{label}] open loop: {len(offsets)} arrivals over "
              f"{duration:.0f}s…", flush=True)
        records, _ = harness.run_open_loop_process(
            [base], offsets, requests, workers=OPEN_LOOP_WORKERS,
            timeout=max(60.0, 4 * slo_ms / 1000))
        report = summarize(records, duration, len(offsets))
        pace = harness.pace_check(report)

        gateway_slo = {}
        if gw.slo is not None:
            gw.slo.tick()
            gateway_slo = gw.slo.snapshot()
        replica_slo = harness.fetch(f"{base}/api/slo")
        health = harness.fetch(f"{base}/api/health")
        launches = harness.fleet_launches(base)
    finally:
        try:
            if httpd is not None:
                gw.drain(timeout=5)
        finally:
            sup.drain(timeout=20)

    road = (health.get("checks", {}).get("engine", {})
            .get("road_router")) or {}
    rr = report["routes"].get("/api/request_route", {})
    return {
        "label": label,
        "boot_s": round(boot_s, 1),
        "warm_first_requests_s": round(warm_s, 1),
        "load": report,
        "pace": pace,
        "request_route_p95_ms": rr.get("latency", {}).get(
            "p95_ms", float("inf")),
        "slo": {"gateway_state": gateway_slo.get("state"),
                "replica_state": replica_slo.get("state"),
                "green": (gateway_slo.get("state") == "ok"
                          and replica_slo.get("state") == "ok")},
        "road_router": road,
        "route_cache": road.get("route_cache"),
        "batch": road.get("batch"),
        "launches": launches,
    }


def _route_mean_ms(phase: dict):
    return (phase["load"]["routes"].get("/api/request_route", {})
            .get("latency", {}).get("mean_ms"))


def apply_quick(args) -> None:
    """The JAX script's --quick: the 50k extract, a 45 s run at most."""
    args.nodes = min(args.nodes, QUICK_NODES)
    args.duration = min(args.duration, QUICK_DURATION_S)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nodes", type=int, default=NODES)
    parser.add_argument("--rps", type=float, default=RPS,
                        help="offered open-loop arrival rate")
    parser.add_argument("--duration", type=float, default=DURATION_S)
    parser.add_argument("--slo-ms", type=float, default=SLO_MS,
                        help="request_route latency SLO threshold")
    parser.add_argument("--quick", action="store_true",
                        help="50k extract, 45 s run — the slow-test preset")
    parser.add_argument("--compare-cache", action="store_true",
                        help="rerun the identical offered load with the "
                             "route cache disabled and record both")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU (ROUTEST_DEVICE=cpu); "
                             "without it the script needs a card")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "router_serving_cuda.json; build/"
                             "router_serving_cpu.json with --cpu)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    device = harness.require_card(args.cpu, "bench_router_serving_cuda")
    if args.out is None:
        args.out = os.path.join(
            REPO, "artifacts", "router_serving_cuda.json") \
            if device == "cuda" \
            else os.path.join(REPO, "build", "router_serving_cpu.json")
    if args.quick:
        apply_quick(args)

    from routest_tpu_torch.loadgen import (MixedWorkload, RateCurve,
                                           poisson_schedule)

    t_start = time.time()
    work_dir = tempfile.mkdtemp(prefix="router-serving-")
    hier_cache = os.path.join(work_dir, "hier")
    os.environ["ROUTEST_HIER_CACHE"] = hier_cache
    # postmortems from the warm phase's SLO edges (the first road request
    # pays the router's load) belong to the run's directory
    os.environ["RTPU_RECORDER_DIR"] = os.path.join(work_dir, "postmortems")
    spec = slo_spec(args.slo_ms)
    os.environ["RTPU_SLO_OBJECTIVES"] = spec
    try:
        print(f"[1/3] building the {args.nodes:,}-node extract + overlay "
              f"cache…", flush=True)
        t0 = time.perf_counter()
        extract = build_extract(args.nodes, work_dir, device)
        extract_s = time.perf_counter() - t0

        env = harness.server_env(
            device, ROAD_GRAPH_OSM=extract, ROUTEST_HIER_CACHE=hier_cache,
            ROUTEST_MESH="0", ROUTEST_WARM_BUCKETS="0",
            ETA_MODEL_PATH=MODEL, RTPU_SLO_OBJECTIVES=spec,
            # route bodies are 3 waypoints (bucket 4); matrix and bench
            # traffic pads to 16; the batcher merges up to 32 rows
            ROUTEST_ROUTER_AOT=ROUTER_AOT,
            RTPU_RECORDER_DIR=os.path.join(work_dir, "workers"))
        workload = MixedWorkload(mix=dict(MIX), seed=args.seed,
                                 road_graph=True)
        offsets = poisson_schedule(RateCurve.constant(args.rps),
                                   args.duration, seed=args.seed)
        requests = workload.sequence(len(offsets))

        print("[2/3] route cache on (1 replica + gateway)…", flush=True)
        phase_on = run_phase("cache-on", env, workload, offsets, requests,
                             args.slo_ms)
        phase_off = None
        if args.compare_cache:
            print("[3/3] route cache off (same offered load, "
                  "ROUTEST_ROUTE_CACHE=0)…", flush=True)
            phase_off = run_phase("cache-off",
                                  dict(env, ROUTEST_ROUTE_CACHE="0"),
                                  workload, offsets, requests, args.slo_ms)
        else:
            print("[3/3] skipped (--compare-cache off)", flush=True)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    card = harness.card_identity(device)
    record = {
        "card": card,
        "host": {"cpus": card["cpu_count"],
                 "note": "1 replica; wall latency scales with cores"},
        "host_caveat": HOST_CAVEAT,
        "quick": bool(args.quick),
        "extract_nodes": args.nodes,
        "extract_build_s": round(extract_s, 1),
        "config": {"router_aot": ROUTER_AOT, "fleet": dict(FLEET),
                   "slo_objectives": spec, "open_loop_workers":
                   OPEN_LOOP_WORKERS, "sender_processes":
                   harness.SENDER_PROCESSES},
        "workload": workload.describe(),
        "offered": {"rps": args.rps, "duration_s": args.duration,
                    "arrivals": len(offsets)},
        "slo_threshold_ms": args.slo_ms,
        "boot_s": phase_on["boot_s"],
        "warm_first_requests_s": phase_on["warm_first_requests_s"],
        "load": phase_on["load"],
        "pace": phase_on["pace"],
        "request_route_p95_ms": phase_on["request_route_p95_ms"],
        "slo": phase_on["slo"],
        "road_router": phase_on["road_router"],
        "route_cache": phase_on["route_cache"] or {},
        "batch": phase_on["batch"],
        "launches": phase_on["launches"],
    }
    if phase_off is not None:
        p95_on, off_p95 = (phase_on["request_route_p95_ms"],
                           phase_off["request_route_p95_ms"])
        record["cache_off"] = {
            "request_route_p95_ms": off_p95,
            "boot_s": phase_off["boot_s"],
            "warm_first_requests_s": phase_off["warm_first_requests_s"],
            "load": phase_off["load"],
            "pace": phase_off["pace"],
            "slo": phase_off["slo"],
            "route_cache": phase_off["route_cache"],
            "batch": phase_off["batch"],
            "launches": phase_off["launches"],
        }
        record["cache_speedup_p95"] = (
            round(off_p95 / p95_on, 3)
            if p95_on and p95_on == p95_on else None)
        # at light load p95 lands on a slow miss in either phase; the
        # mean drops by about the hit rate times the miss cost
        mean_on, mean_off = _route_mean_ms(phase_on), _route_mean_ms(phase_off)
        record["cache_speedup_mean"] = (
            round(mean_off / mean_on, 3) if mean_on and mean_off else None)
        record["launches"] += phase_off["launches"]
    record["checks"] = judge(record)
    record["pass"] = all(record["checks"].values())
    record["wall_s"] = round(time.time() - t_start, 1)
    harness.write_record(args.out, record)
    failed = [k for k, v in record["checks"].items() if not v]
    msg = (f"\nrequest_route p95 {record['request_route_p95_ms']} ms (SLO "
           f"{args.slo_ms:.0f} ms) | cache hit rate "
           f"{record['route_cache'].get('hit_rate')} | slo gateway="
           f"{record['slo']['gateway_state']} replica="
           f"{record['slo']['replica_state']} | errors "
           f"{record['load']['error_rate']:.2%} | launches "
           f"{record['launches']}")
    if phase_off is not None:
        msg += (f" | cache-off p95 {record['cache_off']['request_route_p95_ms']}"
                f" ms, mean speedup {record['cache_speedup_mean']}x")
    print(msg + f" → {args.out} (pass={record['pass']}"
          + (f", failed {failed}" if failed else "") + ")", flush=True)
    print(json.dumps({"checks": record["checks"]}), flush=True)
    os._exit(0 if record["pass"] else 1)


if __name__ == "__main__":
    main()
