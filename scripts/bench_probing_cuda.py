"""Blackbox probing on the card, end to end → artifacts/probing_cuda.json.

The port's counterpart of ``scripts/bench_probing.py``: a real fleet of
the port (``cuda_harness.Fleet``: supervisor + two ``python -m
routest_tpu_torch.serve`` replicas on the card + in-process gateway,
live traffic where the scenario needs metric epochs) under open-loop
load, with the port's blackbox prober armed. Three injected correctness
faults — each invisible to every other layer, because the replica keeps
answering well-formed 200s — must each be detected by the prober, page
the correctness SLO within ``DETECT_BOUND_S``, and produce a
flight-recorder bundle naming the faulty replica and embedding the
probe/oracle pair:

- ``compute_divergence`` — a replica rolled onto seeded
  ``device.compute:skew`` chaos (the silently wrong device);
- ``stale_epoch`` — a replica whose ``live.customize`` cycles are
  chaos-dropped, so it serves a frozen metric epoch while the fleet
  moves on; its bundle must name the ``epoch`` skew dimension;
- ``divergent_model`` — a ×1.5-scaled artifact (finite, far past the
  swap gate's margin) landed on one replica by a fresh-boot rollout.

The fault scenarios run under background open-loop load, as the JAX
script's do; the record names the objective (the probe kind) that paged
first. ``clean`` proves the other half: across ≥ 1 metric flip and ≥ 1
verified model swap (×(1 + 1e-4), through the port's RTPU1 writer) the
prober raises ZERO correctness pages, probe traffic appears in no user
family, the served route matches the scipy oracle on the replica's own
exported metric (rel 2e-3), and arming the prober adds ≤ 1 % (2 ms
floor) to serving p95. Each open-loop window sends from processes of
its own (:func:`cuda_harness.run_open_loop_process`); the overhead
windows, whose p95 a check reads, fail ``clean`` when their generator
lagged, and the fault scenarios' background run records its pace.

The record holds every check of the JAX script with its bound, the
fused launches the replicas made, the card's name and power limit, and
the host's cores. ``--cpu`` serves the replicas on the CPU for a
rehearsal; without a card and without ``--cpu`` the script exits 2.

Usage: python3 scripts/bench_probing_cuda.py [--quick] [--cpu]
       [--out artifacts/probing_cuda.json] [--cache-dir DIR]
       [--scenario NAME]
"""

from __future__ import annotations

import argparse
import json
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

# The JAX script's constants (bench_probing.py:59-67).
SWAP_MAX_DIV_MIN = harness.SWAP_MAX_DIV_MIN
PROBE_INTERVAL_S = harness.PROBE_INTERVAL_S
DETECT_BOUND_S = 90.0
OVERHEAD_PCT = 0.01
OVERHEAD_FLOOR_MS = 2.0
# The fault scenarios' background schedule: longer than any scenario,
# stopped at its end.
LOAD_SPAN_S = 900.0


def _scaled_artifact(src: str, dst: str, factor: float) -> None:
    """``src``'s weights × ``factor`` (the JAX script's ``tree_map``),
    through the port's RTPU1 writer."""
    harness.map_artifact(src, dst, lambda x: x * factor)


def _fleet_metrics(fleet):
    try:
        return fleet.metrics()
    except OSError:
        return {}


# ── scenarios ────────────────────────────────────────────────────────


def scenario_clean(extract, args) -> dict:
    work = tempfile.mkdtemp(prefix="probing-clean-")
    window_s = 12.0 if args.quick else 20.0
    out: dict = {"scenario": "clean"}
    # The STANDING cost of probing: the production-shaped interval (the
    # fault scenarios crank it down for fast detection).
    fleet = harness.Fleet(live=True, extract=extract,
                          cache_dir=args.cache_dir, work_dir=work,
                          device=args.device, probe_interval=2.5)
    try:
        metrics0 = _fleet_metrics(fleet)
        # (1) overhead: alternating prober-off / prober-on windows, best
        # (min) p95 per mode; probe drivers off (scenario background,
        # not the treatment); the prober warmed first.
        prober = fleet.arm_prober()
        time.sleep(4 * fleet.prober_cfg.interval_s)
        prober.stop()
        offs, ons, paces = [], [], []

        def window():
            from routest_tpu_torch.loadgen import summarize

            records = harness.open_loop(fleet.base, args.rate, window_s)
            paces.append(harness.pace_check(summarize(
                records, window_s, len(records))))
            return harness.p95_ms(records)

        offs.append(window())
        prober.start()
        ons.append(window())
        prober.stop()
        offs.append(window())
        prober.start()
        ons.append(window())
        p95_off, p95_on = min(offs), min(ons)
        overhead_ok = (p95_on <= p95_off * (1 + OVERHEAD_PCT)
                       or p95_on - p95_off <= OVERHEAD_FLOOR_MS)
        out["overhead"] = {
            "p95_off_ms": round(p95_off, 3),
            "p95_on_ms": round(p95_on, 3),
            "windows_off_ms": [round(v, 3) for v in offs],
            "windows_on_ms": [round(v, 3) for v in ons],
            "budget_pct": OVERHEAD_PCT * 100,
            "noise_floor_ms": OVERHEAD_FLOOR_MS,
            "ok": bool(overhead_ok),
        }
        out["pace"] = paces

        # (2) background on: probe drivers flip the live metric for
        # real; then a verified model swap mid-run through both
        # replicas' reload watchers and the golden gate.
        fleet.start_probe_drivers()
        _scaled_artifact(fleet.model_path, fleet.model_path, 1.0 + 1e-4)
        st = os.stat(fleet.model_path)
        os.utime(fleet.model_path,
                 ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))

        def swaps_accepted() -> int:
            total = 0
            for port in fleet.ports:
                reg = harness.fetch(f"http://127.0.0.1:{port}/api/metrics",
                                    timeout=30).get("registry", {})
                for s in reg.get("rtpu_model_swaps_total",
                                 {}).get("series", ()):
                    if s.get("labels", {}).get("result") == "accepted":
                        total += int(s.get("value", 0))
            return total

        def top_epoch() -> int:
            return max(harness.fetch(f"http://127.0.0.1:{p}/api/live",
                                     timeout=30).get("epoch", 0)
                       for p in fleet.ports)

        epoch0 = top_epoch()
        deadline = time.time() + (60 if args.quick else 120)
        while time.time() < deadline:
            if swaps_accepted() >= 2:
                break
            time.sleep(1.0)
        # (3) ≥ 1 legitimate metric flip while the prober watches.
        flips = 0
        while time.time() < deadline and flips < 1:
            flips = top_epoch() - epoch0
            time.sleep(1.0)
        time.sleep(5 * PROBE_INTERVAL_S)   # post-flip probe rounds
        out["swaps_accepted"] = swaps_accepted()
        out["metric_flips"] = flips

        # (4) strict per-replica oracle parity.
        out["strict_oracle"] = strict_oracle_check(fleet)

        # (5) verdicts, zero pages, exclusion.
        out["final_verdicts"] = {
            k: v.get("verdict")
            for k, v in fleet.prober.snapshot()["probes"].items()}
        out["zero_pages"] = harness.zero_pages(fleet.prober,
                                               fleet.recorder_dir)
        out["exclusion"] = exclusion_check(fleet)
        out["probe_rounds"] = fleet.prober._rounds
        out["launches"] = harness.launch_delta(metrics0,
                                               _fleet_metrics(fleet))
        checks = {
            "zero_correctness_pages": out["zero_pages"]["ok"],
            "verified_swap_ge_1": out["swaps_accepted"] >= 1,
            "metric_flip_ge_1": flips >= 1,
            "all_probes_pass_at_end": all(
                v == "pass" for v in out["final_verdicts"].values()),
            "strict_oracle_parity": out["strict_oracle"]["ok"],
            "probe_traffic_excluded": out["exclusion"]["ok"],
            "overhead_within_budget": out["overhead"]["ok"],
        }
        out["checks"] = checks
        # the overhead windows' p95 is a check's input: a window whose
        # generator lagged fails the scenario
        out["pass"] = all(checks.values()) and not any(
            p["generator_lagged"] for p in paces)
    finally:
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    return out


def strict_oracle_check(fleet) -> dict:
    """Served route duration ≡ scipy Dijkstra on the replica's OWN
    exported metric (epoch-stable fetch), to 2e-3."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    wps = fleet.prober.route_waypoints
    replica = f"http://127.0.0.1:{fleet.ports[0]}"
    body = {"source_point": {"lat": wps[0][0], "lon": wps[0][1]},
            "destination_points": [{"lat": wps[1][0], "lon": wps[1][1],
                                    "payload": 1}],
            "driver_details": {"vehicle_type": "car",
                               "vehicle_capacity": 1e9,
                               "maximum_distance": 1e9},
            "road_graph": True}
    topo = harness.fetch(
        f"{replica}/api/debug/probe_subgraph?"
        f"wp={wps[0][0]},{wps[0][1]}&wp={wps[1][0]},{wps[1][1]}",
        timeout=60)
    for _attempt in range(5):
        live0 = harness.fetch(f"{replica}/api/live?metric=1", timeout=60)
        feat = harness.post(f"{replica}/api/request_route", body,
                            timeout=120)
        live1 = harness.fetch(f"{replica}/api/live", timeout=60)
        if live0.get("epoch") != live1.get("epoch") \
                or "edge_time_s" not in live0:
            continue
        metric = np.asarray(live0["edge_time_s"], np.float64)
        adj = sp.coo_matrix(
            (metric, (np.asarray(topo["senders"]),
                      np.asarray(topo["receivers"]))),
            shape=(topo["nodes"], topo["nodes"])).tocsr()
        snapped = np.asarray(topo["snapped"])
        want = dijkstra(adj, directed=True, indices=snapped[:1])
        oracle_s = float(want[0, snapped[1]]) \
            + float(sum(topo["snap_m"])) / 8.3
        served_s = float(feat["properties"]["summary"]["duration"])
        rel = abs(served_s - oracle_s) / max(oracle_s, 1.0)
        return {"ok": rel < 2e-3, "epoch": live0.get("epoch"),
                "served_s": round(served_s, 3),
                "oracle_s": round(oracle_s, 3),
                "rel_err": round(rel, 7)}
    return {"ok": False, "error": "no epoch-stable window"}


def exclusion_check(fleet) -> dict:
    """Probe traffic appears in no user-facing family: the probed
    routes' user request families stay at zero while the probe
    families carry the traffic."""
    reg = harness.fetch(f"{fleet.base}/api/metrics", timeout=30)["registry"]

    def family(name):
        return {tuple(s.get("labels", {}).values()):
                s.get("value", s.get("count", 0))
                for s in reg.get(name, {}).get("series", ())}

    user = family("rtpu_gateway_request_seconds")
    probe = family("rtpu_probe_gateway_requests_total")
    probed_routes = ["/api/predict_eta_batch", "/api/request_route",
                     "/api/matrix"]
    leaked = {r: user.get((r,), 0) for r in probed_routes
              if user.get((r,), 0)}
    carried = sum(probe.get((r,), 0) for r in probed_routes)
    return {"ok": not leaked and carried > 0,
            "leaked_user_counts": leaked,
            "probe_family_count": carried,
            "user_predict_eta_count":
                user.get(("/api/predict_eta",), 0)}


def scenario_fault(name, extract, args, *, live, overlay=None,
                   corrupt_model=False, expect_dimensions=None) -> dict:
    """Shared fault harness: boot → arm → baseline all-pass → inject
    via replace_replica under open-loop load → page within bound →
    bundle names the replica."""
    work = tempfile.mkdtemp(prefix=f"probing-{name}-")
    out: dict = {"scenario": name}
    fleet = harness.Fleet(live=live, extract=extract,
                          cache_dir=args.cache_dir, work_dir=work,
                          device=args.device)
    load_stop = threading.Event()
    load_runs = []
    load_thread = None
    try:
        metrics0 = _fleet_metrics(fleet)
        if live:
            fleet.start_probe_drivers()
        prober = fleet.arm_prober()

        # Light background load (the user SLO must stay ok): one
        # open-loop run from sender processes of their own, through the
        # whole scenario (the JAX script's back-to-back 10 s windows
        # would leave a gap of a spawn's seconds between windows).
        load_started = threading.Event()

        def _load():
            from routest_tpu_torch.loadgen import summarize

            try:
                records = harness.open_loop(
                    fleet.base, args.rate, LOAD_SPAN_S, stop=load_stop,
                    started=load_started)
            except Exception as e:
                load_runs.append({"error": f"{type(e).__name__}: "
                                           f"{e}"[:120]})
                return
            span = max((r.offset_s for r in records), default=0.0) or 1.0
            rep = summarize(records, span, len(records))
            load_runs.append({"sent": rep["sent"], "ok": rep["ok"],
                              "errors": rep["errors"],
                              "latency": rep["latency"],
                              "pace": harness.pace_check(rep)})

        load_thread = threading.Thread(target=_load, daemon=True)
        load_thread.start()
        load_started.wait(timeout=300)
        baseline_deadline = time.time() + (30 if args.quick else 60)
        while time.time() < baseline_deadline:
            snap = prober.snapshot()["probes"]
            if snap and all(v.get("verdict") == "pass"
                            for v in snap.values()):
                break
            time.sleep(1.0)
        out["baseline_verdicts"] = {
            k: v.get("verdict")
            for k, v in prober.snapshot()["probes"].items()}
        overlay = dict(overlay or {})
        if corrupt_model:
            # ×1.5 weights: finite, plausibly sized outputs (~100 min
            # off), far past the swap gate's margin — wrong, not broken.
            bad_path = os.path.join(work, "eta_bad.msgpack")
            _scaled_artifact(fleet.model_path, bad_path, 1.5)
            overlay["ETA_MODEL_PATH"] = bad_path
        victim = fleet.replica_rids()[0]
        t_fault = time.time()
        faulty_rid = fleet.inject_replacement(victim, overlay,
                                              version=f"v-{name}")
        out.update({"victim": victim, "faulty_rid": faulty_rid,
                    "inject_wall_s": round(time.time() - t_fault, 3)})
        page = harness.wait_for_page(prober, DETECT_BOUND_S)
        out["page"] = page
        out["first_paged_probe"] = page.get("objective")
        out["detect_bound_s"] = DETECT_BOUND_S
        # The FIRST page may come from a probe kind that names the
        # replica indirectly; poll until a bundle naming the faulty
        # replica exists.
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline:
            bundles = harness.correctness_bundles(fleet.recorder_dir)
            out["bundle"] = harness.judge_fault_bundle(
                bundles, faulty_rid, require_dimensions=expect_dimensions)
            if out["bundle"]["ok"]:
                break
            time.sleep(1.0)
        if expect_dimensions:
            dims = set(out["bundle"].get("dimensions") or ())
            out["bundle"]["expected_dimensions_seen"] = \
                bool(dims & set(expect_dimensions))
        if not page["paged"]:
            # which probe kinds the scenario waited on, and what they saw
            out["waited_on"] = {
                k: v.get("verdict")
                for k, v in prober.snapshot()["probes"].items()}
        gw_slo = fleet.gw.slo
        if gw_slo is not None:
            gw_slo.tick()
            out["user_slo_state"] = gw_slo.worst_state()
        out["probe_rounds"] = prober._rounds
        out["launches"] = harness.launch_delta(metrics0,
                                               _fleet_metrics(fleet))
        checks = {
            "detected_and_paged": bool(page["paged"]),
            "within_bound": bool(page["paged"]
                                 and page["detect_s"] <= DETECT_BOUND_S),
            "bundle_names_faulty_replica": out["bundle"]["ok"],
            "user_slo_ok": out.get("user_slo_state", "ok") == "ok",
        }
        if expect_dimensions:
            checks["skew_dimension_identified"] = \
                out["bundle"].get("expected_dimensions_seen", False)
        out["checks"] = checks
    finally:
        load_stop.set()
        # Join BEFORE teardown: late client requests against a draining
        # gateway would poison the next scenario's user-SLO engine.
        if load_thread is not None:
            load_thread.join(timeout=60)
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    # the background load's pace is recorded, not gated: no check reads
    # its latency
    out["load"] = load_runs
    out["pass"] = all(out["checks"].values())
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="smaller extract + shorter phases")
    parser.add_argument("--cpu", action="store_true",
                        help="serve the replicas on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--nodes", type=int, default=6000)
    parser.add_argument("--rate", type=float, default=3.0)
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "probing_cuda"))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "probing_cuda.json; build/probing_cpu.json "
                             "with --cpu)")
    parser.add_argument("--scenario", default=None,
                        help="run one scenario (debug)")
    args = parser.parse_args()
    args.device = harness.require_card(args.cpu, "bench_probing_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "probing_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "probing_cpu.json")
    if args.quick:
        args.nodes = min(args.nodes, 4000)
    os.makedirs(args.cache_dir, exist_ok=True)
    os.environ["ROUTEST_HIER_CACHE"] = os.path.join(args.cache_dir, "hier")
    os.environ["RTPU_SWAP_MAX_DIV"] = f"{SWAP_MAX_DIV_MIN:g}"

    t0 = time.time()
    print(f"[1/5] extract + overlay cache ({args.nodes:,} nodes)…",
          flush=True)
    extract = harness.build_extract(args.nodes, args.cache_dir)

    scenarios: dict = {}
    plan = [
        ("clean", lambda: scenario_clean(extract, args)),
        ("compute_divergence", lambda: scenario_fault(
            "compute_divergence", extract, args, live=False,
            overlay={"RTPU_CHAOS_SPEC": "device.compute:skew=1.0/60",
                     "RTPU_CHAOS_SEED": "7"})),
        ("stale_epoch", lambda: scenario_fault(
            "stale_epoch", extract, args, live=True,
            overlay={"RTPU_CHAOS_SPEC": "live.customize:error=1.0",
                     "RTPU_CHAOS_SEED": "7"},
            expect_dimensions=("epoch",))),
        ("divergent_model", lambda: scenario_fault(
            "divergent_model", extract, args, live=False,
            corrupt_model=True)),
    ]
    for i, (name, run) in enumerate(plan):
        if args.scenario and name != args.scenario:
            continue
        print(f"[{i + 2}/5] scenario {name}…", flush=True)
        t = time.perf_counter()
        try:
            scenarios[name] = run()
        except Exception as e:
            scenarios[name] = {"scenario": name, "pass": False,
                               "error": f"{type(e).__name__}: {e}"}
        scenarios[name]["wall_s"] = round(time.perf_counter() - t, 1)
        print(f"  {name}: "
              f"{'PASS' if scenarios[name].get('pass') else 'FAIL'} "
              f"({scenarios[name]['wall_s']}s) "
              f"{json.dumps(scenarios[name].get('checks'))}", flush=True)

    record = {
        "generated_unix": int(t0),
        "card": harness.card_identity(args.device),
        "host": {"cpus": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "config": {
            "nodes": args.nodes, "rate_rps": args.rate,
            "probe_interval_s": PROBE_INTERVAL_S,
            "probe_fast_s": harness.PROBE_FAST_S,
            "probe_slow_s": harness.PROBE_SLOW_S,
            "swap_gate_margin_min": SWAP_MAX_DIV_MIN,
            "detect_bound_s": DETECT_BOUND_S,
            "overhead_budget_pct": OVERHEAD_PCT * 100,
            "overhead_noise_floor_ms": OVERHEAD_FLOOR_MS,
            "quick": bool(args.quick),
        },
        "scenarios": scenarios,
    }
    if args.scenario:
        record["partial"] = f"--scenario {args.scenario} (debug run)"
    record["checks"] = {name: bool(s.get("pass"))
                        for name, s in scenarios.items()}
    record["launches"] = sum(sum((s.get("launches") or {}).values())
                             for s in scenarios.values())
    record["all_pass"] = (bool(record["checks"])
                          and all(record["checks"].values())
                          and (args.scenario is not None
                               or len(scenarios) == 4))
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print(f"\n[5/5] checks: "
          + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                     for k, v in record["checks"].items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, "
            f"{record['wall_s']}s)", flush=True)
    # _exit, not sys.exit: probe-driver daemon threads racing
    # interpreter teardown must not turn a written verdict into a crash
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
