"""Goodput ledger and efficiency watchdog on the card, end to end →
artifacts/efficiency_cuda.json.

The port's counterpart of ``scripts/bench_efficiency.py``: real
two-replica fleets of the port (``cuda_harness.Fleet``: supervisor +
``python -m routest_tpu_torch.serve`` replicas on the card + in-process
gateway, live traffic where the scenario needs metric flips) under
open-loop ``/api/predict_eta_batch`` load, every replica's efficiency
watchdog pinned to the port's own card curve
(``artifacts/serving_kernel_cuda.json``, ``status == "pinned"``). Two
injected efficiency regressions — each invisible to latency SLOs at
this load, every request still a healthy 200 —

- ``device_slowdown`` — one replica rolled onto
  ``device.compute:latency=1.0/400`` (each launch 400 ms slower);
- ``padding_blowup`` — one replica rolled onto
  ``RTPU_BATCH_BUCKETS=4096`` (every 8-row launch pays a 4096-row
  bucket), with the bucket graphs on, as a default replica has them —

must each page the efficiency SLO within ``DETECT_BOUND_S`` with a
flight-recorder bundle naming the program, replica and bucket and
embedding the expected-vs-measured curve (:func:`judge_efficiency_bundle`,
the JAX script's judge). ``clean``: across ≥ 1 metric flip and ≥ 1
verified model swap ZERO efficiency pages, both watchdogs armed on the
pinned curve, the families on both tiers' timelines, the gateway's
rollup counting the goodput. ``overhead``: the always-on ledger's p95
cost (``RTPU_EFF=0`` against on, everything else off, best of both
orders) within the ≤ 5 % budget (2 ms floor).

The open-loop load runs from sender processes of their own
(:func:`cuda_harness.run_open_loop_process`), one run through each
scenario; its pace is recorded (no check reads its latency). The record
holds the JAX record's checks with their bounds, the fused launches the
replicas made, the card's name and power limit. ``--cpu`` serves the
replicas on the CPU for a rehearsal (the card's curve then pins
nothing: ``clean`` fails there); without a card and without ``--cpu``
the script exits 2.

Usage: python3 scripts/bench_efficiency_cuda.py [--quick] [--cpu]
       [--out artifacts/efficiency_cuda.json] [--cache-dir DIR]
       [--scenario NAME]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

# The JAX script's constants (bench_efficiency.py:49-70).
DETECT_BOUND_S = 120.0
EFF_ENV = {
    "RTPU_EFF": "1",
    "RTPU_EFF_WATCHDOG": "1",
    "RTPU_EFF_TICK_S": "1.0",
    "RTPU_EFF_WINDOW_S": "15",
    "RTPU_EFF_MIN_ROWS": "64",
    "RTPU_EFF_AFTER": "3",
    "RTPU_EFF_MIN_RATIO": "0.02",
    "RTPU_EFF_MAX_WASTE": "0.9",
    "RTPU_EFF_FAST_S": "10",
    "RTPU_EFF_SLOW_S": "30",
}
BATCH_ROWS = 8           # full bucket-8 launches: clean waste ≈ 0
OVERHEAD_PCT = 5.0
OVERHEAD_FLOOR_MS = 2.0
SLOWDOWN_OVERLAY = {"RTPU_CHAOS_SPEC": "device.compute:latency=1.0/400",
                    "RTPU_CHAOS_SEED": "7"}
PADDING_OVERLAY = {"RTPU_BATCH_BUCKETS": "4096"}
PROGRAMS = ("eta_score", "route_solve", "dispatch_solve", "dispatch_reopt")
# One open-loop run through a scenario, stopped at its end.
LOAD_SPAN_S = 900.0


def open_loop_batch(base: str, rate: float, duration_s: float, stop=None,
                    salt: int = 0, started=None):
    """Open-loop ``predict_eta_batch`` load from sender processes of
    their own, every row unique (cached rows are goodput the device
    never pays for) → records."""
    from routest_tpu_torch.loadgen import (PlannedRequest, RateCurve,
                                           paced_schedule)

    offsets = paced_schedule(RateCurve.constant(rate), duration_s)
    requests = [PlannedRequest(
        method="POST", path="/api/predict_eta_batch",
        body={"items": [
            {"summary": {"distance": 3000 + salt + i * BATCH_ROWS + j},
             "weather": "Sunny", "traffic": "Medium", "driver_age": 33,
             "pickup_time": "2026-08-05T18:00:00"}
            for j in range(BATCH_ROWS)]},
        route="predict_eta_batch") for i in range(len(offsets))]
    return harness.run_open_loop_process(
        [base], offsets, requests, workers=8, timeout=30.0, stop=stop,
        started=started)[0]


def replica_efficiency(port: int) -> dict:
    return harness.fetch(f"http://127.0.0.1:{port}/api/efficiency",
                         timeout=30)


def wait_for_efficiency_page(port: int, bound_s: float) -> dict:
    """Poll one replica's watchdog until the efficiency SLO pages (each
    poll of an armed watchdog also runs a comparison tick)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound_s:
        try:
            wd = replica_efficiency(port).get("watchdog") or {}
        except OSError:
            wd = {}
        if (wd.get("pages") or 0) >= 1:
            return {"paged": True,
                    "detect_s": round(time.monotonic() - t0, 2),
                    "verdicts": wd.get("verdicts"),
                    "last_bundle": wd.get("last_bundle")}
        time.sleep(1.0)
    return {"paged": False, "detect_s": None}


def efficiency_bundles(workers_dir: str):
    """Replica-side flight-recorder bundles of efficiency pages."""
    out = []
    if not os.path.isdir(workers_dir):
        return out
    for name in sorted(os.listdir(workers_dir)):
        if "efficiency" not in name:
            continue
        bundle = os.path.join(workers_dir, name)
        try:
            with open(os.path.join(bundle,
                                   "efficiency_evidence.json")) as f:
                evidence = json.load(f)
            with open(os.path.join(bundle, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        out.append({"name": name, "evidence": evidence,
                    "manifest_reason": manifest.get("reason")})
    return out


def judge_efficiency_bundle(bundles, faulty_label: str,
                            check_prefix: str) -> dict:
    """An efficiency bundle must name the program, replica and bucket
    and embed the expected-vs-measured curve with the offending bucket
    measured live (the JAX script's judge)."""
    for b in bundles:
        ev = b["evidence"]
        if ev.get("replica") != faulty_label:
            continue
        if not str(ev.get("check", "")).startswith(check_prefix):
            continue
        curve = ev.get("expected_vs_measured") or []
        by_bucket = {row.get("bucket"): row for row in curve}
        offending = by_bucket.get(ev.get("bucket"))
        named = (ev.get("program") in PROGRAMS
                 and ev.get("bucket") is not None)
        embedded = (bool(curve)
                    and all(r.get("expected_rows_per_s") for r in curve)
                    and offending is not None
                    and offending.get("measured_rows_per_s") is not None)
        if named and embedded:
            return {"ok": True, "bundle": b["name"],
                    "program": ev["program"], "bucket": ev["bucket"],
                    "check": ev["check"],
                    "curve_points": len(curve),
                    "offending_bucket": offending}
    return {"ok": False,
            "bundles_seen": [b["name"] for b in bundles]}


def clean_checks(flips, swaps_accepted, per_replica, gw_eff,
                 timeline_replica, timeline_gateway, bundles) -> dict:
    """The JAX script's ``clean`` checks on what the scenario read."""
    fleet = gw_eff.get("fleet", {})
    return {
        "metric_flip_ge_1": flips >= 1,
        "verified_swap_ge_1": swaps_accepted >= 1,
        "watchdogs_armed_and_pinned": all(
            r["armed"] and r["status"] == "pinned"
            for r in per_replica.values()),
        "ledger_counted_device_rows": all(
            r["eta_rows"] > 0 for r in per_replica.values()),
        "zero_efficiency_pages": (
            all((r["pages"] or 0) == 0 for r in per_replica.values())
            and not bundles),
        "all_verdicts_pass": all(
            v == "pass"
            for r in per_replica.values()
            for v in (r["verdicts"] or {}).values()),
        "fleet_rollup_counts_goodput": (
            (fleet.get("programs", {}).get("eta_score", {}).get("rows")
             or 0) > 0 and not fleet.get("degraded")),
        "timeline_family_visible_both_tiers": bool(
            timeline_replica and timeline_gateway),
    }


def fault_checks(page, bundle, healthy_pages) -> dict:
    """The JAX script's fault-scenario checks."""
    return {
        "detected_and_paged": bool(page["paged"]),
        "within_bound": bool(page["paged"]
                             and page["detect_s"] <= DETECT_BOUND_S),
        "bundle_names_program_replica_bucket": bundle["ok"],
        "healthy_replica_zero_pages": all(
            (v or 0) == 0 for v in healthy_pages.values()),
    }


def overhead_ok(p_off: float, p_on: float) -> bool:
    """The ledger's p95 cost within the budget, or within the noise
    floor."""
    overhead_pct = (p_on - p_off) / p_off * 100.0
    return overhead_pct <= OVERHEAD_PCT or p_on - p_off <= OVERHEAD_FLOOR_MS


def _timeline_has_efficiency(base: str) -> bool:
    try:
        tl = harness.fetch(f"{base}/api/timeline?family=rtpu_efficiency",
                           timeout=30)
    except OSError:
        return False
    return "rtpu_efficiency_rows_total" in json.dumps(tl)


def _fleet_metrics(fleet):
    try:
        return fleet.metrics()
    except OSError:
        return {}


class _Load:
    """One open-loop batch run through a scenario, from its own sender
    processes; ``stop()`` ends it and returns its summary with pace."""

    def __init__(self, base: str, rate: float) -> None:
        self.stop_event = threading.Event()
        self.started = threading.Event()
        self.summary: dict = {}

        def run():
            from routest_tpu_torch.loadgen import summarize

            try:
                records = open_loop_batch(base, rate, LOAD_SPAN_S,
                                          stop=self.stop_event,
                                          started=self.started)
            except Exception as e:
                self.summary = {"error": f"{type(e).__name__}: {e}"[:160]}
                self.started.set()
                return
            span = max((r.offset_s for r in records), default=0.0) or 1.0
            rep = summarize(records, span, len(records))
            self.summary = {"sent": rep["sent"], "ok": rep["ok"],
                            "errors": rep["errors"],
                            "latency": rep["latency"],
                            "pace": harness.pace_check(rep)}

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        self.started.wait(timeout=300)

    def stop(self) -> dict:
        self.stop_event.set()
        self.thread.join(timeout=60)
        return self.summary


# ── scenarios ────────────────────────────────────────────────────────


def scenario_clean(extract, args) -> dict:
    work = tempfile.mkdtemp(prefix="efficiency-clean-")
    out: dict = {"scenario": "clean"}
    fleet = harness.Fleet(live=True, extract=extract,
                          cache_dir=args.cache_dir, work_dir=work,
                          device=args.device)
    load = None
    try:
        metrics0 = _fleet_metrics(fleet)
        fleet.start_probe_drivers()
        load = _Load(fleet.base, args.rate)
        # A verified model swap mid-run (×(1 + 1e-4), within the gate),
        # landed by both replicas' reload watchers.
        harness.map_artifact(fleet.model_path, fleet.model_path,
                             lambda x: x * (1.0 + 1e-4))
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

        def fleet_epoch() -> int:
            return max(harness.fetch(f"http://127.0.0.1:{p}/api/live",
                                     timeout=30).get("epoch", 0)
                       for p in fleet.ports)

        epoch0 = fleet_epoch()
        deadline = time.time() + (90 if args.quick else 180)
        flips = 0
        while time.time() < deadline:
            flips = fleet_epoch() - epoch0
            if flips >= 1 and swaps_accepted() >= 2:
                break
            time.sleep(1.0)
        out["swaps_accepted"] = swaps_accepted()
        out["metric_flips"] = flips
        time.sleep(6.0)     # more watchdog rounds under load, post-flip

        per_replica = {}
        for port in fleet.ports:
            snap = replica_efficiency(port)
            wd = snap.get("watchdog") or {}
            eta = snap["ledger"]["programs"]["eta_score"]
            per_replica[port] = {
                "armed": wd.get("armed"), "status": wd.get("status"),
                "pages": wd.get("pages"), "verdicts": wd.get("verdicts"),
                "eta_rows": eta["rows"], "eta_calls": eta["calls"],
                "waste_fraction": eta["waste_fraction"],
            }
        out["replicas"] = per_replica
        gw_eff = harness.fetch(f"{fleet.base}/api/efficiency", timeout=30)
        out["fleet_rollup"] = gw_eff.get("fleet")
        out["timeline_replica"] = _timeline_has_efficiency(
            f"http://127.0.0.1:{fleet.ports[0]}")
        out["timeline_gateway"] = _timeline_has_efficiency(fleet.base)
        bundles = efficiency_bundles(fleet.env["RTPU_RECORDER_DIR"])
        out["efficiency_bundles"] = [b["name"] for b in bundles]
        out["checks"] = clean_checks(
            flips, out["swaps_accepted"], per_replica, gw_eff,
            out["timeline_replica"], out["timeline_gateway"], bundles)
        out["launches"] = harness.launch_delta(metrics0,
                                               _fleet_metrics(fleet))
    finally:
        if load is not None:
            out["load"] = load.stop()
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    out["pass"] = all(out["checks"].values())
    return out


def scenario_fault(name, extract, args, *, overlay: dict,
                   check_prefix: str) -> dict:
    """Boot → healthy baseline under load → roll one replica onto the
    degrading overlay → efficiency page within the bound → a bundle
    naming program, replica and bucket with the curve embedded."""
    work = tempfile.mkdtemp(prefix=f"efficiency-{name}-")
    out: dict = {"scenario": name}
    fleet = harness.Fleet(live=False, extract=extract,
                          cache_dir=args.cache_dir, work_dir=work,
                          device=args.device)
    load = None
    try:
        metrics0 = _fleet_metrics(fleet)
        load = _Load(fleet.base, args.rate)
        # Healthy baseline: both watchdogs armed, device rows flowing
        # (the evidence floor is met before the fault lands).
        baseline_deadline = time.time() + (45 if args.quick else 90)
        while time.time() < baseline_deadline:
            snaps = [replica_efficiency(p) for p in fleet.ports]
            if all((s.get("watchdog") or {}).get("armed")
                   and s["ledger"]["programs"]["eta_score"]["rows"] >= 64
                   for s in snaps):
                break
            time.sleep(1.0)
        out["baseline"] = {
            p: {"armed": (s.get("watchdog") or {}).get("armed"),
                "status": (s.get("watchdog") or {}).get("status"),
                "pages": (s.get("watchdog") or {}).get("pages"),
                "eta_rows": s["ledger"]["programs"]["eta_score"]["rows"]}
            for p, s in zip(fleet.ports, snaps)}

        victim = fleet.replica_rids()[0]
        t_fault = time.time()
        faulty_rid = fleet.inject_replacement(victim, dict(overlay),
                                              version=f"v-{name}")
        faulty_port = fleet.ports[-1]
        faulty_label = f"{socket.gethostname()}:{faulty_port}"
        healthy_ports = [p for p in fleet.ports if p != faulty_port]
        out.update({"victim": victim, "faulty_rid": faulty_rid,
                    "faulty_port": faulty_port,
                    "faulty_label": faulty_label,
                    "inject_wall_s": round(time.time() - t_fault, 1)})
        try:
            health = harness.fetch(
                f"http://127.0.0.1:{faulty_port}/api/health", timeout=30)
            # the faulty replica's scorer: kernel, buckets, graphs
            out["faulty_replica_serving"] = ((health.get("checks") or {})
                                             .get("model") or {}).get(
                                                 "scoring")
        except OSError:
            out["faulty_replica_serving"] = None

        page = wait_for_efficiency_page(faulty_port, DETECT_BOUND_S)
        out["page"] = page
        out["detect_bound_s"] = DETECT_BOUND_S
        deadline = time.monotonic() + 30.0
        while True:
            bundles = efficiency_bundles(fleet.env["RTPU_RECORDER_DIR"])
            out["bundle"] = judge_efficiency_bundle(
                bundles, faulty_label, check_prefix)
            if out["bundle"]["ok"] or time.monotonic() >= deadline:
                break
            time.sleep(1.0)
        healthy = {p: (replica_efficiency(p).get("watchdog") or {})
                   for p in healthy_ports}
        out["healthy_pages"] = {p: w.get("pages")
                                for p, w in healthy.items()}
        out["checks"] = fault_checks(page, out["bundle"],
                                     out["healthy_pages"])
        out["launches"] = harness.launch_delta(metrics0,
                                               _fleet_metrics(fleet))
    finally:
        if load is not None:
            out["load"] = load.stop()
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    out["pass"] = all(out["checks"].values())
    return out


def _load_test():
    spec = importlib.util.spec_from_file_location(
        "rtpu_load_test_cuda", os.path.join(REPO, "scripts",
                                            "load_test_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_mode(lt, device: str, env_overrides: dict, threads: int,
             requests: int, batch_size: int, repeats: int) -> dict:
    """One server of the port on ``device`` with ``env_overrides``:
    ``bench_obs_overhead.py``'s protocol (a warm-up sweep, best of
    ``repeats`` closed-loop phases by predict p95, best batch
    preds/s)."""
    port = harness.free_port()
    env = harness.server_env(
        device, PORT=str(port),
        RTPU_RECORDER_DIR=tempfile.mkdtemp(prefix="obs-bench-"))
    env.update(env_overrides)
    proc = subprocess.Popen([sys.executable, "-m", "routest_tpu_torch.serve"],
                            env=env, cwd=REPO)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 300
        while True:
            try:
                if lt._get(base, "/api/ping", timeout=2).get("ok"):
                    break
            except Exception:
                pass
            if proc.poll() is not None:
                raise RuntimeError("server process died during boot")
            if time.time() > deadline:
                raise RuntimeError("server never became ready")
            time.sleep(0.5)
        warm = lt.PersistentPoster(base)
        try:
            for _ in range(3):
                warm.post("/api/predict_eta",
                          {"summary": {"distance": 10_000}})
        finally:
            warm.close()
        best, errors = None, 0
        for _ in range(max(1, repeats)):
            report, errs = lt.run_load([base], threads, requests)
            errors += len(errs)
            eta = report.get("predict_eta", {})
            if best is None or (eta.get("p95_ms") or 1e9) < \
                    (best["predict_eta"].get("p95_ms") or 1e9):
                best = {"predict_eta": eta, "rps": report.get("rps")}
        out = {**best, "errors": errors, "runs": max(1, repeats)}
        if batch_size > 0:
            batch_best = None
            for _ in range(max(1, repeats)):
                batch, berr = lt.run_batch_load([base], 2, 8, batch_size)
                out["errors"] += len(berr)
                if batch_best is None or (batch.get("preds_per_s") or 0) \
                        > (batch_best.get("preds_per_s") or 0):
                    batch_best = {k: batch.get(k) for k in
                                  ("preds_per_s", "p50_ms", "p95_ms")}
            out["predict_eta_batch"] = batch_best
        try:
            out["launches"] = int(sum(
                s["value"] for s in lt._get(base, "/api/metrics").get(
                    "registry", {}).get("rtpu_fused_launches",
                                        {}).get("series", ())))
        except Exception:
            out["launches"] = 0
        return out
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def scenario_overhead(args) -> dict:
    out: dict = {"scenario": "overhead"}
    lt = _load_test()
    threads = 4 if args.quick else 8
    requests = 20 if args.quick else 40
    repeats = 2 if args.quick else 3
    base_off = {"RTPU_OBS_TRACE": "0", "RTPU_RECORDER": "0",
                "RTPU_SLO": "0", "RTPU_TIMELINE": "0",
                "RTPU_TAIL_SAMPLE": "0"}
    modes = (
        ("ledger_off", dict(base_off, RTPU_EFF="0")),
        ("ledger_on", dict(base_off, RTPU_EFF="1", RTPU_EFF_TICK_S="1.0")),
    )
    results: dict = {}
    launches = 0
    for order in (modes, tuple(reversed(modes))):
        for mode, env in order:
            r = run_mode(lt, args.device, env, threads, requests,
                         batch_size=512, repeats=repeats)
            launches += r.pop("launches", 0)
            prev = results.get(mode)
            if prev is not None and \
                    (prev["predict_eta"].get("p95_ms") or 1e9) < \
                    (r["predict_eta"].get("p95_ms") or 1e9):
                r["predict_eta"] = prev["predict_eta"]
            results[mode] = r
    p_off = results["ledger_off"]["predict_eta"].get("p95_ms")
    p_on = results["ledger_on"]["predict_eta"].get("p95_ms")
    ok = overhead_ok(p_off, p_on)
    out.update({
        "p95_off_ms": p_off, "p95_on_ms": p_on,
        "p95_overhead_pct": round((p_on - p_off) / p_off * 100.0, 2),
        "budget_pct": OVERHEAD_PCT,
        "noise_floor_ms": OVERHEAD_FLOOR_MS,
        "modes": {m: r.get("predict_eta") for m, r in results.items()},
        "errors": {m: r.get("errors") for m, r in results.items()},
        "launches": {"servers": launches},
    })
    out["checks"] = {"ledger_within_p95_budget": bool(ok)}
    out["pass"] = bool(ok)
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="smaller extract + shorter phases")
    parser.add_argument("--cpu", action="store_true",
                        help="serve the replicas on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--nodes", type=int, default=6000)
    parser.add_argument("--rate", type=float, default=4.0,
                        help="predict_eta_batch requests/s "
                             f"(×{BATCH_ROWS} rows each)")
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "efficiency_cuda"))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "efficiency_cuda.json; build/"
                             "efficiency_cpu.json with --cpu)")
    parser.add_argument("--scenario", default=None,
                        help="run one scenario (debug)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_efficiency_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "efficiency_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "efficiency_cpu.json")
    if args.quick:
        args.nodes = min(args.nodes, 4000)
    os.makedirs(args.cache_dir, exist_ok=True)
    os.environ["ROUTEST_HIER_CACHE"] = os.path.join(args.cache_dir, "hier")
    # every replica (and its rollout successor) inherits the knobs
    os.environ.update(EFF_ENV)

    t0 = time.time()
    print(f"[1/6] extract + overlay cache ({args.nodes:,} nodes)…",
          flush=True)
    extract = harness.build_extract(args.nodes, args.cache_dir)

    scenarios: dict = {}
    plan = [
        ("clean", lambda: scenario_clean(extract, args)),
        ("device_slowdown", lambda: scenario_fault(
            "device_slowdown", extract, args, overlay=SLOWDOWN_OVERLAY,
            check_prefix="throughput")),
        ("padding_blowup", lambda: scenario_fault(
            "padding_blowup", extract, args, overlay=PADDING_OVERLAY,
            check_prefix="padding")),
        ("overhead", lambda: scenario_overhead(args)),
    ]
    for i, (name, run) in enumerate(plan):
        if args.scenario and name != args.scenario:
            continue
        print(f"[{i + 2}/6] scenario {name}…", flush=True)
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
              f"{json.dumps(scenarios[name].get('checks'))} "
              f"{scenarios[name].get('error', '')}", flush=True)

    def launches_of(s):
        got = s.get("launches") or {}
        return sum(got.values()) if isinstance(got, dict) else int(got)

    record = {
        "generated_unix": int(t0),
        "card": harness.card_identity(args.device),
        "host": {"cpus": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "config": {
            "nodes": args.nodes, "rate_rps": args.rate,
            "batch_rows": BATCH_ROWS,
            "detect_bound_s": DETECT_BOUND_S,
            "eff_env": EFF_ENV,
            "kernel_artifact": os.environ.get(
                "RTPU_EFF_KERNEL_ARTIFACT",
                "artifacts/serving_kernel_cuda.json"),
            "overhead_budget_pct": OVERHEAD_PCT,
            "overhead_noise_floor_ms": OVERHEAD_FLOOR_MS,
            "quick": bool(args.quick),
        },
        "scenarios": scenarios,
    }
    if args.scenario:
        record["partial"] = f"--scenario {args.scenario} (debug run)"
    record["checks"] = {name: bool(s.get("pass"))
                        for name, s in scenarios.items()}
    record["launches"] = sum(launches_of(s) for s in scenarios.values())
    record["all_pass"] = (bool(record["checks"])
                          and all(record["checks"].values())
                          and (args.scenario is not None
                               or len(scenarios) == 4))
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print(f"\n[6/6] checks: "
          + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                     for k, v in record["checks"].items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, "
            f"{record['wall_s']}s)", flush=True)
    # _exit, not sys.exit: probe-driver daemon threads racing
    # interpreter teardown must not turn a written verdict into a crash
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
