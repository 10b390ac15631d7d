"""Rollout bench on the card: safe change delivery, measured end to end.

The port's counterpart of ``scripts/bench_rollout.py``, against a REAL
fleet of the port (supervisor + ``python -m routest_tpu_torch.serve``
replicas scoring through ``fused_eta.cu`` on the card + in-process
gateway + the port's rollout controller) under open-loop loadgen
traffic:

- ``hot_swap`` — ≥ 3 consecutive verified model hot-swaps land on a
  serving replica under load with ZERO client 5xx and the SLO engine
  never paging; then three bad artifacts (corrupt bytes, NaN weights,
  wildly divergent weights) are each REJECTED by the golden-batch gate
  with the old model still serving (generation unchanged).
- ``boot_crash`` / ``corrupt_artifact`` / ``slo_regression`` — three
  distinct bad deploys rolled out through the canary state machine,
  each auto-rolled back (crash-loop watch, ``/api/health`` verify gate,
  canary-vs-baseline SLO comparison), with blast radius bounded and the
  rollback decision + offending version captured in a flight-recorder
  bundle.
- ``rollout_good`` — a healthy new version canaries, bakes clean, and
  promotes across the fleet with zero client 5xx.

The artifacts are made by :class:`ModelForge` with the port's RTPU1
reader and writer (``train/checkpoint.py``): the same bytes the JAX
script's forge writes. Each open-loop run sends from processes of its
own (:func:`cuda_harness.run_open_loop_process`) and a scenario whose
generator lagged (``send_delay`` p99 over the run's latency p50) fails.
The record (``artifacts/rollout_cuda.json``) holds every check of the
JAX script with its bound, the fused launches the replicas made, the
card's name and power limit, and the host's cores.

Placement: every replica serves on the one card (``--cpu``: on the CPU,
device-blind, for a rehearsal; without a card and without ``--cpu`` the
script exits 2 and names the missing device).

Usage: python3 scripts/bench_rollout_cuda.py [--quick] [--cpu]
       [--scenarios hot_swap boot_crash corrupt_artifact
        slo_regression rollout_good]
       [--out artifacts/rollout_cuda.json]
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
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

BASE_MODEL = harness.MODEL


def _get_json(base, path, timeout=15.0):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return json.loads(r.read())
    except Exception:
        return {}


def _write_bytes_atomic(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class ModelForge:
    """Builds the good/bad artifact variants the scenarios deploy, from
    the repo's real trained model, through the port's RTPU1 reader and
    writer."""

    def __init__(self, workdir: str) -> None:
        self.workdir = workdir

    def write(self, name: str, fn) -> str:
        return harness.map_artifact(BASE_MODEL,
                                    os.path.join(self.workdir, name), fn)

    def perturbed(self, name: str, scale: float) -> str:
        """A plausible retrain: tiny uniform weight scale."""
        return self.write(name, lambda x: x * (1.0 + scale))

    def nan(self, name: str) -> str:
        import numpy as np

        return self.write(name, lambda x: np.full_like(x, np.nan))

    def divergent(self, name: str) -> str:
        """Corrupted-export proxy: loads, self-checks finite, but the
        golden batch diverges by ~1e6 minutes."""
        return self.write(name, lambda x: x + 1.0e6)

    def corrupt(self, name: str) -> str:
        path = os.path.join(self.workdir, name)
        _write_bytes_atomic(path, b"garbage, not an artifact\n" * 64)
        return path


class SloWatcher:
    """Samples the gateway SLO engine while a scenario runs — the
    'never paged' witness."""

    def __init__(self, gw) -> None:
        self.gw = gw
        self.states = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self.gw.slo is not None:
                self.gw.slo.tick()
                self.states.append(self.gw.slo.worst_state())
            self._stop.wait(0.5)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def paged(self) -> bool:
        return "page" in self.states


class LoadArm:
    """Open-loop loadgen traffic running beside a scenario, from sender
    processes of its own: started, then stopped once the scenario's
    control action settles (the schedule is sized generously; unsent
    arrivals are simply not offered)."""

    def __init__(self, base: str, rate: float, duration_s: float,
                 seed: int, zipf_s: float, workers: int) -> None:
        from routest_tpu_torch.loadgen import (RateCurve, ZipfODWorkload,
                                               paced_schedule)

        self.offsets = paced_schedule(RateCurve.constant(rate), duration_s)
        self.requests = ZipfODWorkload(
            s=zipf_s, seed=seed).sequence(len(self.offsets))
        self.base = base
        self.workers = workers
        self.stop = threading.Event()
        self.started = threading.Event()
        self.records = []
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            self.records, _ = harness.run_open_loop_process(
                [self.base], self.offsets, self.requests,
                workers=self.workers, timeout=35.0, stop=self.stop,
                started=self.started)
        except Exception as e:      # reported by report()
            self.error = f"{type(e).__name__}: {e}"

    def __enter__(self):
        # the scenario acts under load: wait until the senders are up
        # and the schedule has begun
        self._thread.start()
        self.started.wait(timeout=300)
        time.sleep(harness.START_RUNWAY_S)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self._thread.join(timeout=90)

    def report(self) -> dict:
        from routest_tpu_torch.loadgen import summarize

        if self.error is not None:
            raise RuntimeError(f"the load arm failed: {self.error}")
        return summarize(self.records, max(
            (r.offset_s for r in self.records), default=0.0) or 1.0,
            len(self.records))


def boot_fleet(args, n: int, recorder_dir: str, model_path: str,
               reload_sec: float = 0.0):
    """→ (supervisor, gateway, base_url). ``n`` real serving workers on
    version ``v1``, on the card."""
    from routest_tpu_torch.core.config import FleetConfig, RecorderConfig
    from routest_tpu_torch.obs.recorder import (FlightRecorder,
                                                configure_recorder)
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    configure_recorder(FlightRecorder(RecorderConfig(
        dir=os.path.join(recorder_dir, "gateway"), min_interval_s=0.0)))
    env = harness.server_env(
        args.device, ROUTEST_MESH="0", ROUTEST_WARM_BUCKETS="0",
        ETA_MODEL_PATH=model_path, RTPU_VERSION="v1",
        RTPU_RECORDER_DIR=os.path.join(recorder_dir, "workers"),
        RTPU_RECORDER_MIN_INTERVAL_S="0")
    if reload_sec > 0:
        env["ROUTEST_RELOAD_SEC"] = str(reload_sec)
    ports = [harness.free_port() for _ in range(n)]
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0, version="v1")
    sup.start()
    if not sup.ready(timeout=300):
        sup.drain(timeout=10)
        raise RuntimeError("fleet workers never became ready")
    cfg = FleetConfig(hedge=False, eject_after=3, cooldown_s=1.0,
                      max_inflight=32, queue_depth=64)
    gw = Gateway([("127.0.0.1", p) for p in ports], cfg, supervisor=sup,
                 version="v1")
    httpd = gw.serve("127.0.0.1", 0)
    return sup, gw, f"http://127.0.0.1:{httpd.server_address[1]}"


def shutdown_fleet(sup, gw):
    from routest_tpu_torch.obs.recorder import configure_recorder

    try:
        gw.drain(timeout=5)
    finally:
        sup.drain(timeout=20)
        configure_recorder(None)


def measure_capacity(base: str, seed: int, zipf_s: float,
                     seconds: float) -> float:
    from routest_tpu_torch.loadgen import (KeepAliveClient, ZipfODWorkload,
                                           run_closed_loop, summarize)

    workload = ZipfODWorkload(s=zipf_s, seed=seed)
    client = KeepAliveClient(base, timeout=120.0)
    try:
        for req in workload.sequence(4):
            client.send(req)          # warm the buckets + the cache path
    finally:
        client.close()
    records = run_closed_loop([base], workload.sequence(100_000),
                              workers=16, duration_s=seconds)
    rep = summarize(records, seconds, len(records), loop="closed")
    return max(5.0, rep["achieved_rps"])


def _bundle_manifest(bundle_path):
    if not bundle_path:
        return None
    try:
        with open(os.path.join(bundle_path, "manifest.json")) as f:
            manifest = json.load(f)
        return {"reason": manifest.get("reason"),
                "detail": manifest.get("detail"),
                "counts": manifest.get("counts")}
    except OSError:
        return None


def _swap_counts(base: str) -> dict:
    """rtpu_model_swaps_total by result, summed over replicas (read
    through the gateway's replica-metrics passthrough)."""
    payload = _get_json(base, "/api/metrics?replicas=1", timeout=30.0)
    out = {"accepted": 0, "rejected": 0}
    for rep in (payload.get("replica_metrics") or {}).values():
        fam = (rep.get("registry") or {}).get("rtpu_model_swaps_total")
        for series in (fam or {}).get("series", ()):
            result = series["labels"].get("result")
            if result in out:
                out[result] += int(series["value"])
    return out


def _launches(base: str) -> dict:
    return _get_json(base, "/api/metrics?replicas=1", timeout=30.0)


def _brief_load(report: dict) -> dict:
    out = {k: report[k] for k in ("offered", "sent", "ok", "shed",
                                  "errors", "achieved_rps")
           if k in report}
    out["latency"] = report.get("latency")
    out["send_delay"] = report.get("send_delay")
    return out


# ── scenario: verified hot-swap under load ───────────────────────────

def scenario_hot_swap(args, forge: ModelForge) -> dict:
    recorder_dir = tempfile.mkdtemp(prefix="rollout-pm-")
    live_path = os.path.join(forge.workdir, "live.msgpack")
    shutil.copyfile(BASE_MODEL, live_path)
    sup, gw, base = boot_fleet(args, n=1, recorder_dir=recorder_dir,
                               model_path=live_path,
                               reload_sec=args.reload_sec)
    try:
        capacity = measure_capacity(base, args.seed, args.zipf_s,
                                    args.calibrate_s)
        time.sleep(harness.SETTLE_S)
        rate = max(4.0, capacity * 0.4)
        metrics0 = _launches(base)

        def generation() -> int:
            return int(((_get_json(base, "/api/version").get("model")
                         or {}).get("generation")) or -1)

        gen0 = generation()
        swaps = []
        with SloWatcher(gw) as slo, \
                LoadArm(base, rate, args.load_s, args.seed, args.zipf_s,
                        args.workers) as load:
            time.sleep(2.0)
            # ≥3 good swaps: plausible retrains, each verified against
            # the live model's golden outputs before going live.
            for k in range(1, args.swaps + 1):
                src = forge.perturbed(f"good_{k}.msgpack", 1e-4 * k)
                before = generation()
                t0 = time.perf_counter()
                shutil.copyfile(src, f"{live_path}.stage")
                os.replace(f"{live_path}.stage", live_path)
                deadline = time.time() + 30
                while time.time() < deadline and generation() <= before:
                    time.sleep(0.2)
                swaps.append({"swap": k,
                              "generation": generation(),
                              "landed": generation() > before,
                              "landed_s": round(time.perf_counter() - t0,
                                                3)})
            # Three bad artifacts: each must be rejected with the old
            # generation still serving.
            rejected = []
            for name, src in (
                    ("corrupt_bytes", forge.corrupt("bad_corrupt.bin")),
                    ("nan_weights", forge.nan("bad_nan.msgpack")),
                    ("divergent_weights",
                     forge.divergent("bad_div.msgpack"))):
                before_gen = generation()
                before_rejected = _swap_counts(base)["rejected"]
                shutil.copyfile(src, f"{live_path}.stage")
                os.replace(f"{live_path}.stage", live_path)
                deadline = time.time() + 20
                now_rejected = before_rejected
                while time.time() < deadline \
                        and now_rejected <= before_rejected:
                    time.sleep(0.3)
                    now_rejected = _swap_counts(base)["rejected"]
                rejected.append({
                    "artifact": name,
                    "rejected": now_rejected > before_rejected,
                    "generation_unchanged": generation() == before_gen,
                })
            time.sleep(1.0)
        report = load.report()
        pace = harness.pace_check(report)
        counts = _swap_counts(base)
        health = _get_json(base, "/api/health")
        model_ok = ((health.get("checks") or {}).get("model")
                    or {}).get("status") == "ok"
        launches = harness.launch_delta(metrics0, _launches(base))
        out = {
            "capacity_rps_1_replica": round(capacity, 1),
            "offered_rps": round(rate, 1),
            "initial_generation": gen0,
            "good_swaps": swaps,
            "bad_artifacts": rejected,
            "swap_counts": counts,
            "load": _brief_load(report),
            "pace": pace,
            "slo": {"states_seen": sorted(set(slo.states)),
                    "paged": slo.paged()},
            "versions": gw.version_skew(),
            "launches": launches,
        }
        checks = {
            "swaps_ge_3": len(swaps) >= 3,
            "swaps_landed": all(s["landed"] for s in swaps),
            "swaps_accepted": counts["accepted"] >= args.swaps,
            "bad_rejected_ge_3": counts["rejected"] >= 3,
            "bad_rejected_generation_unchanged": all(
                r["rejected"] and r["generation_unchanged"]
                for r in rejected),
            "model_ok": model_ok,
            "zero_5xx": report["errors"] == 0,
            "no_slo_page": not slo.paged(),
        }
        out["checks"] = checks
        out["pass"] = harness.passed(all(checks.values()), pace)
        return out
    finally:
        shutdown_fleet(sup, gw)
        shutil.rmtree(recorder_dir, ignore_errors=True)


# ── canary rollout scenarios ─────────────────────────────────────────

def _rollout_scenario(args, forge: ModelForge, *, version: str,
                      env: dict, expect_state: str, expect_triggers,
                      chaos_spec: str = "", fraction: float = 0.25,
                      bake_s: float = None, blast_check=None,
                      slow_s: float = 0.0) -> dict:
    from routest_tpu_torch import chaos
    from routest_tpu_torch.core.config import RolloutConfig
    from routest_tpu_torch.serve.fleet.rollout import RolloutController

    recorder_dir = tempfile.mkdtemp(prefix="rollout-pm-")
    live_path = os.path.join(forge.workdir, f"base_{version}.msgpack")
    shutil.copyfile(BASE_MODEL, live_path)
    sup, gw, base = boot_fleet(args, n=2, recorder_dir=recorder_dir,
                               model_path=live_path)
    if chaos_spec:
        chaos.configure(chaos.ChaosEngine(spec=chaos_spec,
                                          seed=args.seed))
    try:
        capacity = measure_capacity(base, args.seed, args.zipf_s,
                                    args.calibrate_s)
        time.sleep(harness.SETTLE_S)
        rate = max(4.0, capacity * 0.4)
        # a canary answering in ``slow_s`` holds rate × fraction × slow_s
        # senders at once: the pool is sized to twice that, so the
        # generator keeps its schedule while the canary is slow
        workers = max(args.workers,
                      int(2 * rate * fraction * slow_s) + args.workers)
        metrics0 = _launches(base)
        ctl = RolloutController(sup, gw, RolloutConfig(
            canary_fraction=fraction, canary_replicas=1,
            bake_s=bake_s if bake_s is not None else args.bake_s,
            tick_s=0.25, max_unavailable=1, min_canary_requests=5,
            max_error_rate=0.05, max_error_ratio=3.0,
            latency_threshold_ms=args.latency_ms,
            max_latency_regression=0.25, crash_restarts=2,
            boot_timeout_s=240.0, health_timeout_s=30.0,
            drain_timeout_s=8.0))
        t0 = time.perf_counter()
        with SloWatcher(gw) as slo, \
                LoadArm(base, rate, args.load_s * 3, args.seed,
                        args.zipf_s, workers) as load:
            time.sleep(2.0)
            if not ctl.start(version, env=env):
                raise RuntimeError(f"the rollout of {version} did not "
                                   f"start")
            final = ctl.wait(timeout=600)
            decided_s = time.perf_counter() - t0
            time.sleep(2.0)
        report = load.report()
        pace = harness.pace_check(report)
        snap = ctl.snapshot()
        rollback = next((h for h in snap["history"]
                         if h.get("event") == "rollback"), None)
        with gw._lock:
            fleet_versions = sorted({r.version for r in gw.replicas})
            fleet_size = len(gw.replicas)
        out = {
            "capacity_rps_1_replica": round(capacity, 1),
            "offered_rps": round(rate, 1),
            "senders": workers,
            "version": version,
            "final_state": final,
            "decided_s": round(decided_s, 3),
            "fleet_versions": fleet_versions,
            "fleet_size": fleet_size,
            "rollback": rollback,
            "bundle": _bundle_manifest(snap.get("last_bundle")),
            "last_verdict": snap.get("last_verdict"),
            "load": _brief_load(report),
            "pace": pace,
            "slo": {"states_seen": sorted(set(slo.states)),
                    "paged": slo.paged()},
            "history": snap["history"],
            "launches": harness.launch_delta(metrics0, _launches(base)),
        }
        checks = {"final_state": final == expect_state,
                  "fleet_size_2": fleet_size == 2}
        if expect_state == "rolled_back":
            checks.update({
                "rolled_back": rollback is not None,
                "trigger": bool(rollback and rollback.get("trigger")
                                in expect_triggers),
                "offending_version_named": bool(
                    rollback
                    and rollback.get("offending_version") == version),
                "bundle": out["bundle"] is not None,
                "bundle_reason": bool(out["bundle"] and out["bundle"]
                                      ["reason"] == "rollout_rollback"),
                "fleet_back_on_v1": fleet_versions == ["v1"],
            })
        else:
            checks.update({
                "fleet_on_new_version": fleet_versions == [version],
                "zero_5xx": report["errors"] == 0})
        if blast_check is not None:
            blast = blast_check(report)
            out["blast_radius"] = blast
            checks["blast_radius_bounded"] = blast["bounded"]
        out["checks"] = checks
        out["pass"] = harness.passed(all(checks.values()), pace)
        return out
    finally:
        if chaos_spec:
            chaos.configure(None)
        shutdown_fleet(sup, gw)
        shutil.rmtree(recorder_dir, ignore_errors=True)


def scenario_boot_crash(args, forge: ModelForge) -> dict:
    """The new version's process exits at boot (``replica.boot.<v>``
    chaos, deterministic): the crash-loop watch rolls back before the
    canary ever joins the gateway — client traffic never sees it."""
    return _rollout_scenario(
        args, forge, version="v2-bootcrash",
        env={"RTPU_VERSION": "v2-bootcrash"},
        chaos_spec="replica.boot.v2-bootcrash:error=1.0",
        expect_state="rolled_back",
        expect_triggers={"boot_crash_loop", "boot_timeout"},
        blast_check=lambda rep: {"client_5xx": rep["errors"],
                                 "bounded": rep["errors"] == 0})


def scenario_corrupt_artifact(args, forge: ModelForge) -> dict:
    """The new version points at corrupt model bytes: the worker boots
    (degraded-not-down) but its /api/health model check fails the
    verify gate — rollback before any traffic routes to it."""
    corrupt = forge.corrupt("deploy_corrupt.bin")
    return _rollout_scenario(
        args, forge, version="v3-corrupt",
        env={"RTPU_VERSION": "v3-corrupt", "ETA_MODEL_PATH": corrupt},
        expect_state="rolled_back", expect_triggers={"verify_failed"},
        blast_check=lambda rep: {"client_5xx": rep["errors"],
                                 "bounded": rep["errors"] == 0})


def scenario_slo_regression(args, forge: ModelForge) -> dict:
    """The new version boots healthy but serves with +2.5 s device
    latency (worker-side seeded chaos): only the bake's canary-vs-
    baseline SLO comparison can catch it. Blast radius: the canary
    fraction bounds how much traffic ever saw the slow version — the
    fleet-wide median must stay under the latency threshold."""
    def blast(rep: dict) -> dict:
        lat = rep.get("latency") or {}
        p50 = lat.get("p50_ms")
        return {"p50_ms": p50, "client_5xx": rep["errors"],
                "bounded": bool(p50 is not None
                                and p50 <= args.latency_ms)}

    # Cache off on the bad version: the regression must be visible on
    # every request it serves, not amortized away by the content-
    # addressed cache warming over the Zipf head.
    return _rollout_scenario(
        args, forge, version="v4-slow",
        env={"RTPU_VERSION": "v4-slow",
             "RTPU_CHAOS_SPEC": "device.compute:latency=1.0/2500",
             "RTPU_CHAOS_SEED": str(args.seed),
             "RTPU_FASTLANE_CACHE": "0"},
        expect_state="rolled_back", bake_s=max(args.bake_s * 3, 25.0),
        expect_triggers={"canary_latency", "canary_error_rate",
                         "slo_page"},
        blast_check=blast, slow_s=2.5)


def scenario_rollout_good(args, forge: ModelForge) -> dict:
    """A healthy retrain promotes: canary → clean bake → the whole
    fleet rolls to it, zero client 5xx."""
    v2 = forge.perturbed("deploy_good.msgpack", 2e-4)
    return _rollout_scenario(
        args, forge, version="v2-good",
        env={"RTPU_VERSION": "v2-good", "ETA_MODEL_PATH": v2},
        expect_state="done", expect_triggers=set())


SCENARIOS = {
    "hot_swap": scenario_hot_swap,
    "boot_crash": scenario_boot_crash,
    "corrupt_artifact": scenario_corrupt_artifact,
    "slo_regression": scenario_slo_regression,
    "rollout_good": scenario_rollout_good,
}


def main() -> None:
    from routest_tpu_torch.utils.logging import get_logger

    log = get_logger("routest_tpu_torch.bench_rollout")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="serve every replica on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--zipf-s", type=float, default=1.1)
    parser.add_argument("--workers", type=int, default=48,
                        help="open-loop sender threads")
    parser.add_argument("--swaps", type=int, default=3,
                        help="good hot-swaps to land under load")
    parser.add_argument("--latency-ms", type=float, default=1200.0)
    parser.add_argument("--scenarios", nargs="*", default=None,
                        choices=sorted(SCENARIOS))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "rollout_cuda.json; build/rollout_cpu.json "
                             "with --cpu)")
    args = parser.parse_args()
    args.device = harness.require_card(args.cpu, "bench_rollout_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "rollout_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "rollout_cpu.json")
    if args.quick:
        args.calibrate_s = 3.0
        args.load_s = 45.0
        args.bake_s = 8.0
    else:
        args.calibrate_s = 5.0
        args.load_s = 75.0
        args.bake_s = 12.0
    args.reload_sec = 0.25

    workdir = tempfile.mkdtemp(prefix="rollout-models-")
    forge = ModelForge(workdir)
    results = {}
    try:
        for name in (args.scenarios or list(SCENARIOS)):
            log.info("rollout_scenario_started", scenario=name)
            t0 = time.time()
            try:
                results[name] = SCENARIOS[name](args, forge)
            except Exception as e:
                results[name] = {"error": f"{type(e).__name__}: {e}",
                                 "pass": False}
                log.error("rollout_scenario_failed", scenario=name,
                          error=f"{type(e).__name__}: {e}")
            results[name]["wall_s"] = round(time.time() - t0, 1)
            log.info("rollout_scenario_finished", scenario=name,
                     ok=results[name].get("pass"),
                     wall_s=results[name]["wall_s"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    record = {
        "generated_unix": int(time.time()),
        "card": harness.card_identity(args.device),
        "quick": bool(args.quick),
        "placement": ("every replica on the one card"
                      if args.device == "cuda" else "device-blind, CPU"),
        "loadgen": {"zipf_s": args.zipf_s, "seed": args.seed,
                    "workers": args.workers,
                    "open_loop": "latency measured from intended send "
                                 "time (coordinated-omission-correct)"},
        "scenarios": results,
        "launches": sum(sum((r.get("launches") or {}).values())
                        for r in results.values()),
        "all_pass": all(r.get("pass") for r in results.values()),
    }
    harness.write_record(args.out, record)
    log.info("rollout_written", path=args.out, all_pass=record["all_pass"])
    print(json.dumps({k: (v if k != "scenarios" else {
        n: {kk: vv for kk, vv in s.items()
            if kk in ("pass", "wall_s", "final_state", "rollback",
                      "swap_counts", "blast_radius", "slo", "error",
                      "checks", "pace")}
        for n, s in v.items()}) for k, v in record.items()},
        indent=2, default=str))
    sys.exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
