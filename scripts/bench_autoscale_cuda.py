"""Autoscale bench on the card: SLO survival through a 10× flash crowd.

The port's counterpart of ``scripts/bench_autoscale.py``, end to end: a
REAL fleet of the port (supervisor + ``python -m
routest_tpu_torch.serve`` replicas scoring through ``fused_eta.cu`` on
the card + in-process gateway + autoscaler) is driven by the open-loop
generator (``routest_tpu_torch/loadgen``) through a 10× flash crowd and
a compressed diurnal curve. The record must show

- the autoscaler scaling up during the spike and back down after,
- availability/latency SLOs out of ``page`` at the end of each
  scenario (or recovered within the fast window),
- a bounded shed rate (admission control degrades overload into 429s
  while the fleet grows — never a collapse),
- the same seed reproducing the same offered-load schedule, and
- a closed-loop vs open-loop comparison on the same overload exposing
  the coordinated-omission gap in recorded p99, and
- a generator that kept its pace: each open-loop run sends from a
  process of its own (:func:`cuda_harness.run_open_loop_process`, paced
  as phase 18 paces its generator), 2 s after its calibration, and a
  scenario whose ``send_delay`` p99 exceeds the run's latency p50 is
  recorded ``generator_lagged`` and fails (the closed-vs-open overload
  arm is read over its arrivals before its backlog could hold half the
  senders).

Rates are CALIBRATED, not hardcoded: a short closed-loop phase
measures one replica's capacity ``C`` on this card and host, then the
flash crowd offers ``C/8 → 10×`` (guaranteed overload at the spike) and
the diurnal curve crests at ``1.2 C``. The record holds ``C``, the
card's name and power limit, and the host's cores.

Placement: r0 is slice 0 of the placement plan on the one card; every
replica the autoscaler adds is the plan's growth slice on the same card
(``CUDA_VISIBLE_DEVICES=0``), so the replicas share one H100 and the
host's cores — a grown replica adds a process and a CUDA context, not a
device. ``--cpu`` serves every replica on the CPU, device-blind, for a
rehearsal; without a card and without ``--cpu`` the script exits 2 and
names the missing device.

Usage: python3 scripts/bench_autoscale_cuda.py [--quick] [--seed 42]
       [--scenarios flash_crowd diurnal closed_vs_open] [--cpu]
       [--out artifacts/autoscale_cuda.json]
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

MODEL = harness.MODEL


def boot_fleet(args, autoscale: bool, recorder_dir: str,
               queue_depth: int = 32):
    """→ (supervisor, gateway, autoscaler-or-None, base_url). One real
    serving worker to start, on slice 0 of the placement plan; the
    autoscaler grows it onto the plan's growth slices (the same card).
    Replicas boot without warming every bucket: an elastic boot serves
    as soon as it answers its probe."""
    from routest_tpu_torch.core.config import (AutoscaleConfig, FleetConfig,
                                               RecorderConfig)
    from routest_tpu_torch.obs.recorder import (FlightRecorder,
                                                configure_recorder)
    from routest_tpu_torch.serve.fleet.autoscaler import Autoscaler
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.placement import plan_from_env
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    configure_recorder(FlightRecorder(RecorderConfig(
        dir=os.path.join(recorder_dir, "gateway"), min_interval_s=0.0)))
    # Cross-replica SSE needs the broker (same wiring as ``python -m
    # routest_tpu_torch.serve.fleet``): a tracker tick published on a
    # scaled-up replica must reach subscribers held on r0.
    from routest_tpu_torch.serve.netbus import start_broker

    broker, _ = start_broker()
    env = harness.server_env(
        args.device,
        REDIS_URL=f"tcp://127.0.0.1:{broker.port}",
        ROUTEST_MESH="0",
        ROUTEST_WARM_BUCKETS="0",
        ETA_MODEL_PATH=MODEL,
        RTPU_RECORDER_DIR=os.path.join(recorder_dir, "workers"),
        RTPU_RECORDER_MIN_INTERVAL_S="0")
    plan = plan_from_env(env, replicas=1) if args.device == "cuda" else None
    ports = [harness.free_port()]
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0, placement=plan)
    sup._bench_broker = broker     # torn down in shutdown_fleet
    sup.start()
    if not sup.ready(timeout=300):
        sup.drain(timeout=10)
        broker.shutdown()
        broker.server_close()
        raise RuntimeError("initial fleet worker never became ready")
    cfg = FleetConfig(hedge=False, eject_after=3, cooldown_s=1.0,
                      max_inflight=32, queue_depth=queue_depth)
    gw = Gateway([("127.0.0.1", p) for p in ports], cfg, supervisor=sup)
    if plan is not None:
        s0 = plan.slices[0]
        gw.set_topology("r0", chips=s0.chips, capacity=s0.capacity)
    httpd = gw.serve("127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    scaler = None
    if autoscale:
        # Constructed but NOT started: the calibration phase saturates
        # the 1-replica fleet on purpose, and a live controller would
        # (correctly!) scale against it — scenarios start the ticker
        # once the measured phase begins, so every decision in the
        # history is attributable to the offered scenario load.
        scaler = Autoscaler(sup, gw, AutoscaleConfig(
            enabled=True, min_replicas=1, max_replicas=args.max_replicas,
            tick_s=0.5, up_queue_frac=0.25, up_outstanding=8.0,
            up_burn=6.0, up_stable_ticks=2, up_step=1, up_cooldown_s=8.0,
            down_outstanding=1.0, down_stable_ticks=10, down_step=1,
            down_cooldown_s=10.0, startup_timeout_s=180.0,
            drain_timeout_s=10.0))
    return sup, gw, scaler, base


def shutdown_fleet(sup, gw, scaler):
    from routest_tpu_torch.obs.recorder import configure_recorder

    try:
        if scaler is not None:
            scaler.stop()
        gw.drain(timeout=5)
    finally:
        sup.drain(timeout=20)
        broker = getattr(sup, "_bench_broker", None)
        if broker is not None:
            broker.shutdown()
            broker.server_close()
        configure_recorder(None)


def warm(base: str, workload) -> None:
    from routest_tpu_torch.loadgen import KeepAliveClient

    client = KeepAliveClient(base, timeout=120.0)
    try:
        for req in workload.sequence(4):
            client.send(req)
    finally:
        client.close()


def measure_capacity(base: str, workload, seconds: float) -> float:
    """Closed-loop ceiling of the current (1-replica) fleet in ok-rps —
    the calibration constant every scenario's rates derive from."""
    from routest_tpu_torch.loadgen import run_closed_loop, summarize

    # 32 workers = the gateway's max_inflight: enough closed-loop
    # concurrency to actually saturate the replica (8 workers measured
    # the CLIENT's concurrency limit, ~40% under the true ceiling).
    records = run_closed_loop([base], workload.sequence(100_000),
                              workers=32, duration_s=seconds)
    rep = summarize(records, seconds, len(records), loop="closed")
    return max(5.0, rep["achieved_rps"])


class FleetWatcher:
    """Samples gateway fleet size + SLO state once a second while a
    scenario runs — the replica-count-vs-load timeline the acceptance
    criteria are judged on."""

    def __init__(self, gw) -> None:
        self.gw = gw
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        t0 = time.monotonic()
        while not self._stop.is_set():
            with self.gw._lock:
                live = sum(1 for r in self.gw.replicas if not r.draining)
                draining = sum(1 for r in self.gw.replicas if r.draining)
                queued = self.gw._waiters
                inflight = self.gw._inflight
            slo_state = "n/a"
            if self.gw.slo is not None:
                self.gw.slo.tick()
                slo_state = self.gw.slo.worst_state()
            pending = 0
            if self.gw.autoscaler is not None:
                with self.gw.autoscaler._lock:
                    pending = len(self.gw.autoscaler._pending)
            self.samples.append({
                "t": round(time.monotonic() - t0, 1),
                "replicas": live, "draining": draining,
                "pending": pending, "queued": queued,
                "inflight": inflight, "slo": slo_state,
            })
            self._stop.wait(1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    def max_replicas(self) -> int:
        return max((s["replicas"] for s in self.samples), default=0)

    def slo_states(self) -> list:
        return [s["slo"] for s in self.samples]


def scenario_flash_crowd(args) -> dict:
    """Base → 10× spike → base, autoscaler on. Pure Zipf predict
    traffic so the fast-lane cache sees realistic key skew (hit-rate delta
    recorded from registry snapshots)."""
    from routest_tpu_torch.loadgen import (RateCurve, ZipfODWorkload,
                                           cache_delta, fetch_metrics,
                                           poisson_schedule, summarize,
                                           timeline)

    recorder_dir = tempfile.mkdtemp(prefix="autoscale-pm-")
    sup, gw, scaler, base = boot_fleet(args, autoscale=True,
                                       recorder_dir=recorder_dir)
    try:
        workload = ZipfODWorkload(s=args.zipf_s, seed=args.seed)
        warm(base, workload)
        capacity = measure_capacity(base, workload, args.calibrate_s)
        time.sleep(harness.SETTLE_S)   # calibration queue drains
        scaler.start()           # every decision now belongs to the run
        base_rate = max(2.0, capacity / 8.0)
        spike_rate = base_rate * 10.0          # ≈ 1.25 × capacity
        duration = args.baseline_s + args.spike_s + args.recovery_s
        curve = RateCurve.flash_crowd(base_rate, 10.0, args.baseline_s,
                                      args.spike_s)
        offsets = poisson_schedule(curve, duration, seed=args.seed)
        # Determinism receipt: the identical seed regenerates the
        # identical schedule (array-equal) and request sequence.
        offsets2 = poisson_schedule(curve, duration, seed=args.seed)
        reproducible = (len(offsets) == len(offsets2)
                        and bool((offsets == offsets2).all())
                        and workload.sequence(64)
                        == ZipfODWorkload(s=args.zipf_s,
                                          seed=args.seed).sequence(64))
        requests = workload.sequence(len(offsets))
        metrics_before = fetch_metrics(base, replicas=True)
        with FleetWatcher(gw) as watcher:
            records, run_t0 = harness.run_open_loop_process(
                [base], offsets, requests, workers=args.workers,
                timeout=35.0)
            # Keep watching (and keep the SLO engine ticking) until the
            # fleet is back to min size or the wait budget lapses — the
            # "and back down" half of the acceptance bar.
            settle_deadline = time.monotonic() + args.settle_s
            while time.monotonic() < settle_deadline:
                with gw._lock:
                    live = sum(1 for r in gw.replicas if not r.draining)
                pending = len(scaler._pending)
                if live <= 1 and pending == 0:
                    break
                time.sleep(1.0)
        metrics_after = fetch_metrics(base, replicas=True)
        report = summarize(records, duration, len(offsets))
        spike_lo, spike_hi = args.baseline_s, args.baseline_s + args.spike_s
        ups = [h for h in scaler.snapshot()["history"]
               if h.get("direction") == "up" and "phase" not in h]
        # Attribution: the decision must land in (or just after — the
        # hysteresis ticks) the spike window, not during baseline.
        ups_in_spike = [h for h in ups
                        if spike_lo <= h["t"] - run_t0 <= spike_hi + 10.0]
        downs = [h for h in scaler.snapshot()["history"]
                 if h.get("direction") == "down"
                 and h.get("phase") == "stopped"]
        joins = [h for h in scaler.snapshot()["history"]
                 if h.get("phase") == "joined"]
        slo_states = watcher.slo_states()
        final_fleet = gw.snapshot()["fleet"]
        out = {
            "capacity_rps_1_replica": round(capacity, 1),
            "offered": {"base_rps": round(base_rate, 1),
                        "spike_rps": round(spike_rate, 1),
                        "spike_window_s": [spike_lo, spike_hi],
                        "curve": curve.spec, "seed": args.seed,
                        "arrivals": len(offsets)},
            "schedule_reproducible": reproducible,
            "load": report,
            "load_timeline": timeline(records, bucket_s=2.0),
            "fleet_timeline": watcher.samples,
            "cache": cache_delta(metrics_before, metrics_after),
            "fused_launches": harness.launch_delta(metrics_before,
                                                   metrics_after),
            "autoscale": {
                "up_decisions": len(ups),
                "up_decisions_in_spike_window": len(ups_in_spike),
                "down_decisions": len(downs),
                "joins": [{k: h[k] for k in ("replica", "boot_s")
                           if k in h} for h in joins],
                "max_replicas_seen": watcher.max_replicas(),
                "final_replicas": final_fleet["replica_count"],
                "history": scaler.snapshot()["history"],
            },
            "slo": {
                "states_seen": sorted(set(slo_states)),
                "final_state": slo_states[-1] if slo_states else "n/a",
                "paged": "page" in slo_states,
                "recovered": (slo_states[-1] != "page"
                              if slo_states else False),
            },
        }
        out["pace"] = harness.pace_check(report)
        out["generator_lagged"] = out["pace"]["generator_lagged"]
        out["pass"] = harness.passed(
            len(ups_in_spike) >= 1
            and watcher.max_replicas() >= 2
            and len(downs) >= 1
            and out["autoscale"]["final_replicas"] <= 1
            and report["error_rate"] <= args.max_error_rate
            and report["shed_rate"] <= args.max_shed_rate
            and out["slo"]["recovered"]
            and reproducible, out["pace"])
        return out
    finally:
        shutdown_fleet(sup, gw, scaler)
        shutil.rmtree(recorder_dir, ignore_errors=True)


def scenario_diurnal(args) -> dict:
    """One compressed day: mixed Zipf predict + history reads under a
    sinusoid cresting above one replica's capacity, with SSE
    subscribers held open across the whole curve. Pass = fleet size
    tracks the curve (up near the crest, back to min after the trough)
    with ~zero errors."""
    from routest_tpu_torch.loadgen import (MixedWorkload, RateCurve,
                                           SseClients, poisson_schedule,
                                           summarize, timeline)

    recorder_dir = tempfile.mkdtemp(prefix="autoscale-pm-")
    sup, gw, scaler, base = boot_fleet(args, autoscale=True,
                                       recorder_dir=recorder_dir)
    try:
        workload = MixedWorkload(
            mix={"predict_eta": 0.87, "history": 0.08,
                 "update_tracker": 0.05},
            s=args.zipf_s, seed=args.seed)
        warm(base, workload.od)
        capacity = measure_capacity(base, workload.od, args.calibrate_s)
        time.sleep(harness.SETTLE_S)
        scaler.start()
        period = args.diurnal_period_s
        curve = RateCurve.diurnal(base=max(1.0, capacity / 10.0),
                                  peak=capacity * 1.2, period_s=period,
                                  phase_s=0.0)   # trough at t=0
        duration = period + args.settle_s
        offsets = poisson_schedule(curve, period, seed=args.seed + 1)
        requests = workload.sequence(len(offsets))
        with FleetWatcher(gw) as watcher, \
                SseClients(base, n=2,
                           channel=workload.sse_channel) as sse:
            records, _ = harness.run_open_loop_process(
                [base], offsets, requests, workers=args.workers,
                timeout=35.0)
            settle_deadline = time.monotonic() + args.settle_s
            while time.monotonic() < settle_deadline:
                with gw._lock:
                    live = sum(1 for r in gw.replicas if not r.draining)
                if live <= 1 and not scaler._pending:
                    break
                time.sleep(1.0)
            sse_snap = sse.snapshot()
        report = summarize(records, duration, len(offsets))
        hist = scaler.snapshot()["history"]
        ups = [h for h in hist
               if h.get("direction") == "up" and "phase" not in h]
        downs = [h for h in hist if h.get("phase") == "stopped"]
        out = {
            "capacity_rps_1_replica": round(capacity, 1),
            "offered": {"curve": curve.spec, "seed": args.seed + 1,
                        "arrivals": len(offsets)},
            "workload": workload.describe(),
            "sse": sse_snap,
            "load": report,
            "load_timeline": timeline(records, bucket_s=5.0),
            "fleet_timeline": watcher.samples,
            "autoscale": {"up_decisions": len(ups),
                          "down_decisions": len(downs),
                          "max_replicas_seen": watcher.max_replicas(),
                          "final_replicas":
                          gw.snapshot()["fleet"]["replica_count"],
                          "history": hist},
            "slo": {"final_state": watcher.slo_states()[-1]
                    if watcher.samples else "n/a"},
        }
        out["pace"] = harness.pace_check(report)
        out["generator_lagged"] = out["pace"]["generator_lagged"]
        out["pass"] = harness.passed(
            len(ups) >= 1
            and watcher.max_replicas() >= 2
            and out["autoscale"]["final_replicas"] <= 1
            and report["error_rate"] <= args.max_error_rate
            and out["slo"]["final_state"] != "page"
            and sse_snap["connected"] == sse_snap["requested"]
            and sse_snap["events"] > 0, out["pace"])
        return out
    finally:
        shutdown_fleet(sup, gw, scaler)
        shutil.rmtree(recorder_dir, ignore_errors=True)


def scenario_closed_vs_open(args) -> dict:
    """The coordinated-omission receipt: the SAME overloaded fixed
    1-replica fleet (autoscaler off), measured both ways. The
    closed-loop harness throttles itself to the server's pace, so its
    recorded p99 stays near the service time; the open-loop harness
    charges every request its wait from the INTENDED send and exposes
    the real user-visible tail."""
    from routest_tpu_torch.loadgen import (RateCurve, ZipfODWorkload,
                                           paced_schedule, run_closed_loop,
                                           summarize)

    recorder_dir = tempfile.mkdtemp(prefix="autoscale-pm-")
    # Deep admission queue: THIS scenario wants the overload to QUEUE
    # (the backlog is what closed-loop accounting hides); the autoscale
    # scenarios keep the shallow production-shaped queue and shed.
    sup, gw, scaler, base = boot_fleet(args, autoscale=False,
                                       recorder_dir=recorder_dir,
                                       queue_depth=512)
    try:
        workload = ZipfODWorkload(s=args.zipf_s, seed=args.seed)
        warm(base, workload)
        capacity = measure_capacity(base, workload, args.calibrate_s)
        over_rate = capacity * 1.5
        dur = args.cvo_s
        # Deterministic pacing: identical offered schedule both runs.
        offsets = paced_schedule(RateCurve.constant(over_rate), dur)
        n = len(offsets)
        closed = summarize(
            run_closed_loop([base], workload.sequence(n), workers=8,
                            duration_s=dur, timeout=35.0),
            dur, n, loop="closed")
        time.sleep(harness.SETTLE_S)   # the queue drains between arms
        records, _ = harness.run_open_loop_process(
            [base], offsets, workload.sequence(n), workers=args.workers,
            timeout=35.0)
        open_ = summarize(records, dur, n)
        # 1.5 C into a deep queue backs up by design, and once the
        # backlog holds the senders every arrival waits for one: the
        # generator's own pace is read over the arrivals before the
        # backlog (growing at over_rate - C) could hold half of them
        window = min(dur, 0.5 * args.workers / (over_rate - capacity))
        pace = harness.early_pace_check(records, window)
        closed_p99 = (closed.get("latency") or {}).get("p99_ms")
        open_p99 = (open_.get("latency") or {}).get("p99_ms")
        gap = round(open_p99 / closed_p99, 2) \
            if closed_p99 and open_p99 else None
        return {
            "capacity_rps_1_replica": round(capacity, 1),
            "offered_rps": round(over_rate, 1),
            "duration_s": dur,
            "closed_loop": closed,
            "open_loop": open_,
            "coordinated_omission_p99_gap_x": gap,
            "explanation": (
                "identical server, identical offered schedule; the "
                "closed-loop arm self-throttles to the server's pace "
                "(its own achieved rps is the tell) so its p99 hides "
                "the backlog wait that open-loop accounting charges"),
            "pace": pace,
            "generator_lagged": pace["generator_lagged"],
            "pass": harness.passed(gap is not None
                                   and gap >= args.min_co_gap, pace),
        }
    finally:
        shutdown_fleet(sup, gw, scaler)
        shutil.rmtree(recorder_dir, ignore_errors=True)


SCENARIOS = {
    "flash_crowd": scenario_flash_crowd,
    "diurnal": scenario_diurnal,
    "closed_vs_open": scenario_closed_vs_open,
}


def main() -> None:
    from routest_tpu_torch.utils.logging import get_logger

    log = get_logger("routest_tpu_torch.bench_autoscale")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="serve every replica on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--zipf-s", type=float, default=1.1)
    parser.add_argument("--workers", type=int, default=96,
                        help="open-loop sender threads")
    parser.add_argument("--max-replicas", type=int, default=3)
    parser.add_argument("--scenarios", nargs="*", default=None,
                        choices=sorted(SCENARIOS))
    parser.add_argument("--max-error-rate", type=float, default=0.01)
    parser.add_argument("--max-shed-rate", type=float, default=0.35,
                        help="shed(429) bound during the overload "
                             "scenarios — bounded load-shedding is the "
                             "design, collapse is the failure")
    parser.add_argument("--min-co-gap", type=float, default=2.0,
                        help="open-loop p99 must exceed closed-loop "
                             "p99 by at least this factor on the same "
                             "overload")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "autoscale_cuda.json; build/"
                             "autoscale_cpu.json with --cpu)")
    args = parser.parse_args()
    args.device = harness.require_card(args.cpu, "bench_autoscale_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "autoscale_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "autoscale_cpu.json")
    if args.quick:
        args.calibrate_s = 3.0
        args.baseline_s, args.spike_s, args.recovery_s = 8.0, 20.0, 30.0
        args.settle_s = 90.0
        args.diurnal_period_s = 60.0
        args.cvo_s = 8.0
    else:
        args.calibrate_s = 5.0
        args.baseline_s, args.spike_s, args.recovery_s = 15.0, 30.0, 45.0
        args.settle_s = 150.0
        args.diurnal_period_s = 90.0
        args.cvo_s = 12.0

    results = {}
    for name in (args.scenarios or list(SCENARIOS)):
        log.info("autoscale_scenario_started", scenario=name)
        t0 = time.time()
        try:
            results[name] = SCENARIOS[name](args)
        except Exception as e:
            results[name] = {"error": f"{type(e).__name__}: {e}",
                             "pass": False}
            log.error("autoscale_scenario_failed", scenario=name,
                      error=f"{type(e).__name__}: {e}")
        results[name]["wall_s"] = round(time.time() - t0, 1)
        log.info("autoscale_scenario_finished", scenario=name,
                 ok=results[name].get("pass"),
                 wall_s=results[name]["wall_s"])

    record = {
        "generated_unix": int(time.time()),
        "card": harness.card_identity(args.device),
        "quick": bool(args.quick),
        "placement": ("every replica on the one card: r0 on slice 0, "
                      "each grown replica on the plan's growth slice "
                      "(CUDA_VISIBLE_DEVICES=0)"
                      if args.device == "cuda" else "device-blind, CPU"),
        "loadgen": {"zipf_s": args.zipf_s, "seed": args.seed,
                    "workers": args.workers,
                    "open_loop": "latency measured from intended send "
                                 "time (coordinated-omission-correct)"},
        "scenarios": results,
        "all_pass": all(r.get("pass") for r in results.values()),
    }
    harness.write_record(args.out, record)
    log.info("autoscale_written", path=args.out,
             all_pass=record["all_pass"])
    print(json.dumps({k: (v if k != "scenarios" else {
        n: {kk: vv for kk, vv in s.items()
            if kk in ("pass", "wall_s", "capacity_rps_1_replica",
                      "coordinated_omission_p99_gap_x", "autoscale",
                      "slo", "error", "pace")}
        for n, s in v.items()}) for k, v in record.items()}, indent=2))
    # a failed scenario fails the run
    sys.exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
