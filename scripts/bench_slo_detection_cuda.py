"""SLO detection on the card: time to detect and postmortem
completeness, measured → artifacts/slo_detection_cuda.json.

The port's counterpart of ``scripts/bench_slo_detection.py``. Per
scenario a real fleet of the port (supervisor + one ``python -m
routest_tpu_torch.serve`` replica on the card + in-process gateway,
gateway- and replica-side flight recorders) runs a healthy phase, the
fault is injected at a recorded instant, and ``/api/slo?replicas=1`` is
polled every 150 ms until any objective pages. The scenario passes, by
the JAX script's rule (:func:`judge`), when it paged within the
slow-window bound, a bundle's request ring holds the ``X-Trace-Id`` of
an offending request, and every ``slo_page`` bundle embeds a timeline
covering the incident.

Scenarios (the JAX script's four, its windows, ``healthy_n`` and detect
timeouts):

- ``deadline_storm``      every request carries a 1 ms budget → edge
                          504s → availability burn → page
- ``replica_crash``       the only replica is SIGKILLed mid-load →
                          gateway 5xx until the supervisor restarts it
- ``device_error_burst``  seeded ``device.compute`` chaos on the card's
                          replica → predict 503s
- ``store_outage``        seeded chaos fails every store call → the
                          store-dependency objective burns while clients
                          get 200/degraded

The record adds the fused launches each scenario's replica made and
the card's name and power limit. ``--cpu`` serves the replica on the
CPU for a rehearsal; without a card and without ``--cpu`` the script
exits 2.

Usage: python3 scripts/bench_slo_detection_cuda.py [--quick] [--cpu]
       [--scenarios name ...] [--out artifacts/slo_detection_cuda.json]
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
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

MODEL = harness.MODEL

# The JAX script's bodies, chaos and bound (bench_slo_detection.py:52-76).
PREDICT_BODY = {"summary": {"distance": 8000}, "weather": "Sunny",
                "traffic": "Medium", "driver_age": 35,
                "pickup_time": "2026-08-04T18:00:00"}

ROUTE_BODY = {
    "source_point": {"lat": 14.5836, "lon": 121.0409},
    "destination_points": [
        {"lat": 14.5507, "lon": 121.0262, "payload": 1}],
    "driver_details": {"driver_name": "slo-bench", "vehicle_type": "car",
                       "vehicle_capacity": 100,
                       "maximum_distance": 300000, "driver_age": 31},
    "meta": {"origin_id": "o-slo", "destination_ids": ["d1"]},
}

DEVICE_SPEC = "device.compute:error=0.6@25"
DEVICE_SEED = 9
STORE_SPEC = "store.http:error=1.0@60"
STORE_SEED = 7
STORE_ENV = {"RTPU_STORE_RETRIES": "1", "RTPU_STORE_BREAKER_AFTER": "2",
             "RTPU_STORE_COOLDOWN_S": "5"}
SLOW_WINDOW_BOUND_S = 3600.0  # the acceptance bound on time-to-detect
TIMELINE_RES = "1x600,10x360"
POLL_S = 0.15
SLO_DEFAULTS = {"fast_window_s": 300.0, "slow_window_s": 3600.0,
                "page_burn": 14.4, "tick_s": 1.0}
NOTE = ("time-to-detect = fault injection → first objective in the page "
        "state (polled at 150 ms); the slow-window bound is the "
        "acceptance ceiling, the measured values are seconds because "
        "burn-rate windows shorter than the process lifetime evaluate on "
        "available history.")


def phase_sizes(quick: bool) -> tuple:
    """The JAX script's ``(healthy_n, detect_timeout)``."""
    return (10, 45.0) if quick else (25, 90.0)


def _post(base, path, payload, headers=None, timeout=60.0):
    """→ (status, response headers dict, body dict)."""
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read() or b"{}")
        except ValueError:
            body = {}
        return e.code, dict(e.headers or {}), body
    except (urllib.error.URLError, OSError):
        return -1, {}, {}


def _get_json(base, path, timeout=15.0):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return json.loads(r.read())
    except (urllib.error.URLError, OSError, ValueError):
        return {}


def boot_fleet(recorder_dir: str, device: str, extra_env=None,
               warm: bool = True):
    """→ (supervisor, gateway, base_url): one replica of the port on
    ``device`` behind an in-process gateway, with a fresh gateway-side
    flight recorder in ``recorder_dir``/gateway. Both tiers keep 1 s
    timeline frames (the scenarios run tens of seconds)."""
    from routest_tpu_torch.core.config import FleetConfig, RecorderConfig
    from routest_tpu_torch.obs.recorder import (FlightRecorder,
                                                configure_recorder)
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    os.environ["RTPU_TIMELINE_RES"] = TIMELINE_RES
    configure_recorder(FlightRecorder(RecorderConfig(
        dir=os.path.join(recorder_dir, "gateway"), min_interval_s=0.0)))
    ports = [harness.free_port()]
    env = harness.server_env(
        device, ROUTEST_WARM_BUCKETS="0", ROUTEST_MESH="0",
        ETA_MODEL_PATH=MODEL,
        RTPU_RECORDER_DIR=os.path.join(recorder_dir, "workers"),
        RTPU_RECORDER_MIN_INTERVAL_S="0", RTPU_TIMELINE_RES=TIMELINE_RES)
    for key in ("SUPABASE_URL", "SUPABASE_SERVICE_ROLE_KEY", "REDIS_URL"):
        env.pop(key, None)
    env.update(extra_env or {})
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0)
    sup.start()
    if not sup.ready(timeout=300):
        sup.drain(timeout=10)
        configure_recorder(None)
        raise RuntimeError("fleet worker never became ready")
    if warm:
        for port in ports:
            _post(f"http://127.0.0.1:{port}", "/api/predict_eta",
                  PREDICT_BODY)
    cfg = FleetConfig(eject_after=3, cooldown_s=1.0, max_inflight=32,
                      queue_depth=128, hedge=False)
    gw = Gateway([("127.0.0.1", p) for p in ports], cfg, supervisor=sup)
    httpd = gw.serve("127.0.0.1", 0)
    return sup, gw, f"http://127.0.0.1:{httpd.server_address[1]}"


def shutdown_fleet(sup, gw):
    from routest_tpu_torch.obs.recorder import configure_recorder

    try:
        gw.drain(timeout=5)
    finally:
        sup.drain(timeout=15)
        configure_recorder(None)


class DetectionRun:
    """A load thread, a ``/api/slo`` poller, the injection instant and
    the offending trace ids (the JAX script's class)."""

    def __init__(self, base: str, detect_timeout_s: float) -> None:
        self.base = base
        self.detect_timeout_s = detect_timeout_s
        self.offending: set = set()
        self.statuses: dict = {}
        self.t_inject: float = 0.0
        self.t_inject_wall: float = 0.0
        self.paged_at: float = 0.0
        self.page_objective: str = ""
        self.page_component: str = ""
        self._stop = threading.Event()

    def send(self, path, body, headers=None, offending_if=None):
        status, rh, resp = _post(self.base, path, body, headers=headers,
                                 timeout=30.0)
        self.statuses[status] = self.statuses.get(status, 0) + 1
        trace_id = rh.get("X-Trace-Id") or rh.get("x-trace-id")
        is_offending = (status >= 500 if offending_if is None
                        else offending_if(status, resp))
        if is_offending and trace_id:
            self.offending.add(trace_id)
        return status, resp

    def _poll_slo(self) -> None:
        while not self._stop.is_set():
            snap = _get_json(self.base, "/api/slo?replicas=1", timeout=10.0)
            candidates = [("gateway", snap)]
            for rid, rep in (snap.get("replica_slo") or {}).items():
                candidates.append((f"replica:{rid}", rep))
            for component, payload in candidates:
                for name, obj in (payload.get("objectives") or {}).items():
                    if obj.get("state") == "page":
                        self.paged_at = time.monotonic()
                        self.page_objective = name
                        self.page_component = component
                        self._stop.set()
                        return
            self._stop.wait(POLL_S)

    def detect(self, load_fn) -> None:
        poller = threading.Thread(target=self._poll_slo, daemon=True)
        poller.start()
        loader = threading.Thread(target=load_fn, args=(self,),
                                  daemon=True)
        loader.start()
        self._stop.wait(self.detect_timeout_s + 60.0)
        self._stop.set()
        loader.join(timeout=30)
        poller.join(timeout=5)

    def summary(self) -> dict:
        ttd = (self.paged_at - self.t_inject) if self.paged_at else None
        return {
            "paged": bool(self.paged_at),
            "time_to_detect_s": round(ttd, 2) if ttd is not None else None,
            "slow_window_bound_s": SLOW_WINDOW_BOUND_S,
            "within_bound": bool(self.paged_at
                                 and ttd <= SLOW_WINDOW_BOUND_S),
            "page_objective": self.page_objective,
            "page_component": self.page_component,
            "offending_traces_observed": len(self.offending),
            "statuses": {str(k): v
                         for k, v in sorted(self.statuses.items())},
        }


def _bundles(dirs):
    out = []
    for root in dirs:
        if os.path.isdir(root):
            out.extend(os.path.join(root, d) for d in sorted(os.listdir(root))
                       if d.startswith("pm_"))
    return out


def _wait_bundle_with_offender(dirs, offending, timeout_s=30.0):
    """Scan the postmortem dirs until a bundle's ``requests.jsonl``
    holds an offending trace id → (bundle name, matched) or the last
    bundle seen with 0 (or (None, 0))."""
    deadline = time.monotonic() + timeout_s
    best = (None, 0)
    while time.monotonic() < deadline:
        for bundle in _bundles(dirs):
            req_path = os.path.join(bundle, "requests.jsonl")
            if not os.path.exists(req_path):
                continue
            try:
                with open(req_path) as f:
                    ids = {json.loads(line).get("trace_id")
                           for line in f if line.strip()}
            except (OSError, ValueError):
                continue
            matched = len(ids & offending)
            if matched:
                return os.path.basename(bundle), matched
            best = (os.path.basename(bundle), 0)
        time.sleep(0.5)
    return best


def _page_bundle_timelines(dirs, t_inject_wall, timeout_s=30.0):
    """Every ``slo_page*`` bundle embeds a non-empty timeline slice, and
    together they cover the incident (a frame at or after the
    injection instant) → the JAX script's dict of those results."""
    deadline = time.monotonic() + timeout_s
    result = {"page_bundles": 0, "page_bundles_with_timeline": 0,
              "timeline_frames": 0, "timeline_covers_incident": False}
    while time.monotonic() < deadline:
        page_bundles = []
        for bundle in _bundles(dirs):
            try:
                with open(os.path.join(bundle, "manifest.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue   # racing an in-progress write
            if str(manifest.get("reason", "")).startswith("slo_page"):
                page_bundles.append(bundle)
        if page_bundles:
            result["page_bundles"] = len(page_bundles)
            result["page_bundles_with_timeline"] = 0
            result["timeline_frames"] = 0
            covers = False
            for bundle in page_bundles:
                try:
                    with open(os.path.join(bundle, "timeline.json")) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                frames = [fr for comp in doc.values()
                          for fr in comp.get("frames", [])]
                if frames:
                    result["page_bundles_with_timeline"] += 1
                    result["timeline_frames"] += len(frames)
                if any(fr["t"] >= t_inject_wall for fr in frames):
                    covers = True
            result["timeline_covers_incident"] = covers
            if covers and result["page_bundles_with_timeline"] \
                    == result["page_bundles"]:
                return result
        time.sleep(0.5)
    return result


def judge(out: dict) -> bool:
    """The JAX script's pass rule on a scenario's record."""
    return bool(out["paged"] and out["within_bound"]
                and out["bundle_has_offender"]
                and out["bundle_has_timeline"])


def _finish(run, recorder_dir):
    out = run.summary()
    dirs = [os.path.join(recorder_dir, "workers"),
            os.path.join(recorder_dir, "gateway")]
    bundle, matched = _wait_bundle_with_offender(
        dirs, run.offending, timeout_s=30.0)
    out["bundle"] = bundle
    out["bundle_offending_traces"] = matched
    out["bundle_has_offender"] = matched > 0
    timeline = _page_bundle_timelines(dirs, run.t_inject_wall)
    out.update(timeline)
    out["bundle_has_timeline"] = bool(
        timeline["page_bundles"]
        and timeline["page_bundles_with_timeline"]
        == timeline["page_bundles"]
        and timeline["timeline_covers_incident"])
    out["pass"] = judge(out)
    return out


def _run(name, args, load, extra_env=None, warm=True, after=None):
    """Boot the scenario's fleet with a fresh recorder dir, detect under
    ``load``, judge, tear down."""
    recorder_dir = tempfile.mkdtemp(prefix=f"slo-bench-{name}-")
    try:
        sup, gw, base = boot_fleet(recorder_dir, args.device,
                                   extra_env=extra_env, warm=warm)
        try:
            run = DetectionRun(base, args.detect_timeout)
            run.detect(lambda r: load(r, sup))
            out = _finish(run, recorder_dir)
            if after is not None:
                out.update(after(sup))
            out["launches"] = harness.fleet_launches(base)
            return out
        finally:
            shutdown_fleet(sup, gw)
    finally:
        shutil.rmtree(recorder_dir, ignore_errors=True)


def _mark(run):
    run.t_inject = time.monotonic()
    run.t_inject_wall = time.time()


def scenario_deadline_storm(args):
    def load(run, sup):
        for _ in range(args.healthy_n):
            run.send("/api/predict_eta", PREDICT_BODY)
        _mark(run)
        i = 0
        while not run._stop.is_set():
            # unique rows: the fast-lane cache would answer a repeated
            # body inside any budget
            i += 1
            run.send("/api/predict_eta",
                     {**PREDICT_BODY, "summary": {"distance": 8000 + i}},
                     headers={"X-Deadline-Ms": "1"},
                     offending_if=lambda s, _b: s == 504)

    out = _run("deadline_storm", args, load)
    out["description"] = ("every post-injection request carries a 1 ms "
                          "budget over unique rows; batcher/edge 504s "
                          "burn the availability objective")
    return out


def scenario_replica_crash(args):
    def load(run, sup):
        for _ in range(args.healthy_n):
            run.send("/api/predict_eta", PREDICT_BODY)
        _mark(run)
        sup.kill_replica(0)
        while not run._stop.is_set():
            run.send("/api/predict_eta", PREDICT_BODY)
            time.sleep(0.02)

    out = _run("replica_crash", args, load,
               after=lambda sup: {
                   "restarts": sup.snapshot()["r0"]["restarts"]})
    out["description"] = ("the only replica is SIGKILLed; gateway 5xx "
                          "until the supervisor restarts it")
    return out


def scenario_device_error_burst(args):
    def load(run, sup):
        # healthy phase off the device: the seeded burst budget must not
        # leak into the baseline
        for _ in range(args.healthy_n):
            run.send("/api/update_tracker", {"route_id": "x"})
        _mark(run)
        i = 0
        while not run._stop.is_set():
            i += 1
            run.send("/api/predict_eta",
                     {**PREDICT_BODY, "summary": {"distance": 8000 + i}})
            time.sleep(0.01)

    out = _run("device_error_burst", args, load, extra_env={
        "RTPU_CHAOS_SPEC": DEVICE_SPEC, "RTPU_CHAOS_SEED": str(DEVICE_SEED)})
    out["chaos"] = {"spec": DEVICE_SPEC, "seed": DEVICE_SEED}
    out["description"] = ("seeded chaos errors ~60% of device scoring "
                          "calls for a bounded burst; predict 503s page "
                          "availability")
    return out


def scenario_store_outage(args):
    def degraded_or_5xx(status, body):
        props = (body or {}).get("properties") or {}
        return status >= 500 or bool(props.get("degraded"))

    def load(run, sup):
        for _ in range(args.healthy_n):
            run.send("/api/predict_eta", PREDICT_BODY)
        _mark(run)
        while not run._stop.is_set():
            run.send("/api/optimize_route", ROUTE_BODY,
                     offending_if=degraded_or_5xx)

    out = _run("store_outage", args, load, extra_env={
        "RTPU_CHAOS_SPEC": STORE_SPEC, "RTPU_CHAOS_SEED": str(STORE_SEED),
        **STORE_ENV})
    out["description"] = ("every store call fails; writes journal "
                          "(client 200/degraded) while the "
                          "store-dependency objective burns — the page "
                          "fires with ZERO client 5xx, which is the "
                          "point of a dependency SLO")
    return out


SCENARIOS = {
    "deadline_storm": scenario_deadline_storm,
    "replica_crash": scenario_replica_crash,
    "device_error_burst": scenario_device_error_burst,
    "store_outage": scenario_store_outage,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="shorter phases and timeouts")
    parser.add_argument("--scenarios", nargs="*", default=None,
                        choices=sorted(SCENARIOS))
    parser.add_argument("--cpu", action="store_true",
                        help="serve the replica on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "slo_detection_cuda.json; build/"
                             "slo_detection_cpu.json with --cpu)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_slo_detection_cuda")
    if args.out is None:
        args.out = os.path.join(
            REPO, "artifacts", "slo_detection_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "slo_detection_cpu.json")
    args.healthy_n, args.detect_timeout = phase_sizes(args.quick)

    names = args.scenarios or list(SCENARIOS)
    t0 = time.time()
    results = {}
    for i, name in enumerate(names):
        print(f"[{i + 1}/{len(names)}] scenario {name}…", flush=True)
        t = time.time()
        try:
            results[name] = SCENARIOS[name](args)
        except Exception as e:
            results[name] = {"error": f"{type(e).__name__}: {e}",
                             "pass": False}
        results[name]["wall_s"] = round(time.time() - t, 1)
        r = results[name]
        print(f"  {name}: {'PASS' if r.get('pass') else 'FAIL'} "
              f"({r['wall_s']}s) ttd {r.get('time_to_detect_s')} s "
              f"{r.get('page_objective')} {r.get('error', '')}", flush=True)

    record = {
        "generated_unix": int(t0),
        "quick": bool(args.quick),
        "card": harness.card_identity(args.device),
        "host": {"cpu_count": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "slo_defaults": SLO_DEFAULTS,
        "config": {"healthy_n": args.healthy_n,
                   "detect_timeout_s": args.detect_timeout,
                   "poll_s": POLL_S, "timeline_res": TIMELINE_RES},
        "note": NOTE,
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
    print(f"checks: " + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                                 for k, v in record["checks"].items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, "
            f"{record['wall_s']}s)", flush=True)
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
