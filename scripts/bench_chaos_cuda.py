"""Chaos matrix on the card: the port's serving fleet under injected
faults, measured → artifacts/chaos_matrix_cuda.json.

The port's counterpart of ``scripts/bench_chaos.py``: per scenario a
real fleet of the port (supervisor + ``python -m routest_tpu_torch.serve``
replicas on the card + in-process gateway, the JAX script's topology),
faults injected through ``routest_tpu_torch.chaos`` (replica-side via
``RTPU_CHAOS_*`` in the replicas' environment, gateway-side through an
in-process engine) or actuated directly (the port's TCP broker
SIGKILLed, ``supervisor.kill_replica``). Per scenario it records the
client error rate, p95 latency, shed (429) and expired (504) counts and
the scenario's invariants, with the JAX script's pass rule
(:func:`judge`) — above all ZERO lost writes after the store outage's
journal replay, and ``events_lost: 0`` across the broker's kill.

Scenarios (the JAX script's seven, its loads and specs): baseline,
deadline_storm, slow_replica, replica_crash, store_outage,
device_error_burst, netbus_kill. The store is the one the JAX scenario
writes to: the replica's in-memory store behind the resilience layer
(no ``SUPABASE_URL``), every write read back from ``/api/history``.

One departure from the JAX script's load: the doomed requests of
``deadline_storm`` and every request of ``device_error_burst`` carry
a row of their own (:func:`unique_body`). The JAX script sends one body
throughout; both packages' fast-lane cache now answers a repeated body
without the batcher or the device (inside any budget, under any device
fault), so those two scenarios would pass without meeting their fault.
``bench_slo_detection.py`` makes the same change for the same reason.

The record keeps the JAX record's keys per scenario, adds the fused
launches each scenario's replicas made (``launches``), the card's name
and power limit and a verdict per scenario (``checks``). ``--cpu``
serves the replicas on the CPU for a rehearsal; without a card and
without ``--cpu`` the script exits 2.

Usage: python3 scripts/bench_chaos_cuda.py [--quick] [--seed 7] [--cpu]
       [--scenarios name ...] [--out artifacts/chaos_matrix_cuda.json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

MODEL = harness.MODEL

# The JAX script's bodies (bench_chaos.py:41-64).
PREDICT_BODY = {"summary": {"distance": 8000}, "weather": "Sunny",
                "traffic": "Medium", "driver_age": 35,
                "pickup_time": "2026-07-29T18:00:00"}

ROUTE_BODY = {
    "source_point": {"lat": 14.5836, "lon": 121.0409},
    "destination_points": [
        {"lat": 14.5507, "lon": 121.0262, "payload": 1},
        {"lat": 14.5866, "lon": 121.0566, "payload": 1}],
    "driver_details": {"driver_name": "chaos", "vehicle_type": "car",
                       "vehicle_capacity": 100,
                       "maximum_distance": 300000, "driver_age": 31},
    "meta": {"origin_id": "o-chaos", "destination_ids": ["d1", "d2"]},
}

TRACKER_BODY = {
    "route_id": "chaos", "route": [[121.05, 14.55], [121.06, 14.56]],
    "destinations": [{"lat": 14.56, "lon": 121.06}],
    "driver_name": "chaos", "vehicle_type": "car",
    "duration": 600, "distance": 5000, "trips": 1,
    "pickup_time": "2026-07-29T18:00:00",
}

# The JAX script's injections and loads.
SLOW_SPEC = "gateway.forward.r1:latency=1.0/300"
SLOW_MS = 300
STORE_SPEC = "store.http:error=1.0@20"
DEVICE_SPEC = "device.compute:error=0.3@10"
STORE_ENV = {"RTPU_STORE_RETRIES": "1", "RTPU_STORE_BREAKER_AFTER": "2",
             "RTPU_STORE_COOLDOWN_S": "0.4"}
GATEWAY_CFG = {"eject_after": 3, "cooldown_s": 1.0, "max_inflight": 32,
               "queue_depth": 128}
CONCURRENCY = 4
NOTE = ("1-core hosts time-share replicas: p95 under fault measures "
        "degraded-mode behavior, not parallel capacity (see "
        "fleet_scale.json).")


def unique_body(i: int) -> dict:
    """Request ``i``'s predict body: a row of its own (the fast-lane
    cache answers a repeated one without the device)."""
    return {**PREDICT_BODY, "summary": {"distance": 8000 + i}}


def load_per_scenario(quick: bool) -> int:
    """The JAX script's ``args.n``."""
    return 40 if quick else 120


def _post(base, path, payload, headers=None, timeout=60.0):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except ValueError:
            return e.code, {}


def _get(base, path, timeout=15.0):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except ValueError:
            return e.code, {}


# ── fleet lifecycle ───────────────────────────────────────────────────


def boot_fleet(n: int, device: str, extra_env=None, **gw_cfg):
    """→ (supervisor, gateway, base_url): ``n`` replicas of the port on
    ``device`` behind an in-process gateway, each warmed by one
    predict."""
    from routest_tpu_torch.core.config import FleetConfig
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    ports = [harness.free_port() for _ in range(n)]
    env = harness.server_env(device, ROUTEST_WARM_BUCKETS="0",
                             ROUTEST_MESH="0", ETA_MODEL_PATH=MODEL)
    # the JAX scenarios' store: in memory behind the resilience layer
    for key in ("SUPABASE_URL", "SUPABASE_SERVICE_ROLE_KEY", "REDIS_URL"):
        env.pop(key, None)
    env.update(extra_env or {})
    sup = ReplicaSupervisor(ports, env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0)
    sup.start()
    if not sup.ready(timeout=300):
        sup.drain(timeout=10)
        raise RuntimeError("fleet workers never became ready")
    for port in ports:
        _post(f"http://127.0.0.1:{port}", "/api/predict_eta", PREDICT_BODY)
    cfg = FleetConfig(**{**GATEWAY_CFG, **gw_cfg})
    gw = Gateway([("127.0.0.1", p) for p in ports], cfg, supervisor=sup)
    httpd = gw.serve("127.0.0.1", 0)
    return sup, gw, f"http://127.0.0.1:{httpd.server_address[1]}"


def shutdown_fleet(sup, gw):
    try:
        gw.drain(timeout=5)
    finally:
        sup.drain(timeout=15)


# ── load + measurement ────────────────────────────────────────────────


def drive_load(base, n_requests, concurrency=CONCURRENCY,
               path="/api/predict_eta", body=PREDICT_BODY, headers_fn=None,
               mid_hook=None, body_fn=None):
    """The JAX script's closed-loop load phase → (statuses, sorted
    latencies ms); ``mid_hook`` fires once, halfway through;
    ``body_fn(i)``, when given, is request ``i``'s body."""
    statuses: dict = {}
    latencies: list = []
    lock = threading.Lock()
    counter = {"i": 0}

    def worker():
        while True:
            with lock:
                i = counter["i"]
                if i >= n_requests:
                    return
                counter["i"] += 1
            if mid_hook is not None and i == n_requests // 2:
                mid_hook()
            hdrs = headers_fn(i) if headers_fn else None
            t0 = time.perf_counter()
            try:
                status, _ = _post(base, path,
                                  body_fn(i) if body_fn else body,
                                  headers=hdrs, timeout=30.0)
            except Exception:
                status = -1  # transport failure seen by the client
            dt = (time.perf_counter() - t0) * 1000.0
            with lock:
                statuses[status] = statuses.get(status, 0) + 1
                latencies.append(dt)

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return statuses, sorted(latencies)


def _p95(latencies):
    if not latencies:
        return None
    return round(latencies[min(len(latencies) - 1,
                               int(0.95 * len(latencies)))], 2)


def _registry_total(base, names):
    _, snap = _get(base, "/api/metrics?replicas=1", timeout=30.0)
    total = 0.0
    for rep in (snap.get("replica_metrics") or {}).values():
        reg = (rep or {}).get("registry") or {}
        for name in names:
            for series in (reg.get(name) or {}).get("series", ()):
                total += series.get("value", 0)
    return total


def summarize(statuses, latencies, gw):
    """The JAX script's per-scenario summary: a 504 is a refusal, not an
    error; -1 (transport) and every other 5xx are errors."""
    total = sum(statuses.values())
    errors = sum(c for s, c in statuses.items()
                 if s == -1 or (500 <= s and s != 504))
    return {
        "requests": total,
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "error_rate": round(errors / total, 4) if total else None,
        "p95_ms": _p95(latencies),
        "shed_429": statuses.get(429, 0) + gw.shed_count,
        "expired_504": statuses.get(504, 0),
        "gateway": {"retries": gw.retries, "hedges": gw.hedges,
                    "hedge_wins": gw.hedge_wins, "shed": gw.shed_count},
    }


def judge(name: str, out: dict, n: int) -> bool:
    """The JAX script's pass rule of scenario ``name`` on its record
    ``out`` (``n``: the load per scenario)."""
    if name in ("baseline", "slow_replica"):
        return out["error_rate"] == 0.0
    if name == "deadline_storm":
        st = out["statuses"]
        ok = st.get("200", 0)
        refused = st.get("504", 0) + st.get("429", 0) + st.get("502", 0)
        doomed = out["doomed_requests"]
        return ok >= (n - doomed) * 0.95 and refused >= doomed * 0.8
    if name == "replica_crash":
        return out["error_rate"] <= 0.02 and bool(out["replica_recovered"])
    if name == "store_outage":
        return out["lost_writes_after_replay"] == 0 \
            and out["routes_saved"] > 0
    if name == "device_error_burst":
        return bool(out["healthy_after_burst"])
    if name == "netbus_kill":
        return out["events_lost"] == 0 \
            and out["events_published"] == out["requests"]
    raise KeyError(name)


# ── scenarios ─────────────────────────────────────────────────────────


def scenario_baseline(args):
    sup, gw, base = boot_fleet(2, args.device)
    try:
        statuses, lat = drive_load(base, args.n)
        out = summarize(statuses, lat, gw)
        out["description"] = "no faults; reference error rate and p95"
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        shutdown_fleet(sup, gw)


def scenario_deadline_storm(args):
    """Every third request carries a 1 ms budget: refused (504 or 429),
    never computed; the others keep serving."""
    sup, gw, base = boot_fleet(1, args.device)
    try:
        doomed = {"n": 0}

        def headers(i):
            if i % 3 == 0:
                doomed["n"] += 1
                return {"X-Deadline-Ms": "1"}
            return None

        statuses, lat = drive_load(
            base, args.n, headers_fn=headers,
            body_fn=lambda i: unique_body(i) if i % 3 == 0
            else PREDICT_BODY)
        out = summarize(statuses, lat, gw)
        out["doomed_requests"] = doomed["n"]
        out["doomed_bodies"] = "unique"
        out["replica_expired_total"] = _registry_total(
            base, ["rtpu_replica_expired_total",
                   "rtpu_batcher_expired_total"])
        out["description"] = ("1/3 of requests carry X-Deadline-Ms=1; "
                              "expired work is refused before device "
                              "compute")
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        shutdown_fleet(sup, gw)


def scenario_slow_replica(args):
    """r1's hops +300 ms (gateway-side ``gateway.forward.r1``); hedging
    races the healthy replica."""
    import routest_tpu_torch.chaos as chaos

    sup, gw, base = boot_fleet(2, args.device, hedge=True,
                               hedge_min_ms=30.0)
    chaos.configure(chaos.ChaosEngine(spec=SLOW_SPEC, seed=args.seed))
    try:
        statuses, lat = drive_load(base, args.n)
        out = summarize(statuses, lat, gw)
        out["injected_latency_ms"] = SLOW_MS
        out["description"] = ("replica r1 +300 ms on every hop; hedging "
                              "races the healthy replica")
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        chaos.configure(None)
        shutdown_fleet(sup, gw)


def scenario_replica_crash(args):
    """SIGKILL r0 mid-load: retries and the breaker absorb it, the
    supervisor restarts the worker (given 60 s, the JAX window)."""
    sup, gw, base = boot_fleet(2, args.device)
    try:
        statuses, lat = drive_load(base, args.n,
                                   mid_hook=lambda: sup.kill_replica(0))
        t_kill_done = time.time()
        deadline = time.time() + 60
        while time.time() < deadline:
            snap = sup.snapshot()
            if snap["r0"]["alive"] and snap["r0"]["restarts"] >= 1:
                break
            time.sleep(0.5)
        out = summarize(statuses, lat, gw)
        out["restarts"] = sup.snapshot()["r0"]["restarts"]
        out["replica_recovered"] = sup.snapshot()["r0"]["alive"]
        out["recovered_after_load_s"] = round(time.time() - t_kill_done, 2)
        out["description"] = ("SIGKILL r0 mid-load; retries absorb the "
                              "crash, supervisor restarts the worker")
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        shutdown_fleet(sup, gw)


def scenario_store_outage(args):
    """Every store call fails until the seeded 20-fault budget runs out:
    writes journal, reads fail fast degraded, health-driven half-open
    probes recover the breaker, the journal replays — and every write
    is read back."""
    n_routes = max(8, args.n // 6)
    sup, gw, base = boot_fleet(1, args.device, extra_env={
        "RTPU_CHAOS_SPEC": STORE_SPEC, "RTPU_CHAOS_SEED": str(args.seed),
        **STORE_ENV})
    stop_health = threading.Event()

    def health_poller():   # the orchestrator heartbeat that drives probes
        while not stop_health.is_set():
            _get(base, "/api/health", timeout=10.0)
            stop_health.wait(0.3)

    poller = threading.Thread(target=health_poller, daemon=True)
    poller.start()
    try:
        saved = degraded_writes = 0
        statuses: dict = {}
        latencies: list = []
        for _ in range(n_routes):
            t0 = time.perf_counter()
            status, body = _post(base, "/api/optimize_route", ROUTE_BODY)
            latencies.append((time.perf_counter() - t0) * 1000.0)
            statuses[status] = statuses.get(status, 0) + 1
            props = (body or {}).get("properties", {})
            if props.get("saved"):
                saved += 1
                if props.get("degraded"):
                    degraded_writes += 1
        rows, degraded_reads = [], 0
        t_replay = time.perf_counter()
        deadline = time.time() + 90
        while time.time() < deadline:
            _, hist = _get(base, "/api/history?limit=100", timeout=30.0)
            if hist.get("degraded"):
                degraded_reads += 1
            rows = hist.get("items") or []
            if len(rows) >= saved and not hist.get("degraded"):
                break
            time.sleep(0.5)
        out = summarize(statuses, sorted(latencies), gw)
        out.update({
            "routes_saved": saved,
            "writes_journaled_degraded": degraded_writes,
            "degraded_reads_observed": degraded_reads,
            "history_rows_after_replay": len(rows),
            "lost_writes_after_replay": max(0, saved - len(rows)),
            "journal_replay_success": len(rows) >= saved,
            "replay_read_back_s": round(time.perf_counter() - t_replay, 2),
            "description": ("every store call fails until the 20-fault "
                            "budget exhausts; journal replays on "
                            "recovery"),
        })
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        stop_health.set()
        poller.join(timeout=5)
        shutdown_fleet(sup, gw)


def scenario_device_error_burst(args):
    """``device.compute`` errors on the card's replica for a bounded
    burst: the affected requests surface 503 (never a silent NaN), and
    the replica serves again afterwards."""
    sup, gw, base = boot_fleet(1, args.device, extra_env={
        "RTPU_CHAOS_SPEC": DEVICE_SPEC, "RTPU_CHAOS_SEED": str(args.seed)})
    try:
        statuses, lat = drive_load(base, args.n, body_fn=unique_body)
        post_status = None
        deadline = time.time() + 45
        while time.time() < deadline:
            post_status, _ = _post(base, "/api/predict_eta", PREDICT_BODY)
            if post_status == 200:
                break
            time.sleep(0.5)
        out = summarize(statuses, lat, gw)
        out["healthy_after_burst"] = post_status == 200
        out["bodies"] = "unique"
        out["description"] = ("30% of device calls error for a 10-fault "
                              "burst; one fault fails its whole coalesced "
                              "batch loudly (5xx, never silent NaN) and "
                              "the gateway breaker fail-fasts while the "
                              "replica looks sick — then full recovery")
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        shutdown_fleet(sup, gw)


def scenario_netbus_kill(args):
    """SIGKILL the port's TCP broker mid-stream, publish through the
    outage, restart it: the replica's reconnect and publish buffer and
    the subscription's resume deliver every event."""
    broker_port = harness.free_port()

    def spawn_broker():
        proc = subprocess.Popen(
            [sys.executable, "-m", "routest_tpu_torch.serve.netbus",
             "--port", str(broker_port)], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", broker_port),
                                         timeout=0.2).close()
                return proc
            except OSError:
                time.sleep(0.1)
        proc.kill()
        raise RuntimeError("broker never listened")

    broker = spawn_broker()
    sup, gw, base = boot_fleet(1, args.device, extra_env={
        "REDIS_URL": f"tcp://127.0.0.1:{broker_port}",
        "RTPU_NETBUS_RECONNECT_S": "60"})
    n_events = max(6, args.n // 8)
    received: list = []

    def listen():
        req = urllib.request.Request(
            f"{base}/api/realtime_feed?channel=chaos"
            f"&max_events={2 * n_events}")
        try:
            with urllib.request.urlopen(req, timeout=180) as resp:
                for raw in resp:
                    line = raw.decode().strip()
                    if line.startswith("data: "):
                        received.append(json.loads(line[6:]))
                        if len(received) >= 2 * n_events:
                            return
        except Exception:
            return

    listener = threading.Thread(target=listen, daemon=True)
    listener.start()
    time.sleep(1.5)   # the subscription registers at the broker
    try:
        published = 0
        for _ in range(n_events):               # phase 1: healthy
            status, _ = _post(base, "/api/update_tracker", TRACKER_BODY)
            published += status == 200
            time.sleep(0.05)
        broker.kill()
        broker.wait()
        time.sleep(0.3)
        for _ in range(n_events):               # phase 2: buffered
            status, _ = _post(base, "/api/update_tracker", TRACKER_BODY)
            published += status == 200
            time.sleep(0.05)
        broker = spawn_broker()                 # phase 3: replay
        t_restart = time.perf_counter()
        deadline = time.time() + 60
        while len(received) < published and time.time() < deadline:
            time.sleep(0.5)
        out = {
            "events_published": published,
            "events_received": len(received),
            "events_lost": max(0, published - len(received)),
            "requests": 2 * n_events,
            "statuses": {"200": published},
            "error_rate": round(1.0 - published / (2 * n_events), 4),
            "p95_ms": None,
            "shed_429": 0,
            "expired_504": 0,
            "restart_to_delivered_s": round(
                time.perf_counter() - t_restart, 2),
            "description": ("broker SIGKILLed mid-stream and restarted; "
                            "publish buffer + subscription resume "
                            "deliver every event"),
        }
        out["launches"] = harness.fleet_launches(base)
        return out
    finally:
        if broker.poll() is None:
            broker.kill()
            broker.wait()
        shutdown_fleet(sup, gw)


SCENARIOS = {
    "baseline": scenario_baseline,
    "deadline_storm": scenario_deadline_storm,
    "slow_replica": scenario_slow_replica,
    "replica_crash": scenario_replica_crash,
    "store_outage": scenario_store_outage,
    "device_error_burst": scenario_device_error_burst,
    "netbus_kill": scenario_netbus_kill,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="smaller load phases")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--scenarios", nargs="*", default=None,
                        choices=sorted(SCENARIOS))
    parser.add_argument("--cpu", action="store_true",
                        help="serve the replicas on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "chaos_matrix_cuda.json; build/"
                             "chaos_matrix_cpu.json with --cpu)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_chaos_cuda")
    if args.out is None:
        args.out = os.path.join(
            REPO, "artifacts", "chaos_matrix_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "chaos_matrix_cpu.json")
    args.n = load_per_scenario(args.quick)

    names = args.scenarios or list(SCENARIOS)
    t0 = time.time()
    results = {}
    for i, name in enumerate(names):
        print(f"[{i + 1}/{len(names)}] scenario {name}…", flush=True)
        t = time.time()
        try:
            results[name] = SCENARIOS[name](args)
            results[name]["pass"] = judge(name, results[name], args.n)
        except Exception as e:
            results[name] = {"error": f"{type(e).__name__}: {e}",
                             "pass": False}
        results[name]["wall_s"] = round(time.time() - t, 1)
        r = results[name]
        print(f"  {name}: {'PASS' if r['pass'] else 'FAIL'} "
              f"({r['wall_s']}s) error_rate {r.get('error_rate')} p95 "
              f"{r.get('p95_ms')} ms {r.get('error', '')}", flush=True)

    record = {
        "generated_unix": int(t0),
        "seed": args.seed,
        "load_per_scenario": args.n,
        "quick": bool(args.quick),
        "card": harness.card_identity(args.device),
        "host": {"cpu_count": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "note": NOTE,
        "scenarios": results,
    }
    if args.scenarios:
        record["partial"] = f"--scenarios {' '.join(args.scenarios)}"
    record["checks"] = {k: bool(v["pass"]) for k, v in results.items()}
    record["launches"] = sum(int(v.get("launches") or 0)
                             for v in results.values())
    record["all_pass"] = bool(results) and all(record["checks"].values())
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print(f"checks: " + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                                 for k, v in record["checks"].items())
          + f"\n→ {args.out} (all_pass={record['all_pass']}, "
            f"{record['wall_s']}s)", flush=True)
    # _exit, not sys.exit: listener daemon threads racing interpreter
    # teardown must not turn a written verdict into a crash
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
