"""Config-5 workload against the port's server on the card.

The port's counterpart of ``scripts/load_test.py``: many concurrent
clients calling ``/api/predict_eta`` and a sprinkling of
``/api/optimize_route`` (the heavier VRP+geometry path), then 4096-row
``/api/predict_eta_batch`` bodies, 32-problem
``/api/optimize_route_batch`` bodies, road-graph routes, the quantile
band and the batch path's latency decomposition, against
``python -m routest_tpu_torch.serve`` worker processes this script
spawns on the card (scoring through ``fused_eta.cu``). Reports RPS and
latency percentiles per endpoint, plus the servers' own
``/api/metrics`` view (batcher coalescing stats).

Usage: python3 scripts/load_test_cuda.py [--threads 32] [--requests 50]
       [--workers N] [--cpu] [--base-url http://host:port] [--out PATH]

Without a card it exits 2 and names the missing device; ``--cpu``
serves on the CPU instead (``ROUTEST_DEVICE=cpu``). With more than one
worker they share one broker (``serve/netbus.py``).

All phases here are CLOSED-LOOP (each client waits for its response
before sending again) and their artifacts say so (``"loop":
"closed"``): under overload they self-throttle and under-report the
user-visible tail (coordinated omission). ``--open-loop --rate R``
switches to the ``routest_tpu_torch/loadgen`` engine — a seeded arrival
schedule fired independently of the server, Zipf-skewed OD keys,
latency measured from intended send time. See docs/LOADGEN.md. The
open-loop run sends from a process of its own, paced as
``chip_smoke.py``'s phase 18 paces its generator
(``cuda_harness.run_open_loop_process``, after a 2 s settle); a run
whose ``send_delay`` p99 exceeds its latency p50 is recorded
``generator_lagged`` and exits 1.

Records: ``artifacts/load_test_cuda.json`` (closed loop) and
``artifacts/load_test_open_loop_cuda.json`` (``--open-loop``) on the
card, each naming it and its power limit; a ``--cpu`` run writes under
``build/`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import sys
import threading
import time
import urllib.parse
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402


class PersistentPoster:
    """One HTTP/1.1 keep-alive connection with a reconnect-once retry.

    Shared by the single-row and batch phases so both measure the server
    under the identical retry/timing contract: a keep-alive close
    reconnects once and the FULL exchange (including the reconnect) stays
    in the timed window.
    """

    def __init__(self, base: str, timeout: float = 30.0) -> None:
        self._parts = urllib.parse.urlsplit(base)
        self._cls = (http.client.HTTPSConnection
                     if self._parts.scheme == "https"
                     else http.client.HTTPConnection)
        self._timeout = timeout
        self._conn = self._make()

    def _make(self):
        return self._cls(self._parts.hostname, self._parts.port,
                         timeout=self._timeout)

    def reset(self) -> None:
        self._conn.close()
        self._conn = self._make()

    def close(self) -> None:
        self._conn.close()

    def post(self, path: str, payload: dict):
        """→ (seconds, status, raw_body)."""
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        t0 = time.perf_counter()
        try:
            self._conn.request("POST", path, body=body, headers=headers)
            resp = self._conn.getresponse()
            raw = resp.read()
        except (http.client.HTTPException, OSError):
            self.reset()
            self._conn.request("POST", path, body=body, headers=headers)
            resp = self._conn.getresponse()
            raw = resp.read()
        return time.perf_counter() - t0, resp.status, raw


def _get(base: str, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _percentiles(samples):
    ordered = sorted(samples)

    def pct(p):
        return ordered[min(len(ordered) - 1, int(p * len(ordered)))] * 1000

    return {"p50_ms": round(pct(0.5), 2), "p95_ms": round(pct(0.95), 2),
            "p99_ms": round(pct(0.99), 2), "mean_ms":
            round(1000 * sum(samples) / len(samples), 2)}


def run_load(bases, n_threads: int, n_requests: int):
    """``bases``: one or more server base URLs; client threads round-robin
    across them (multi-worker mode shares one SSE broker behind them)."""
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    eta_lat: list = []
    opt_lat: list = []
    errors: list = []
    lock = threading.Lock()

    def eta_payload(rng):
        return {
            "summary": {"distance": rng.uniform(500, 40_000)},
            "weather": rng.choice(["Sunny", "Cloudy", "Stormy", "Windy", "Fog"]),
            "traffic": rng.choice(["Low", "Medium", "High", "Jam"]),
            "driver_age": rng.uniform(19, 60),
            "pickup_time": "2026-07-29T18:00:00",
        }

    def opt_payload(rng):
        picks = rng.sample(range(1, len(SEED_LOCATIONS)), 3)
        return {
            "source_point": {"lat": SEED_LOCATIONS[0][1], "lon": SEED_LOCATIONS[0][2]},
            "destination_points": [
                {"lat": SEED_LOCATIONS[i][1], "lon": SEED_LOCATIONS[i][2], "payload": 1}
                for i in picks
            ],
            "driver_details": {"driver_name": f"lt-{rng.random():.4f}",
                               "vehicle_type": "car",
                               "vehicle_capacity": 100,
                               "maximum_distance": 200_000},
            "use_ml_eta": True,
            "context": {"weather": "Sunny", "traffic": "Medium"},
        }

    def worker(seed: int):
        rng = random.Random(seed)
        # One persistent HTTP/1.1 connection per worker: measures the
        # server, not per-request TCP/thread setup.
        poster = PersistentPoster(bases[seed % len(bases)])
        for i in range(n_requests):
            try:
                if i % 10 == 9:  # 10% heavy optimize calls
                    dt_s, status, _ = poster.post("/api/optimize_route",
                                                  opt_payload(rng))
                    with lock:
                        opt_lat.append(dt_s)
                else:
                    dt_s, status, _ = poster.post("/api/predict_eta",
                                                  eta_payload(rng))
                    with lock:
                        eta_lat.append(dt_s)
                if status != 200:
                    with lock:
                        errors.append(status)
            except Exception as e:
                poster.reset()
                with lock:
                    errors.append(str(e)[:80])
        poster.close()

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    total = len(eta_lat) + len(opt_lat)
    report = {
        "threads": n_threads,
        "workers": len(bases),
        "requests": total,
        "wall_seconds": round(wall, 2),
        "rps": round(total / wall, 1),
        "errors": len(errors),
        "predict_eta": _percentiles(eta_lat) if eta_lat else {},
        "optimize_route": _percentiles(opt_lat) if opt_lat else {},
    }
    try:
        # one entry per worker — scraping only worker 0 would present
        # ~1/N of the traffic as if it were the whole run's server view
        report["server_metrics"] = [_get(b, "/api/metrics") for b in bases]
    except Exception:
        pass
    return report, errors


def run_vrp_batch_load(bases, n_threads: int, n_requests: int,
                       problems_per_request: int = 32,
                       road_frac: float = 0.25):
    """Batched route OPTIMIZATION phase: many VRPs per request through
    ``/api/optimize_route_batch`` (one vmapped device solve per request
    — the batch-of-problems axis on the serving path). ``road_frac``
    of the problems carry ``road_graph: true``, exercising the grouped
    street-network solves (``RoadRouter.route_legs_batch``) under the
    same budget. Reports problems/sec and per-request latency."""
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    latencies: list = []
    solved = [0]
    road_solved = [0]
    errors: list = []
    lock = threading.Lock()

    def payload(rng):
        items = []
        for _ in range(problems_per_request):
            picks = rng.sample(range(1, len(SEED_LOCATIONS)),
                               rng.randint(2, 6))
            item = {
                "source_point": {"lat": SEED_LOCATIONS[0][1],
                                 "lon": SEED_LOCATIONS[0][2]},
                "destination_points": [
                    {"lat": SEED_LOCATIONS[i][1],
                     "lon": SEED_LOCATIONS[i][2], "payload": 1}
                    for i in picks],
                "driver_details": {"vehicle_capacity": 100,
                                   "maximum_distance": 200_000},
                "refine": rng.random() < 0.5,
            }
            if rng.random() < road_frac:
                item["road_graph"] = True
                item["pickup_time"] = (
                    f"2026-03-02T{rng.randint(0, 23):02d}:30:00")
            items.append(item)
        return {"items": items, "use_ml_eta": True}

    def worker(seed: int):
        rng = random.Random(seed)
        poster = PersistentPoster(bases[seed % len(bases)], timeout=120)
        for _ in range(n_requests):
            try:
                dt_s, status, raw = poster.post("/api/optimize_route_batch",
                                                payload(rng))
                out = json.loads(raw)
                with lock:
                    if status == 200:
                        got = [it for it in out.get("items", [])
                               if isinstance(it, dict)
                               and "error" not in it]
                        latencies.append(dt_s)
                        solved[0] += len(got)
                        road_solved[0] += sum(
                            1 for it in got
                            if (it.get("properties") or {}).get("road_graph"))
                    else:
                        errors.append(status)
            except Exception as e:
                poster.reset()
                with lock:
                    errors.append(str(e)[:80])
        poster.close()

    # untimed warmup per worker base (same rationale as the ETA batch)
    for base in bases:
        warm = PersistentPoster(base, timeout=120)
        try:
            warm.post("/api/optimize_route_batch", payload(random.Random(0)))
        except Exception:
            pass
        warm.close()

    threads = [threading.Thread(target=worker, args=(3000 + s,))
               for s in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat_ms = sorted(x * 1000 for x in latencies)

    def pct(p):
        return round(lat_ms[min(len(lat_ms) - 1,
                                int(p * len(lat_ms)))], 2) if lat_ms else None

    return {
        "problems_per_request": problems_per_request,
        "road_frac": road_frac,
        "threads": n_threads,
        "requests": len(latencies),
        "problems_solved": solved[0],
        "road_problems_solved": road_solved[0],
        "wall_seconds": round(wall, 2),
        "problems_per_s": round(solved[0] / wall, 1) if wall else 0.0,
        "errors": len(errors),
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
    }, errors


def run_road_route_load(bases, n_threads: int, n_requests: int):
    """Road-graph routing phase: ``/api/optimize_route`` with
    ``road_graph: true`` — true shortest paths over the street network,
    repriced by whichever learned leg pricer serves (GNN per-edge or
    route-transformer; the response's ``leg_cost_model`` records which,
    so the artifact shows the transformer path was actually exercised).
    The endpoint class the reference rents from ORS
    (``Flaskr/utils.py:97-109``)."""
    from routest_tpu_torch.data.locations import SEED_LOCATIONS

    latencies: list = []
    errors: list = []
    pricers: dict = {}
    lock = threading.Lock()

    def payload(rng):
        picks = rng.sample(range(1, len(SEED_LOCATIONS)), rng.randint(2, 5))
        return {
            "source_point": {"lat": SEED_LOCATIONS[0][1],
                             "lon": SEED_LOCATIONS[0][2]},
            "destination_points": [
                {"lat": SEED_LOCATIONS[i][1], "lon": SEED_LOCATIONS[i][2],
                 "payload": 1} for i in picks],
            "driver_details": {"vehicle_capacity": 100,
                               "maximum_distance": 200_000},
            "road_graph": True,
            "refine": rng.random() < 0.5,
            "use_ml_eta": True,
            "context": {"weather": "Sunny", "traffic": "Medium"},
        }

    def worker(seed: int):
        rng = random.Random(seed)
        poster = PersistentPoster(bases[seed % len(bases)], timeout=120)
        for _ in range(n_requests):
            try:
                dt_s, status, raw = poster.post("/api/optimize_route",
                                                payload(rng))
                with lock:
                    if status == 200:
                        latencies.append(dt_s)
                        model = json.loads(raw).get("properties", {}).get(
                            "leg_cost_model", "unknown")
                        pricers[model] = pricers.get(model, 0) + 1
                    else:
                        errors.append(status)
            except Exception as e:
                poster.reset()
                with lock:
                    errors.append(str(e)[:80])
        poster.close()

    for base in bases:  # untimed warmup: first road solve builds the graph
        warm = PersistentPoster(base, timeout=180)
        try:
            warm.post("/api/optimize_route", payload(random.Random(0)))
        except Exception:
            pass
        warm.close()

    threads = [threading.Thread(target=worker, args=(5000 + s,))
               for s in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    report = {
        "threads": n_threads,
        "requests": len(latencies),
        "wall_seconds": round(wall, 2),
        "rps": round(len(latencies) / wall, 1) if wall else 0.0,
        "errors": len(errors),
        "leg_cost_models_served": pricers,
        **(_percentiles(latencies) if latencies else {}),
    }
    return report, errors


def run_quantile_probe(bases):
    """Uncertainty-band phase: when the serving artifact carries
    quantile heads, every /api/predict_eta response must include a
    coherent p10 ≤ eta ≤ p90 band. Probes a spread of distances and
    reports coverage + coherence (skipped cleanly for point models)."""
    poster = PersistentPoster(bases[0])
    total, banded, incoherent = 0, 0, 0
    try:
        for dist in (500, 2_000, 8_000, 20_000, 40_000):
            _, status, raw = poster.post("/api/predict_eta", {
                "summary": {"distance": dist},
                "weather": "Stormy", "traffic": "Jam",
                "driver_age": 44,
                "pickup_time": "2026-07-29T18:00:00",
            })
            if status != 200:
                continue
            body = json.loads(raw)
            total += 1
            p10 = body.get("eta_minutes_ml_p10")
            p90 = body.get("eta_minutes_ml_p90")
            eta = body.get("eta_minutes_ml")
            if p10 is not None and p90 is not None:
                banded += 1
                if not (p10 <= eta <= p90):
                    incoherent += 1
    finally:
        poster.close()
    return {"probes": total, "with_band": banded,
            "band_incoherent": incoherent,
            "quantile_model_serving": banded > 0}


def run_latency_decomposition(bases):
    """Per-row vs fixed cost of the batch path. Single-threaded
    ``/api/predict_eta_batch`` at two batch sizes: the slope is the
    server's per-row cost (JSON parse, featurize, device compute,
    serialize), the intercept is the fixed per-request overhead — HTTP
    and dispatch — which no batch size amortizes away."""
    import numpy as np

    poster = PersistentPoster(bases[0], timeout=120)
    sizes = (1024, 16384)
    med = {}
    try:
        rng = random.Random(11)
        for size in sizes:
            payload = {
                "distance_m": [rng.uniform(500, 40_000) for _ in range(size)],
                "weather": ["Sunny"] * size,
                "traffic": ["Medium"] * size,
                "driver_age": [35.0] * size,
                "pickup_time": ["2026-07-29T18:00:00"] * size,
            }
            poster.post("/api/predict_eta_batch", payload)  # warm bucket
            times = []
            for _ in range(5):
                dt_s, status, _ = poster.post("/api/predict_eta_batch",
                                              payload)
                if status == 200:
                    times.append(dt_s)
            if times:
                med[size] = float(np.median(times))
    except Exception:
        pass
    finally:
        poster.close()
    if len(med) != 2:
        return {"error": "decomposition probes failed"}
    b1, b2 = sizes
    slope_s = (med[b2] - med[b1]) / (b2 - b1)
    fixed_s = med[b1] - slope_s * b1
    return {
        "batch_sizes": list(sizes),
        "median_latency_ms": {str(k): round(v * 1000, 2)
                              for k, v in med.items()},
        "per_row_us": round(max(slope_s, 0.0) * 1e6, 3),
        "fixed_overhead_ms": round(max(fixed_s, 0.0) * 1000, 2),
    }


def run_batch_load(bases, n_threads: int, n_requests: int,
                   batch_size: int):
    """North-star phase: OD *batches* through ``/api/predict_eta_batch``.

    The reference serves one OD pair per HTTP request
    (``Flaskr/routes.py:365-383``); BASELINE.json's target is ≥10k
    OD-pair preds/sec through the serving path. Columnar payloads, a few
    persistent connections, preds/sec = rows acknowledged / wall.
    """
    latencies: list = []
    rows_done = [0]
    errors: list = []
    lock = threading.Lock()

    def payload(rng):
        return {
            "distance_m": [rng.uniform(500, 40_000) for _ in range(batch_size)],
            "weather": rng.choice(["Sunny", "Cloudy", "Stormy", "Windy"]),
            "traffic": [rng.choice(["Low", "Medium", "High", "Jam"])
                        for _ in range(batch_size)],
            "driver_age": [rng.uniform(19, 60) for _ in range(batch_size)],
            "pickup_time": "2026-07-29T18:00:00",
        }

    def worker(seed: int):
        rng = random.Random(seed)
        poster = PersistentPoster(bases[seed % len(bases)], timeout=120)
        for _ in range(n_requests):
            try:
                dt_s, status, raw = poster.post("/api/predict_eta_batch",
                                                payload(rng))
                out = json.loads(raw)
                with lock:
                    if status == 200:
                        latencies.append(dt_s)
                        rows_done[0] += out.get("count", 0)
                    else:
                        errors.append(status)
            except Exception as e:
                poster.reset()
                with lock:
                    errors.append(str(e)[:80])
        poster.close()

    # One untimed warmup request PER WORKER: the very first batch
    # through a fresh connection pays one-off setup (TCP + device-path
    # first touch) that is startup cost, not steady-state serving
    # latency. Standard load-testing methodology; the measured phase
    # starts warm on every base.
    for base in bases:
        warm = PersistentPoster(base, timeout=120)
        try:
            warm.post("/api/predict_eta_batch", payload(random.Random(0)))
        except Exception:
            pass
        warm.close()

    threads = [threading.Thread(target=worker, args=(1000 + s,))
               for s in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    report = {
        "batch_size": batch_size,
        "threads": n_threads,
        "requests": len(latencies),
        "rows": rows_done[0],
        "wall_seconds": round(wall, 2),
        "preds_per_s": round(rows_done[0] / wall, 1) if wall else 0.0,
        "errors": len(errors),
        **(_percentiles(latencies) if latencies else {}),
    }
    return report, errors


def run_open_loop_mode(bases, args):
    """The ``--open-loop`` path: delegate arrival scheduling to
    ``routest_tpu_torch/loadgen`` (this script stays the CLI; the engine
    owns the semantics). Reports CO-correct percentiles plus the
    fast-lane cache delta the Zipf key skew produced server-side, and
    the fused launches each worker made over the run."""
    from routest_tpu_torch.loadgen import (RateCurve, ZipfODWorkload,
                                           cache_delta, fetch_metrics,
                                           paced_schedule, poisson_schedule,
                                           summarize)

    curve = RateCurve.constant(args.rate)
    if args.arrival == "poisson":
        offsets = poisson_schedule(curve, args.duration, seed=args.seed)
    else:
        offsets = paced_schedule(curve, args.duration)
    workload = ZipfODWorkload(s=args.zipf_s, seed=args.seed)
    requests = workload.sequence(len(offsets))

    def metrics_all():
        out = {}
        for i, base in enumerate(bases):
            try:
                out[f"w{i}"] = fetch_metrics(base)
            except Exception:
                out[f"w{i}"] = {}
        return {"replica_metrics": out}

    before = metrics_all()
    time.sleep(harness.SETTLE_S)
    records, _ = harness.run_open_loop_process(
        bases, offsets, requests, workers=args.open_workers)
    report = summarize(records, args.duration, len(offsets))
    report["pace"] = harness.pace_check(report)
    report["generator_lagged"] = report["pace"]["generator_lagged"]
    report.update({
        "arrival": curve.spec | {"process": args.arrival},
        "workload": {"kind": "zipf_od", "s": args.zipf_s,
                     "seed": args.seed, "od_pairs": len(workload.pairs)},
        "seed": args.seed,
        "workers": len(bases),
    })
    after = metrics_all()
    report["cache"] = cache_delta(before, after)
    report["fused_launches"] = harness.launch_delta(before, after)
    return report


def main() -> None:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n")[0])
    parser.add_argument("--threads", type=int, default=None,
                        help="concurrent clients (default: min(32, 8 x "
                             "cores) — beyond ~8 in-flight requests per "
                             "core, client-side latency measures queueing "
                             "on the box, not the server; Little's law "
                             "puts the floor at threads/throughput)")
    parser.add_argument("--requests", type=int, default=50,
                        help="requests per thread")
    parser.add_argument("--base-url", default=None,
                        help="target a running server instead of "
                             "self-spawning")
    parser.add_argument("--workers", type=int, default=1,
                        help="self-spawn N server worker processes sharing "
                             "one broker (serve/netbus.py); clients "
                             "round-robin across workers")
    parser.add_argument("--p95-budget-ms", type=float, default=50.0,
                        help="fail if /api/predict_eta client p95 exceeds "
                             "this (0 disables)")
    parser.add_argument("--opt-budget-ms", type=float, default=750.0,
                        help="p95 budget for /api/optimize_route (0 off)")
    parser.add_argument("--road-budget-ms", type=float, default=1500.0,
                        help="p95 budget for road-graph optimize_route "
                             "(0 off)")
    parser.add_argument("--vrp-budget-ms", type=float, default=4000.0,
                        help="p95 budget for /api/optimize_route_batch "
                             "requests (32 VRPs each; 0 off)")
    parser.add_argument("--eta-batch-budget-ms", type=float, default=1000.0,
                        help="p95 budget for /api/predict_eta_batch "
                             "requests (0 off)")
    parser.add_argument("--road-requests", type=int, default=6,
                        help="road-graph requests per road worker "
                             "(0 skips the phase)")
    parser.add_argument("--cpu-budget-scale", type=float, default=8.0,
                        help="budget multiplier applied when the server "
                             "serves on the CPU — the stated budgets are "
                             "the card's (the record names the scaling)")
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU (ROUTEST_DEVICE=cpu); "
                             "without it the script needs a card")
    parser.add_argument("--batch-size", type=int, default=4096,
                        help="OD pairs per /api/predict_eta_batch request "
                             "(0 skips the batch phase)")
    parser.add_argument("--batch-requests", type=int, default=16,
                        help="batch requests per batch worker")
    parser.add_argument("--batch-threads", type=int, default=4,
                        help="concurrent batch clients")
    parser.add_argument("--out", default=None,
                        help="report path (default: artifacts/"
                             "load_test_cuda.json, or artifacts/"
                             "load_test_open_loop_cuda.json with "
                             "--open-loop; under build/ with --cpu)")
    parser.add_argument("--open-loop", action="store_true",
                        help="open-loop mode via routest_tpu_torch/loadgen: "
                             "a seeded arrival schedule at --rate rps "
                             "fired independently of the server, "
                             "latency from INTENDED send time "
                             "(coordinated-omission-correct). Replaces "
                             "the closed-loop phases.")
    parser.add_argument("--rate", type=float, default=50.0,
                        help="open-loop offered rate in requests/s")
    parser.add_argument("--duration", type=float, default=30.0,
                        help="open-loop run length in seconds")
    parser.add_argument("--arrival", choices=("poisson", "paced"),
                        default="poisson",
                        help="open-loop arrival process (poisson = "
                             "memoryless users; paced = deterministic)")
    parser.add_argument("--zipf-s", type=float, default=1.1,
                        help="open-loop OD-key skew exponent (0 = "
                             "uniform)")
    parser.add_argument("--seed", type=int, default=42,
                        help="open-loop schedule + workload seed (same "
                             "seed ⇒ identical offered load)")
    parser.add_argument("--open-workers", type=int, default=64,
                        help="open-loop sender threads")
    args = parser.parse_args()
    device = harness.require_card(args.cpu, "load_test_cuda")

    # A supervisor timeout (SIGTERM) must still tear down the spawned
    # server subprocesses; SystemExit rides the cleanup below.
    import signal as _signal

    _signal.signal(_signal.SIGTERM, lambda *_: sys.exit(143))

    server_procs = []
    broker = None
    if args.base_url:
        if args.workers > 1:
            parser.error("--workers spawns local servers and cannot be "
                         "combined with --base-url (target N external "
                         "workers by running one load_test per base)")
        bases = [args.base_url.rstrip("/")]
    else:
        # Servers run in SUBPROCESSES: an in-process server would share
        # the load generator's GIL, inflating client-side percentiles
        # with generator scheduling delay rather than measuring the
        # server. --workers N spawns N processes sharing one broker.
        import subprocess

        env = harness.server_env(device)
        n_workers = max(1, args.workers)
        if n_workers > 1:
            from routest_tpu_torch.serve.netbus import start_broker

            broker, _ = start_broker()
            env["REDIS_URL"] = f"tcp://127.0.0.1:{broker.port}"
            print(f"[load_test_cuda] broker at {env['REDIS_URL']}")
        # outside the ephemeral range: no client TIME_WAIT holds them
        ports = [harness.free_port() for _ in range(n_workers)]
        for port in ports:
            e = dict(env)
            e["PORT"] = str(port)
            server_procs.append(subprocess.Popen(
                [sys.executable, "-m", "routest_tpu_torch.serve"], env=e,
                cwd=REPO))
        bases = [f"http://127.0.0.1:{p}" for p in ports]
        print(f"[load_test_cuda] spawned {n_workers} server worker(s) on "
              f"{device}: {', '.join(bases)}")
        deadline = time.time() + 240  # first boot builds the kernel
        for base in bases:
            while True:
                try:
                    if _get(base, "/api/ping", timeout=2).get("ok"):
                        break
                except Exception:
                    pass
                if any(p.poll() is not None for p in server_procs):
                    print("[load_test_cuda] a server process died",
                          file=sys.stderr)
                    _stop(server_procs, broker)
                    sys.exit(2)
                if time.time() > deadline:
                    print("[load_test_cuda] server never became ready",
                          file=sys.stderr)
                    _stop(server_procs, broker)
                    sys.exit(2)
                time.sleep(0.5)

    suffix = "cuda" if device == "cuda" else "cpu"
    where = "artifacts" if device == "cuda" else "build"
    if args.open_loop:
        try:
            report = run_open_loop_mode(bases, args)
            report["card"] = harness.card_identity(device)
            report["server"] = _server_scoring(bases[0])
        finally:
            _stop(server_procs, broker)
        print(json.dumps(report, indent=2))
        out = args.out or os.path.join(
            REPO, where, f"load_test_open_loop_{suffix}.json")
        harness.write_record(out, report)
        pace = report["pace"]
        print(f"[load_test_cuda] open-loop report → {out}; send_delay "
              f"p99 {pace['send_delay_p99_ms']} ms, limit "
              f"{pace['pace_limit_ms']} ms, generator lagged "
              f"{pace['generator_lagged']}", file=sys.stderr)
        sys.exit(1 if report["errors"] or pace["generator_lagged"]
                 else 0)

    try:
        cores = os.cpu_count() or 1
        n_threads = args.threads if args.threads else min(32, 8 * cores)
        if n_threads > 8 * cores:
            print(f"[load_test_cuda] WARNING: {n_threads} threads on "
                  f"{cores} core(s): client p95 will be dominated by host "
                  f"queueing", file=sys.stderr)
        report, errors = run_load(bases, n_threads, args.requests)
        if args.batch_size > 0:
            batch_report, batch_errors = run_batch_load(
                bases, args.batch_threads, args.batch_requests,
                args.batch_size)
            report["predict_eta_batch"] = batch_report
            errors.extend(batch_errors)
            vrp_report, vrp_errors = run_vrp_batch_load(
                bases, args.batch_threads, max(4, args.batch_requests // 2))
            report["optimize_route_batch"] = vrp_report
            errors.extend(vrp_errors)
        if args.road_requests > 0:
            # 2 clients: road solves are device-wide (one shortest-path
            # batch each); beyond ~2 in flight the tail measures queue
            # depth, not the solver.
            road_report, road_errors = run_road_route_load(
                bases, min(2, n_threads), args.road_requests)
            report["optimize_route_road"] = road_report
            errors.extend(road_errors)
        report["quantile_band"] = run_quantile_probe(bases)
        report["latency_decomposition"] = run_latency_decomposition(bases)
        report["server"] = _server_scoring(bases[0])
        report["card"] = harness.card_identity(device)
    finally:
        _stop(server_procs, broker)
    report["cpu_count"] = cores
    # Self-describing measurement regime: every phase above is closed-
    # loop (clients self-throttle to the server's pace), which under-
    # reports tails under overload — the open-loop record is the one
    # that binds there (docs/LOADGEN.md).
    report["loop"] = "closed"
    # The budgets bind at full strength on the card; a CPU server gets
    # them scaled (the record says by how much).
    on_card = str(report["server"].get("device", "")).startswith("cuda")
    scale = 1.0 if on_card else max(args.cpu_budget_scale, 1.0)
    report["budget_scale"] = scale
    budgets = {
        "predict_eta": args.p95_budget_ms,      # binds unscaled everywhere
        "optimize_route": args.opt_budget_ms * scale,
        "optimize_route_road": args.road_budget_ms * scale,
        "optimize_route_batch": args.vrp_budget_ms * scale,
        "predict_eta_batch": args.eta_batch_budget_ms * scale,
    }
    budget_failures = []
    for section, budget in budgets.items():
        sec = report.get(section)
        if not sec or not budget:
            continue
        p95 = sec.get("p95_ms")
        ok = p95 is not None and p95 <= budget
        sec["p95_budget_ms"] = budget
        sec["within_budget"] = bool(ok)
        if not ok:
            budget_failures.append((section, p95, budget))
    budget_ok = not budget_failures
    report["p95_budget_ms"] = args.p95_budget_ms
    report["p95_within_budget"] = bool(
        report.get("predict_eta", {}).get("within_budget",
                                          not args.p95_budget_ms))
    preds_s = report.get("predict_eta_batch", {}).get("preds_per_s")
    if preds_s is not None:
        report["north_star_preds_per_s"] = preds_s
        report["north_star_met"] = bool(preds_s >= 10_000)
    print(json.dumps(report, indent=2))
    if errors:
        print(f"first errors: {errors[:5]}", file=sys.stderr)
    for section, p95, budget in budget_failures:
        print(f"FAIL: {section} p95 {p95} ms exceeds budget {budget} ms",
              file=sys.stderr)
    out = args.out or os.path.join(REPO, where, f"load_test_{suffix}.json")
    harness.write_record(out, report)
    print(f"[load_test_cuda] report → {out}", file=sys.stderr)
    sys.exit(1 if errors or not budget_ok else 0)


def _server_scoring(base):
    """The serving device and kernel health names (``checks.model.
    scoring``), or the error that kept them from being read."""
    try:
        scoring = _get(base, "/api/health")["checks"]["model"]["scoring"]
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"[:200]}
    return {k: scoring.get(k) for k in ("device", "kernel", "dtype")}


def _stop(procs, broker):
    """Terminate the spawned servers (and wait), then the broker."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except Exception:
            p.kill()
    if broker is not None:
        broker.shutdown()
        broker.server_close()


if __name__ == "__main__":
    main()
