"""Many-query device batching curve on the card →
artifacts/batch_solve_cuda.json.

The port's counterpart of ``scripts/bench_batch_solve.py``. The router's
solve is batched over the source axis by construction; this measures
what that is worth on the card: K concurrent point queries merged into
ONE solve against K scalar solves of the same program, at oracle parity
(scipy Dijkstra in float64). Two measurements per K, best of 3:

- ``merged``: one ``RoadRouter._solve_rows`` call with K sources (what
  the ``_SolveBatcher`` dispatches after coalescing K concurrent
  ``shortest`` calls);
- ``scalar``: K sequential 1-source calls (each padded to bucket 1).

Then 8 worker threads of 1-source ``shortest`` calls through the live
batcher, recording the merged occupancy it reached.

The router runs on the card under ``ROUTEST_ROUTER_AOT``'s default, as
the JAX script keeps its AOT default: buckets 2 and 16 replay CUDA
graphs captured at init, every other bucket (bucket 1, so every scalar
solve) runs eagerly. The record copies ``solver_info``'s
``aot_buckets`` and marks each K whose merged solve replayed a graph.

One judge (:func:`judge`) decides: the JAX script's pass rule and the
JAX slow test's assertions (``tests/test_router_fastlane_bench.py::
test_batch_solve_quick``), each a named check. The record names the card
and its power limit. ``--cpu`` runs the router on the CPU for a
rehearsal; without a card and without ``--cpu`` the script exits 2.

Usage: python3 scripts/bench_batch_solve_cuda.py [--nodes 250000]
       [--quick] [--cpu] [--no-verify] [--ks 1 2 4 8 16 32]
       [--threads 8] [--out artifacts/batch_solve_cuda.json]
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

# The JAX script's plan (bench_batch_solve.py:37-205).
KS = [1, 2, 4, 8, 16, 32]
THREADS = 8
NODES = 250_000
QUICK_NODES = 50_000
SOURCE_SEED = 11
BEST_OF = 3
N_PER_THREAD = 6
LAT_RANGE, LON_RANGE = (14.40, 14.68), (120.96, 121.10)
# Its pass rule (:176-185) and the slow test's bounds.
ORACLE_RTOL = 1e-5
K_AMORTIZED = 8
SPEEDUP_PEAK = 1.5
SPEEDUP_FLOOR = 1.2
MIN_OCCUPANCY = 2


def judge(report: dict) -> dict:
    """The JAX verdict on a record, as named checks: the script's pass
    rule (oracle parity on every row; past K=8 merged beats scalar by
    ≥ 1.5× somewhere and ≥ 1.2× everywhere; no worker error) and the
    slow test's assertions (K=8 itself ≥ 1.5×, the merged rate grows
    from K=1 to the largest K, the threads shared dispatches at an
    occupancy ≥ 2, a host caveat)."""
    rows = report["rows"]
    by_k = {r["k"]: r for r in rows}
    big = [r for r in rows if r["k"] >= K_AMORTIZED]
    th = report["threaded"]
    checks = {
        "oracle_parity": all(r.get("oracle_max_rel_err", 0.0)
                             <= ORACLE_RTOL for r in rows),
        "merged_ge_1_5x_past_k8": bool(big) and max(
            r["speedup"] for r in big) >= SPEEDUP_PEAK,
        "merged_ge_1_2x_every_k_past_8": bool(big) and all(
            r["speedup"] >= SPEEDUP_FLOOR for r in big),
        "k8_speedup_ge_1_5x": (K_AMORTIZED in by_k and by_k[K_AMORTIZED][
            "speedup"] >= SPEEDUP_PEAK),
        "merged_rate_grows_with_k": (1 in by_k and by_k[max(by_k)][
            "merged_solves_per_s"] > by_k[1]["merged_solves_per_s"]),
        "threads_no_errors": not th["errors"],
        "threads_shared_dispatches": th["dispatches"] < th["solves"],
        "threads_occupancy_ge_2": th["max_occupancy"] >= MIN_OCCUPANCY,
        "host_caveat_present": bool(report.get("host_caveat")),
    }
    return {k: bool(v) for k, v in checks.items()}


def host_caveat(device: str, n_cpus: int) -> str:
    if device == "cpu":
        return (f"cpu-backend record on {n_cpus} core(s): compare the "
                f"K-scaling ratios, not wall ms")
    return (f"card record on a {n_cpus}-core host that preps each solve's "
            f"sources and takes its fetch: compare the K-scaling ratios; "
            f"wall ms include the host's share")


def k_ladder(router, sources, ks, verify: bool) -> list:
    """Per K: best-of-3 merged (one solve of K sources) against best-of-3
    scalar (K one-source solves), and the oracle gap of the merged
    answer."""
    aot = set(router.solver_info.get("aot_buckets") or ())
    rows = []
    for k in ks:
        sub = sources[:k]
        router._solve_rows(sub)                    # warm the bucket
        merged = []
        for _ in range(BEST_OF):
            t0 = time.perf_counter()
            router._solve_rows(sub)
            merged.append(time.perf_counter() - t0)
        router._solve_rows(sub[:1])
        scalar = []
        for _ in range(BEST_OF):
            t0 = time.perf_counter()
            for i in range(k):
                router._solve_rows(sub[i:i + 1])
            scalar.append(time.perf_counter() - t0)
        bucket = 1 << max(0, k - 1).bit_length()
        row = {
            "k": k,
            "merged_ms": round(1000 * min(merged), 2),
            "scalar_ms": round(1000 * min(scalar), 2),
            "merged_solves_per_s": round(k / min(merged), 2),
            "scalar_solves_per_s": round(k / min(scalar), 2),
            "speedup": round(min(scalar) / min(merged), 3),
            "bucket": bucket,
            "merged_replayed_graph": bucket in aot,
        }
        if verify:
            dist, _ = router._solve_rows(sub)
            row["oracle_max_rel_err"] = harness.oracle_max_rel_err(
                router, sub, dist)
        rows.append(row)
        print(f"  K={k:>3}: merged {row['merged_ms']}ms "
              f"({row['merged_solves_per_s']}/s"
              f"{', graph' if row['merged_replayed_graph'] else ''}) vs "
              f"scalar {row['scalar_ms']}ms — {row['speedup']}x"
              + (f" | oracle {row['oracle_max_rel_err']:.1e}"
                 if verify else ""), flush=True)
    return rows


def threaded(router, sources, n_threads: int) -> dict:
    """``n_threads`` workers, each ``N_PER_THREAD`` one-source
    ``shortest`` calls through the live batcher, released together."""
    k_max = len(sources)
    barrier = threading.Barrier(n_threads)
    errors: list = []

    def worker(tid: int) -> None:
        try:
            barrier.wait(timeout=60)
            for i in range(N_PER_THREAD):
                j = (tid + i) % k_max
                router.shortest(sources[j:j + 1])
        except Exception as e:  # recorded below: the bench must fail
            errors.append(repr(e))

    router.shortest(sources[:1])                   # warm bucket 1
    before = router._solve_batcher.stats()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    after = router._solve_batcher.stats()
    total = n_threads * N_PER_THREAD
    return {
        "threads": n_threads,
        "solves": total,
        "wall_s": round(wall, 3),
        "solves_per_s": round(total / wall, 2),
        "dispatches": after["dispatches"] - before["dispatches"],
        "merged_requests": (after["merged_requests"]
                            - before["merged_requests"]),
        "max_occupancy": after["max_occupancy"],
        "errors": errors,
    }


def apply_quick(args) -> None:
    """The JAX script's --quick: the 50k extract."""
    args.nodes = min(args.nodes, QUICK_NODES)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nodes", type=int, default=NODES)
    parser.add_argument("--quick", action="store_true",
                        help="50k extract — the slow-test preset")
    parser.add_argument("--ks", type=int, nargs="+", default=list(KS))
    parser.add_argument("--threads", type=int, default=THREADS)
    parser.add_argument("--no-verify", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run the router on the CPU; without it the "
                             "script needs a card")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "batch_solve_cuda.json; build/"
                             "batch_solve_cpu.json with --cpu)")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    device = harness.require_card(args.cpu, "bench_batch_solve_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "batch_solve_cuda.json") \
            if device == "cuda" \
            else os.path.join(REPO, "build", "batch_solve_cpu.json")
    if args.quick:
        apply_quick(args)
    import numpy as np

    from routest_tpu_torch.optimize.road_router import RoadRouter

    t_start = time.time()
    streets = harness.metro_streets(args.nodes)
    print(f"[1/3] building router ({args.nodes:,} requested nodes) on "
          f"{device}…", flush=True)
    t0 = time.perf_counter()
    router = RoadRouter(graph=streets, use_gnn=False, use_transformer=False,
                        device=device)
    build_s = time.perf_counter() - t0
    info = router.solver_info

    rng = np.random.default_rng(SOURCE_SEED)
    k_max = max(args.ks)
    sources = router.snap(np.stack([
        rng.uniform(*LAT_RANGE, k_max),
        rng.uniform(*LON_RANGE, k_max)], axis=1).astype(np.float32))

    print("[2/3] K ladder (merged one-dispatch vs scalar dispatches)…",
          flush=True)
    rows = k_ladder(router, sources, args.ks, not args.no_verify)

    print(f"[3/3] {args.threads} threads through the live batcher…",
          flush=True)
    th = threaded(router, sources, args.threads)
    print(f"  {th['solves']} solves in {th['wall_s']}s over "
          f"{th['dispatches']} dispatches (max occupancy "
          f"{th['max_occupancy']})", flush=True)

    card = harness.card_identity(device)
    report = {
        "backend": device,
        "host": {"cpus": card["cpu_count"]},
        "host_caveat": host_caveat(device, card["cpu_count"]),
        "card": card,
        "quick": bool(args.quick),
        "nodes": int(router.n_nodes),
        "edges": int(len(router.senders)),
        "router_build_s": round(build_s, 2),
        "solver": info.get("solver"),
        "aot_buckets": info.get("aot_buckets", []),
        "aot_compile_s": info.get("aot_compile_s"),
        "scalar_bucket": 1,
        "config": {"nodes_requested": args.nodes, "ks": args.ks,
                   "threads": args.threads, "verify": not args.no_verify,
                   "source_seed": SOURCE_SEED, "best_of": BEST_OF},
        "rows": rows,
        "threaded": th,
    }
    report["checks"] = judge(report)
    report["pass"] = all(report["checks"].values())
    report["wall_s"] = round(time.time() - t_start, 1)
    harness.write_record(args.out, report)
    failed = [k for k, v in report["checks"].items() if not v]
    print(f"\nbatched-solve curve → {args.out} (pass={report['pass']}"
          + (f", failed {failed}" if failed else "") + ")", flush=True)
    sys.exit(0 if report["pass"] else 1)


if __name__ == "__main__":
    main()
