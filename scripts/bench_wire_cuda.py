"""Binary wire serving on the card, end to end →
artifacts/wire_cuda.json.

The port's counterpart of ``scripts/bench_wire.py``, on a real fleet of
the port:

- ``micro``         one ``python -m routest_tpu_torch.serve`` on the card
                    (``RTPU_WIRE=1``, its own ``RTPU_WIRE_PORT``) behind
                    the port's in-process ``Gateway``. The JAX script's
                    gates: bitwise wire↔JSON parity through the gateway;
                    ≥ 2× rows/s over JSON on small (≤ 64-row) batches;
                    gateway-added p95 (via-gateway wire p95 minus the
                    direct channel's) under 1 ms; ≥ 100k ETA rows/s
                    sustained through one gateway on 1024-row open-loop
                    frames; and the channel carried the traffic
                    (connection reuse, not per-request HTTP). The closed
                    loops and the latency samples run in this process
                    beside the gateway, as in the JAX script; the
                    open-loop frames are sent from processes of their
                    own (:func:`cuda_harness.run_open_loop_process`), and
                    a run whose generator lagged (:func:`cuda_harness.
                    pace_check`) fails the sustained check, the one that
                    reads its latencies.
- ``probe_parity``  a live two-replica fleet of the port on the card
                    (:class:`cuda_harness.Fleet`) with the wire format
                    armed: open-loop binary load while ≥ 1 metric flip
                    and ≥ 1 verified model swap land, the prober's
                    ``wire`` kind watching. ``correctness:wire`` must
                    never page.

Every real replica scores through the fused kernel; the record adds the
launches they made (``launches``) and the card's name and power limit.
``--cpu`` serves on the CPU for a rehearsal; without a card and without
``--cpu`` the script exits 2.

Usage: python3 scripts/bench_wire_cuda.py [--quick] [--cpu]
       [--nodes 6000] [--scenario micro|probe_parity]
       [--out artifacts/wire_cuda.json] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
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
WIRE_CT = "application/x-rtpu-wire"

# Acceptance gates, the JAX script's (bench_wire.py:46-49).
SPEEDUP_MIN = 2.0            # wire vs JSON rows/s, small batches
GW_OVERHEAD_P95_MS = 1.0     # via-gateway minus direct-channel
SUSTAINED_ROWS_PER_S = 100_000.0

# The JAX script's measurement plan (bench_wire.py:175-350, 351-460).
SMALL_BATCHES = (8, 64)
SUSTAINED_ROWS, SUSTAINED_RATE = 1024, 130.0
PROBE_RATE, PROBE_ROWS = 4.0, 64
HOST_NOTE = ("rows/s and p95s are host numbers: the gateway, the closed "
             "loops' clients and the replica's HTTP and channel servers "
             "share the card's host; the structural checks (bitwise "
             "parity, channel reuse, probe green across flip and swap) "
             "do not depend on it")


def phase_sizes(quick: bool) -> dict:
    """The JAX script's windows, sample counts and durations."""
    return {"window_s": 3.0 if quick else 8.0,
            "overhead_samples": 150 if quick else 400,
            "sustained_s": 6.0 if quick else 15.0,
            "probe_s": 90.0 if quick else 180.0,
            "transition_s": 90 if quick else 150}


def _family_total(name: str, where=None) -> float:
    from routest_tpu_torch.obs.registry import get_registry

    fam = get_registry().get(name)
    if fam is None:
        return 0.0
    total = 0.0
    for key, child in fam.items():
        if where is None or where(key):
            total += child.value
    return total


def _p50_ms(lat_s) -> float:
    ok = sorted(lat_s)
    return ok[len(ok) // 2] * 1000.0 if ok else float("nan")


def _p95_ms(lat_s) -> float:
    ok = sorted(lat_s)
    if not ok:
        return float("nan")
    return ok[min(len(ok) - 1, int(0.95 * len(ok)))] * 1000.0


def micro_checks(out: dict) -> dict:
    """The JAX ``micro`` checks from its record (names and gates); the
    sustained check also needs a generator that kept its pace, where the
    record has one (the JAX record sent in-process and keeps none)."""
    gw = out["gateway_overhead"]
    sus = out["sustained"]
    pace = sus.get("pace") or {"generator_lagged": False}
    return {
        "parity_exact": bool(out["parity"]["ok"]),
        "speedup_small_batches_ge_2x":
            out["speedup_small_batches"] >= SPEEDUP_MIN,
        "gateway_overhead_p95_lt_1ms":
            gw["p95_via_gateway_ms"] - gw["p95_direct_ms"]
            < GW_OVERHEAD_P95_MS,
        "sustained_ge_100k_rows_per_s": harness.passed(
            sus["rows_per_s"] >= SUSTAINED_ROWS_PER_S, pace),
        "channel_carried_traffic": out["channel"]["frames_sent"] > 0,
        "connections_reused": out["channel"]["reuse_ratio"] > 0.9,
    }


def probe_checks(out: dict) -> dict:
    """The JAX ``probe_parity`` checks from its record."""
    load = out["load"]
    total = load["ok"] + load["errors"]
    return {
        "wire_kind_armed": bool(out["wire_kind_armed"]),
        "verified_swap_ge_1": out["swaps_accepted"] >= 1,
        "metric_flip_ge_1": out["metric_flips"] >= 1,
        "wire_probe_green": out["wire_verdict"] == "pass",
        "correctness_wire_never_paged":
            out["correctness_wire_state"] == "ok",
        "binary_load_served": load["ok"] > 0
        and load["ok"] >= 0.9 * max(total, 1),
    }


# ── micro scenario ───────────────────────────────────────────────────


def _closed_loop(base: str, requests, duration_s: float,
                 workers: int = 4):
    """→ (ok_count, err_count, elapsed_s): keep-alive closed loop over
    a fixed request cycle — both formats pay the same client."""
    from routest_tpu_torch.loadgen import KeepAliveClient

    t0 = time.monotonic()
    stop_at = t0 + duration_s
    ok = [0] * workers
    err = [0] * workers

    def run(w: int) -> None:
        client = KeepAliveClient(base, timeout=30.0)
        i = w
        while time.monotonic() < stop_at:
            try:
                status, _ = client.send(requests[i % len(requests)])
            except Exception:
                status = -1
            if status == 200:
                ok[w] += 1
            else:
                err[w] += 1
            i += workers
        client.close()

    threads = [threading.Thread(target=run, args=(w,))
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(ok), sum(err), time.monotonic() - t0


def _parity_check(base: str) -> dict:
    """Golden body over both content-types through ``base`` — the
    prober's own bitwise compare, run once as a hard gate."""
    import numpy as np

    from routest_tpu_torch.obs.prober import (_http_json, _http_wire,
                                              eta_columns,
                                              golden_probe_body,
                                              golden_wire_frame)
    from routest_tpu_torch.serve import wirecodec as wc

    url = f"{base}/api/predict_eta_batch"
    payload, _ = _http_json("POST", url, golden_probe_body(), 60.0,
                            probe="")
    raw, _ = _http_wire(url, golden_wire_frame(), 60.0, probe="")
    wire = wc.decode_eta_response(raw)
    minutes = np.asarray(wire["minutes"], np.float64)
    finite = np.isfinite(minutes)
    got = {"eta_minutes_ml": np.where(finite, np.round(minutes, 4),
                                      np.nan)}
    for lvl, vals in wire["bands"].items():
        ok = finite & np.isfinite(np.asarray(vals))
        got[f"eta_minutes_ml_{lvl}"] = np.where(
            ok, np.round(vals, 4), np.nan)
    jcols = eta_columns(payload)
    cols_equal = sorted(got) == sorted(jcols) and all(
        got[k].tobytes() == jcols[k].tobytes() for k in jcols)
    iso = np.datetime_as_string(
        np.asarray(wire["completion_ms"],
                   np.int64).astype("datetime64[ms]"), unit="s")
    wire_iso = [str(s) if f else None for s, f in zip(iso, finite)]
    iso_equal = wire_iso == payload.get("eta_completion_time_ml")
    return {"rows": int(len(minutes)),
            "columns": sorted(got),
            "columns_bitwise_equal": bool(cols_equal),
            "completion_equal": bool(iso_equal),
            "ok": bool(cols_equal and iso_equal)}


def scenario_micro(args) -> dict:
    from routest_tpu_torch.core.config import FleetConfig
    from routest_tpu_torch.loadgen import (KeepAliveClient, MixedWorkload,
                                           PlannedRequest, RateCurve,
                                           paced_schedule, summarize)
    from routest_tpu_torch.serve.fleet.gateway import Gateway
    from routest_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
    from routest_tpu_torch.serve.wirechannel import WireChannelClient

    sizes = phase_sizes(args.quick)
    out: dict = {"scenario": "micro"}
    port = harness.free_port()
    chan_port = harness.free_port()
    env = harness.server_env(args.device, ROUTEST_MESH="0",
                             ETA_MODEL_PATH=MODEL, RTPU_WIRE="1",
                             RTPU_WIRE_PORT=str(chan_port))
    # the in-process gateway reads the wire config from this process
    os.environ["RTPU_WIRE"] = "1"
    os.environ["RTPU_WIRE_PORT"] = str(chan_port)
    sup = ReplicaSupervisor([port], env=env, cwd=REPO,
                            probe_interval_s=0.5, backoff_base_s=0.2,
                            backoff_cap_s=2.0)
    sup.start()
    gw = None
    try:
        if not sup.ready(timeout=600):
            raise RuntimeError("worker never became ready")
        frames0 = _family_total("rtpu_wire_frames_total",
                                lambda key: "sent" in key)
        gw = Gateway([("127.0.0.1", port)], FleetConfig(hedge=False),
                     supervisor=sup)
        httpd = gw.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"

        # (1) exact parity through the gateway — hard gate.
        out["parity"] = _parity_check(base)

        # (2) small-batch throughput, wire vs JSON, same seeded rows.
        thr: dict = {}
        for rows in SMALL_BATCHES:
            per_mode = {}
            for mode in ("json", "binary"):
                wl = MixedWorkload(mix={"predict_eta_batch": 1.0},
                                   seed=11, batch_rows=rows,
                                   wire_format=mode)
                reqs = wl.sequence(64)
                n_ok, n_err, elapsed = _closed_loop(
                    base, reqs, sizes["window_s"])
                per_mode[mode] = {
                    "ok": n_ok, "err": n_err,
                    "req_per_s": round(n_ok / elapsed, 1),
                    "rows_per_s": round(n_ok * rows / elapsed, 1)}
            ratio = (per_mode["binary"]["rows_per_s"]
                     / max(per_mode["json"]["rows_per_s"], 1e-9))
            thr[str(rows)] = {**per_mode, "speedup": round(ratio, 2)}
        out["throughput"] = thr
        out["speedup_small_batches"] = round(
            min(thr[k]["speedup"] for k in thr), 2)

        # (3) gateway-added overhead: via-gateway wire p95 minus
        # direct-channel p95 on the same 64-row frame.
        wl = MixedWorkload(mix={"predict_eta_batch": 1.0}, seed=13,
                           batch_rows=64, wire_format="binary")
        frame = wl.sequence(1)[0].body
        n = sizes["overhead_samples"]
        preq = PlannedRequest(method="POST",
                              path="/api/predict_eta_batch",
                              body=frame, route="predict_eta_batch",
                              content_type=WIRE_CT)
        direct = WireChannelClient("127.0.0.1", chan_port)
        gw_client = KeepAliveClient(base, timeout=30.0)

        def one_direct() -> float:
            t0 = time.perf_counter()
            status, _body = direct.request("/api/predict_eta_batch",
                                           frame, timeout=30.0)
            if status != 200:
                raise RuntimeError(f"direct channel answered {status}")
            return time.perf_counter() - t0

        def one_gw() -> float:
            t0 = time.perf_counter()
            status, _body = gw_client.send(preq)
            if status != 200:
                raise RuntimeError(f"the gateway answered {status}")
            return time.perf_counter() - t0

        # Interleaved sampling: host drift (GC, scheduler) lands on
        # both legs equally instead of biasing whichever ran second.
        for _ in range(30):   # steady-state both paths first
            one_direct(), one_gw()
        lat_direct, lat_gw = [], []
        for _ in range(n):
            lat_direct.append(one_direct())
            lat_gw.append(one_gw())
        direct.close()
        gw_client.close()
        p95_direct = _p95_ms(lat_direct)
        p95_gw = _p95_ms(lat_gw)
        out["gateway_overhead"] = {
            "p95_direct_ms": round(p95_direct, 3),
            "p95_via_gateway_ms": round(p95_gw, 3),
            "added_p95_ms": round(p95_gw - p95_direct, 3),
            "budget_ms": GW_OVERHEAD_P95_MS,
            "samples": n,
            "p50_direct_ms": round(_p50_ms(lat_direct), 3),
            "p50_via_gateway_ms": round(_p50_ms(lat_gw), 3)}

        # (4) sustained rows/s through ONE gateway: open-loop
        # 1024-row binary frames (CO-correct pacing), sent from
        # processes of their own.
        duration = sizes["sustained_s"]
        wl = MixedWorkload(mix={"predict_eta_batch": 1.0}, seed=17,
                           batch_rows=SUSTAINED_ROWS, wire_format="binary")
        offsets = paced_schedule(RateCurve.constant(SUSTAINED_RATE),
                                 duration)
        reqs = wl.sequence(min(len(offsets), 64))
        reqs = [reqs[i % len(reqs)] for i in range(len(offsets))]
        time.sleep(harness.SETTLE_S)
        records, _ = harness.run_open_loop_process(
            [base], offsets, reqs, workers=16, timeout=60.0)
        ok = [r for r in records if r.status == 200]
        span = max((r.offset_s + r.latency_s for r in ok),
                   default=duration)
        sustained = len(ok) * SUSTAINED_ROWS / max(span, 1e-9)
        out["sustained"] = {
            "rows_per_frame": SUSTAINED_ROWS,
            "offered_rps": SUSTAINED_RATE,
            "duration_s": duration,
            "ok": len(ok), "errors": len(records) - len(ok),
            "p95_ms": round(_p95_ms([r.latency_s for r in ok]), 2),
            "rows_per_s": round(sustained, 0),
            "floor_rows_per_s": SUSTAINED_ROWS_PER_S,
            "pace": harness.pace_check(summarize(records, duration,
                                                 len(offsets)))}

        # (5) the channel carried it: frames sent over the persistent
        # channel, and connection reuse ≈ total (not one conn per req).
        frames = _family_total("rtpu_wire_frames_total",
                               lambda key: "sent" in key) - frames0
        reused = _family_total("rtpu_wire_conns_total",
                               lambda key: "reused" in key)
        fresh = _family_total("rtpu_wire_conns_total",
                              lambda key: "fresh" in key)
        out["channel"] = {
            "frames_sent": int(frames),
            "conns_reused": int(reused),
            "conns_fresh": int(fresh),
            "reuse_ratio": round(reused / max(reused + fresh, 1), 4)}
        out["launches"] = harness.fleet_launches(base)
        out["checks"] = micro_checks(out)
        out["pass"] = all(out["checks"].values())
    finally:
        os.environ.pop("RTPU_WIRE_PORT", None)
        if gw is not None:
            gw.drain(timeout=5)
        sup.drain(timeout=15)
    return out


# ── probe parity across flip + swap ──────────────────────────────────


def scenario_probe_parity(args, extract: str) -> dict:
    from routest_tpu_torch.loadgen import (MixedWorkload, RateCurve,
                                           paced_schedule, summarize)

    sizes = phase_sizes(args.quick)
    out: dict = {"scenario": "probe_parity"}
    os.environ["RTPU_WIRE"] = "1"
    work = tempfile.mkdtemp(prefix="wire-probe-")
    fleet = harness.Fleet(live=True, extract=extract,
                          cache_dir=args.cache_dir, work_dir=work,
                          device=args.device, probe_interval=1.0)
    try:
        prober = fleet.arm_prober()
        out["wire_kind_armed"] = "wire" in prober.kinds

        # Open-loop binary load for the whole transition window.
        stop = threading.Event()
        duration = sizes["probe_s"]
        wl = MixedWorkload(mix={"predict_eta_batch": 1.0}, seed=23,
                           batch_rows=PROBE_ROWS, wire_format="binary")
        offsets = paced_schedule(RateCurve.constant(PROBE_RATE), duration)
        base_reqs = wl.sequence(64)
        reqs = [base_reqs[i % len(base_reqs)]
                for i in range(len(offsets))]
        records: list = []
        started = threading.Event()

        def load_thread() -> None:
            records.extend(harness.run_open_loop_process(
                [fleet.base], offsets, reqs, workers=4, timeout=60.0,
                stop=stop, started=started)[0])

        loader = threading.Thread(target=load_thread)
        loader.start()
        started.wait(timeout=120)

        # A verified model swap: within-gate perturbation, both
        # replicas' reload watchers land it through the golden gate.
        harness.map_artifact(fleet.model_path, fleet.model_path,
                             lambda x: x * (1.0 + 1e-4))
        st = os.stat(fleet.model_path)
        os.utime(fleet.model_path,
                 ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))

        def swaps_accepted() -> int:
            total = 0
            for p in fleet.ports:
                reg = harness.fetch(f"http://127.0.0.1:{p}/api/metrics",
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

        # ≥1 legitimate metric flip: probe drivers stream real
        # observations, the live pipeline customizes a new epoch.
        epoch0 = top_epoch()
        fleet.start_probe_drivers()
        deadline = time.time() + sizes["transition_s"]
        swaps = flips = 0
        while time.time() < deadline and (swaps < 1 or flips < 1):
            swaps = swaps_accepted()
            flips = top_epoch() - epoch0
            time.sleep(1.0)
        time.sleep(6 * fleet.prober_cfg.interval_s)  # post-flip rounds
        stop.set()
        loader.join(timeout=120)
        out["swaps_accepted"] = swaps
        out["metric_flips"] = flips

        snap = fleet.prober.snapshot()
        wire_state = snap["probes"].get("wire", {})
        slo = fleet.prober.slo.snapshot()["objectives"]
        ok_load = [r for r in records if r.status == 200]
        out["wire_verdict"] = wire_state.get("verdict")
        out["correctness_wire_state"] = \
            slo.get("correctness:wire", {}).get("state")
        out["probe_rounds"] = fleet.prober._rounds
        out["load"] = {"ok": len(ok_load),
                       "errors": len(records) - len(ok_load),
                       "p95_ms": round(_p95_ms(
                           [r.latency_s for r in ok_load]), 2),
                       "pace": harness.pace_check(summarize(
                           records, duration, len(records)))}
        out["launches"] = harness.fleet_launches(fleet.base)
        out["checks"] = probe_checks(out)
        out["pass"] = all(out["checks"].values())
    finally:
        fleet.stop()
        shutil.rmtree(work, ignore_errors=True)
    return out


# ── main ─────────────────────────────────────────────────────────────


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="shorter windows + smaller extract (CI)")
    parser.add_argument("--nodes", type=int, default=6000)
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU (ROUTEST_DEVICE=cpu); "
                             "without it the script needs a card")
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "wire_cuda"),
                        help="street extract and overlay cache")
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "wire_cuda.json; build/wire_cpu.json with "
                             "--cpu)")
    parser.add_argument("--scenario", default=None,
                        choices=("micro", "probe_parity"),
                        help="run one scenario")
    return parser


def main() -> None:
    args = build_parser().parse_args()
    args.device = harness.require_card(args.cpu, "bench_wire_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "wire_cuda.json") \
            if args.device == "cuda" \
            else os.path.join(REPO, "build", "wire_cpu.json")
    if args.quick:
        args.nodes = min(args.nodes, 4000)
    os.makedirs(args.cache_dir, exist_ok=True)

    t0 = time.time()
    scenarios: dict = {}
    plan = [("micro", lambda: scenario_micro(args))]
    if args.scenario in (None, "probe_parity"):
        print(f"[1/3] extract + overlay cache ({args.nodes:,} nodes)…",
              flush=True)
        extract = harness.build_extract(args.nodes, args.cache_dir)
        plan.append(("probe_parity",
                     lambda: scenario_probe_parity(args, extract)))
    for i, (name, run) in enumerate(plan):
        if args.scenario and name != args.scenario:
            continue
        print(f"[{i + 2}/3] scenario {name}…", flush=True)
        t = time.perf_counter()
        try:
            scenarios[name] = run()
        except Exception as e:
            import traceback

            traceback.print_exc()
            scenarios[name] = {"scenario": name, "pass": False,
                               "error": f"{type(e).__name__}: {e}"}
        scenarios[name]["wall_s"] = round(time.perf_counter() - t, 1)
        s = scenarios[name]
        print(f"  {name}: {'PASS' if s.get('pass') else 'FAIL'} "
              f"({s['wall_s']}s) {s.get('checks', s.get('error'))}",
              flush=True)

    record = {
        "generated_unix": int(t0),
        "quick": bool(args.quick),
        "card": harness.card_identity(args.device),
        "host": {"cpu_count": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": args.device},
        "host_note": HOST_NOTE,
        "config": {
            "nodes": args.nodes,
            "speedup_min": SPEEDUP_MIN,
            "gateway_overhead_p95_ms": GW_OVERHEAD_P95_MS,
            "sustained_floor_rows_per_s": SUSTAINED_ROWS_PER_S,
            "cache_dir": args.cache_dir,
            "quick": bool(args.quick),
        },
        "scenarios": scenarios,
    }
    if args.scenario:
        record["partial"] = f"--scenario {args.scenario}"
    record["checks"] = {name: bool(s.get("pass"))
                        for name, s in scenarios.items()}
    record["launches"] = sum(int(s.get("launches") or 0)
                             for s in scenarios.values())
    record["all_pass"] = (bool(record["checks"])
                          and all(record["checks"].values())
                          and (args.scenario is not None
                               or len(scenarios) == 2))
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print(f"wrote {args.out} (all_pass={record['all_pass']}, launches "
          f"{record['launches']}, {record['wall_s']}s)", flush=True)
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
