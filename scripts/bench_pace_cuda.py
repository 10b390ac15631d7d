"""The open-loop generator's pace on the card, by sender layout.

Phase 18 of ``chip_smoke.py`` holds an open-loop run to one rule: the
generator's ``send_delay`` p99 within the run's own latency p50
(``cuda_harness.PACE_LIMIT``). This script measures what the sender's
layout does to that margin against one server of the port on the card,
phase 18's way: a closed-loop calibration of the single-row capacity C
(32 workers), then the same 0.5 C paced Zipf schedule sent by each
layout in turns (A B C … then … C B A), 2 s apart:

- ``shared_event``: the layout before the repair — one spawned process,
  every sender thread waiting on a process-shared stop event;
- ``one_process``: one process, the senders waiting on an event of
  their own process (:func:`cuda_harness.run_open_loop_process` with
  ``processes=1``);
- ``two_processes`` / ``four_processes``: the schedule dealt
  round-robin over that many sender processes, the threads split among
  them, every process timing from one shared instant;
- ``four_processes_spin``: four, each sender waking 1 ms early and
  spinning to its arrival;
- ``four_processes_pinned`` / ``one_process_pinned``: the senders on
  the host's last two CPUs (one), every thread of the server on the
  others for the run (``os.sched_setaffinity``, on this script's own
  processes only);
- ``four_processes_nice`` / ``four_processes_nice_spin``: four, the
  senders at niceness -10 (their own processes' priority; kept at the
  default where not permitted), the second spinning the last 0.5 ms.

``--burn N`` keeps N busy-looping processes of this script running
through every layout's runs: the host as busy as a full
``chip_smoke.py`` run may leave it.

Each run also reads the host's busy and steal time (``/proc/stat``),
its CPU pressure where the kernel has it (``/proc/pressure/cpu``), and
the server's CPU time and threads (``/proc/<pid>``) across the run: a
stall of the whole host shows there, not in the sender.

The record (``artifacts/pace_cuda.json``) holds each run's ``send_delay``
p50/p99 and latency p50/p99, whether it kept the rule, the card's name
and power limit, and the host's cores. ``--cpu`` serves on the CPU for
a rehearsal; without a card and without ``--cpu`` it exits 2.

Usage: python3 scripts/bench_pace_cuda.py [--cpu] [--rounds 2]
       [--run-s 10] [--workers 64] [--burn 0] [--layouts ...]
       [--out artifacts/pace_cuda.json]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

LAYOUTS = ("shared_event", "four_processes", "four_processes_nice",
           "four_processes_nice_spin")
# layout → (sender processes, spin before each arrival (s), the CPUs of
# their own: the last n of the host's, the server kept off them,
# niceness)
PROCESSES = {"one_process": (1, 0.0, 0, 0), "two_processes": (2, 0.0, 0, 0),
             "four_processes": (4, 0.0, 0, 0),
             "four_processes_spin": (4, 1e-3, 0, 0),
             "four_processes_pinned": (4, 0.0, 2, 0),
             "one_process_pinned": (1, 0.0, 1, 0),
             "four_processes_nice": (4, 0.0, 0, -10),
             "four_processes_nice_spin": (4, 5e-4, 0, -10)}


def _shared_event_child(bases, offsets, requests, workers, timeout, stop,
                        out) -> None:
    from routest_tpu_torch.loadgen import run_open_loop

    with harness.paced():
        out.put(run_open_loop(bases, offsets, requests, workers=workers,
                              timeout=timeout, stop=stop))


def send_shared_event(bases, offsets, requests, *, workers, timeout):
    """The sender as it was: one process, the engine's waits on a
    process-shared event."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out, stop = ctx.Queue(), ctx.Event()
    proc = ctx.Process(target=_shared_event_child, daemon=True,
                       args=(list(bases), list(offsets), list(requests),
                             workers, timeout, stop, out))
    proc.start()
    try:
        return out.get(timeout=timeout + 120)
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()


def host_stall_counters(server_pid=None) -> dict:
    """CPU pressure (µs some task waited for a CPU), busy and steal
    (jiffies over all CPUs), the server's CPU jiffies and threads;
    what is unreadable is left out."""
    out = {}
    if server_pid is not None:
        try:
            with open(f"/proc/{server_pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out["server_cpu_jiffies"] = int(fields[11]) + int(fields[12])
            out["server_threads"] = int(fields[17])
        except (OSError, IndexError, ValueError):
            pass
    try:
        with open("/proc/pressure/cpu") as f:
            some = f.readline().split()
        out["pressure_some_us"] = int(some[-1].split("=")[1])
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open("/proc/stat") as f:
            cpu = [int(v) for v in f.readline().split()[1:]]
        out["busy_jiffies"] = sum(cpu) - cpu[3] - cpu[4]
        out["steal_jiffies"] = cpu[7]
    except (OSError, IndexError, ValueError):
        pass
    return out


def run_layout(layout, base, offsets, requests, workers, run_s,
               server_pid=None):
    from routest_tpu_torch.loadgen import summarize

    before = host_stall_counters(server_pid)
    if layout == "shared_event":
        records = send_shared_event([base], offsets, requests,
                                    workers=workers, timeout=30.0)
    else:
        procs, spin, own, nice = PROCESSES[layout]
        every = sorted(os.sched_getaffinity(0))
        cpus = set(every[-own:]) if own else None
        if cpus and server_pid is not None:
            harness.pin_process(server_pid, set(every) - cpus)
        try:
            records, _ = harness.run_open_loop_process(
                [base], offsets, requests, workers=workers, timeout=30.0,
                processes=procs, spin_s=spin, cpus=cpus, nice=nice)
        finally:
            if cpus and server_pid is not None:
                harness.pin_process(server_pid, set(every))
    after = host_stall_counters(server_pid)
    rep = summarize(records, run_s, len(offsets))
    pace = harness.pace_check(rep)
    late = sorted((r.send_delay_s * 1e3 for r in records), reverse=True)
    return {"layout": layout, "sent": rep["sent"], "ok": rep["ok"],
            "errors": rep["errors"],
            "host_stall": {k: (after[k] if k == "server_threads"
                               else after[k] - before[k])
                           for k in after if k in before},
            "latest_sends_ms": [round(v, 3) for v in late[:10]],
            "send_delay_ms": rep["send_delay"],
            "latency_ms": {k: rep["latency"].get(k)
                           for k in ("p50_ms", "p95_ms", "p99_ms")},
            "kept_pace": not pace["generator_lagged"]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="serve on the CPU (ROUTEST_DEVICE=cpu); "
                             "without it the script needs a card")
    parser.add_argument("--rounds", type=int, default=2,
                        help="passes over the layouts, in turns")
    parser.add_argument("--run-s", type=float, default=10.0)
    parser.add_argument("--workers", type=int, default=64)
    parser.add_argument("--calibrate-s", type=float, default=5.0)
    parser.add_argument("--burn", type=int, default=0,
                        help="busy-looping processes kept running "
                             "through the layouts' runs")
    parser.add_argument("--layouts", nargs="*", default=list(LAYOUTS),
                        choices=("shared_event",) + tuple(PROCESSES))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "pace_cuda.json; build/pace_cpu.json with "
                             "--cpu)")
    args = parser.parse_args()
    device = harness.require_card(args.cpu, "bench_pace_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts", "pace_cuda.json") \
            if device == "cuda" \
            else os.path.join(REPO, "build", "pace_cpu.json")
    from routest_tpu_torch.loadgen import (KeepAliveClient, RateCurve,
                                           ZipfODWorkload, paced_schedule,
                                           run_closed_loop, summarize)

    port = harness.free_port()
    base = f"http://127.0.0.1:{port}"
    env = harness.server_env(device, PORT=str(port),
                             ETA_MODEL_PATH=harness.MODEL)
    proc = subprocess.Popen([sys.executable, "-m",
                             "routest_tpu_torch.serve"], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    runs = []
    try:
        deadline = time.monotonic() + 240
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"the server exited {proc.returncode}")
            try:
                if harness.fetch(f"{base}/api/ping", timeout=2).get("ok"):
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError("the server never answered")
            time.sleep(0.2)
        zipf = ZipfODWorkload(s=1.1, seed=42)
        warm = KeepAliveClient(base)
        try:
            for req in zipf.sequence(16):
                warm.send(req)
        finally:
            warm.close()
        cal = summarize(run_closed_loop(
            [base], zipf.sequence(50_000), workers=32,
            duration_s=args.calibrate_s), args.calibrate_s, 0,
            loop="closed")
        cap = cal["achieved_rps"]
        time.sleep(harness.SETTLE_S)
        offsets = paced_schedule(RateCurve.constant(0.5 * cap), args.run_s)
        requests = zipf.sequence(len(offsets))
        order = []
        for r in range(args.rounds):
            order += args.layouts if r % 2 == 0 else args.layouts[::-1]
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(args.burn)]
        for layout in order:
            run = run_layout(layout, base, offsets, requests, args.workers,
                             args.run_s, server_pid=proc.pid)
            runs.append(run)
            print(f"[pace] {layout}: send_delay p99 "
                  f"{run['send_delay_ms'].get('p99_ms')} ms, latency p50 "
                  f"{run['latency_ms']['p50_ms']} ms, kept pace "
                  f"{run['kept_pace']}, host {run['host_stall']}",
                  flush=True)
            time.sleep(2.0)
    finally:
        for burner in locals().get("burners", ()):
            burner.kill()
            burner.wait()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    by_layout = {}
    for run in runs:
        by_layout.setdefault(run["layout"], []).append(run)
    record = {
        "generated_unix": int(time.time()),
        "card": harness.card_identity(device),
        "rule": harness.PACE_LIMIT,
        "capacity_rps": cap, "offered_rps": 0.5 * cap,
        "arrivals": len(offsets), "workers": args.workers,
        "run_s": args.run_s, "burn": args.burn, "order": order,
        "runs": runs,
        "summary": {layout: {
            "send_delay_p99_ms": [r["send_delay_ms"].get("p99_ms")
                                  for r in rs],
            "latency_p50_ms": [r["latency_ms"]["p50_ms"] for r in rs],
            "kept_pace": [r["kept_pace"] for r in rs]}
            for layout, rs in by_layout.items()},
    }
    harness.write_record(args.out, record)
    print(json.dumps(record["summary"], indent=2))


if __name__ == "__main__":
    main()
