"""Shared harness of the port's load scripts (``*_cuda.py``).

- the card: :func:`require_card` refuses to run without a CUDA device
  unless the CPU was asked for (``--cpu``), and :func:`card_identity`
  names the card and its power limit (``nvidia-smi``) for a record;
- ports: :func:`free_port` is the supervisor's pick, outside the host's
  ephemeral range, so no client TIME_WAIT can hold a server's port;
- a fleet of the port for one scenario (:class:`Fleet`: supervisor,
  replicas of ``python -m routest_tpu_torch.serve``, the in-process
  gateway, optionally the broker, live traffic and the blackbox
  prober), the synthetic street extract it routes on
  (:func:`build_extract`), a blocking open-loop ``/api/predict_eta``
  load (:func:`open_loop`), the flight recorder's correctness bundles
  (:func:`correctness_bundles`, :func:`judge_fault_bundle`,
  :func:`zero_pages`) and the wait for a correctness page
  (:func:`wait_for_page`);
- the generator's pace: :func:`run_open_loop_process` runs the
  open-loop senders in processes of their own (the gateway, autoscaler
  and watchers of a scenario share this one's interpreter), the
  schedule dealt over :data:`SENDER_PROCESSES` of them and timed from
  one instant, paced as ``chip_smoke.py``'s phase 18 paces its
  generator (:func:`paced`: a short interpreter switch interval, the
  collector off);
  :data:`SETTLE_S` lets a calibration's burst drain, and
  :func:`pace_check` reads an open-loop run's ``send_delay`` p99
  against :data:`PACE_LIMIT` — a run whose generator lagged is recorded
  as ``generator_lagged`` and never passes (:func:`passed`).

The harness of ``scripts/bench_probing.py`` on the port's modules:
it imports no JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODEL = os.path.join(REPO, "artifacts", "eta_mlp.msgpack")

# The swap gate's margin for a bench fleet — the prober derives its
# golden tolerance from it (a model the gate would accept never trips
# the prober; one past the gate always does).
SWAP_MAX_DIV_MIN = 30.0
PROBE_INTERVAL_S = 1.0
# Probe-scale SLO windows: pages after ~5 consecutive failing rounds.
PROBE_FAST_S, PROBE_SLOW_S = 10.0, 30.0


# The generator's threads hand the interpreter lock over within this
# (phase 18 of chip_smoke.py: the default 5 ms let one sender's quick
# socket calls keep the lock from a sender woken at its arrival).
LOADGEN_SWITCH_S = 2e-4
# A calibration's closed-loop burst drains before an open-loop run.
SETTLE_S = 2.0
# The open-loop senders (scripts/bench_pace_cuda.py measured the layouts
# on the card, PERF.md 5.16): four processes sharing the threads, each
# at niceness -10 (a woken sender preempts the host's other work) and
# spinning the last 0.5 ms before its arrival (no wake-up latency at the
# send); the runway lets every sender start before offset 0.
SENDER_PROCESSES = 4
SENDER_SPIN_S = 5e-4
SENDER_NICE = -10
START_RUNWAY_S = 0.25
# Phase 18's limit: an open-loop run kept its pace when the generator's
# send_delay p99 is within the run's own latency p50 — past it, the
# generator, not the servers, set the pace the run measured.
PACE_LIMIT = "send_delay p99 <= latency p50 of the same open-loop run"


# ── the card ─────────────────────────────────────────────────────────


def require_card(cpu: bool, who: str) -> str:
    """The device the script's servers use: ``"cpu"`` when asked for,
    else ``"cuda"`` — and without a card, a named line on stderr and
    exit code 2 (no fallback to the CPU)."""
    if cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        print(f"{who}: no CUDA device (torch.cuda.is_available() is "
              f"false); pass --cpu to run on the CPU", file=sys.stderr)
        sys.exit(2)
    return "cuda"


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for card 0, or ""."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0].strip() if out.strip() else ""


def card_identity(device: str) -> dict:
    """What a record says about where it was measured."""
    import torch

    out = {"device": device, "torch": torch.__version__,
           "cuda": torch.version.cuda, "cpu_count": _cores()}
    if device == "cuda":
        line = smi_line()
        out["nvidia_smi"] = line
        out["name"] = torch.cuda.get_device_name(0)
        out["power_limit"] = (line.rsplit(",", 1)[-1].strip()
                              if "," in line else None)
    return out


def _cores() -> int:
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def server_env(device: str, **extra) -> dict:
    """This process's environment for a spawned server, on ``device``
    (the CPU only when asked for: ``ROUTEST_DEVICE=cpu``)."""
    env = dict(os.environ)
    env.pop("ROUTEST_DEVICE", None)
    if device == "cpu":
        env["ROUTEST_DEVICE"] = "cpu"
    env.update(extra)
    return env


def free_port() -> int:
    from routest_tpu_torch.serve.fleet.supervisor import free_port as pick

    return pick()


def map_artifact(src: str, dst: str, fn) -> str:
    """The ETA artifact ``src`` with ``fn`` applied to every weight
    array, written to ``dst`` by the port's RTPU1 writer — the JAX
    scripts' ``jax.tree_util.tree_map`` over ``load_model``'s params and
    ``save_model``. → ``dst``."""
    from routest_tpu_torch.models.eta_mlp import EtaMLP
    from routest_tpu_torch.train.checkpoint import load_model, save_model

    model, params = load_model(src)

    def tree_map(tree):
        if isinstance(tree, dict):
            return {k: tree_map(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map(v) for v in tree)
        return fn(tree)

    save_model(dst, EtaMLP.from_numpy(tree_map(params), hidden=model.hidden,
                                      quantiles=model.quantiles,
                                      policy=model.policy))
    return dst


def write_record(path: str, record: dict) -> None:
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


# ── the generator's pace ─────────────────────────────────────────────


@contextlib.contextmanager
def paced():
    """Run the generator as phase 18 runs it: the heap collected and
    frozen, the collector off and the switch interval at
    :data:`LOADGEN_SWITCH_S`; the previous settings are restored on
    exit, also when the body raises."""
    gc.collect()
    gc.freeze()
    gc.disable()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(LOADGEN_SWITCH_S)
    try:
        yield
    finally:
        sys.setswitchinterval(switch)
        gc.enable()
        gc.unfreeze()


def _open_loop_child(part, bases, offsets, requests, workers, timeout,
                     spin_s, cpus, nice, ready, t0, stop, out) -> None:
    """One sender process: arrivals ``part`` of the schedule (global
    indices), sent from the instant ``t0`` holds once it is set.
    → ``out.put([(index, record), ...])``. ``t0`` and ``stop`` are
    shared memory, polled: the senders wait on an event of this process
    (a process-shared one puts a cross-process lock in every sender's
    wake-up, and its ``set`` blocks on sleepers of exited processes)."""
    from routest_tpu_torch.loadgen import run_open_loop

    # the threads started below inherit this thread's mask and niceness
    if cpus:
        os.sched_setaffinity(0, cpus)
    if nice:
        try:
            os.setpriority(os.PRIO_PROCESS, 0, nice)
        except OSError:
            pass            # not permitted here: the default priority
    with paced():
        halt = threading.Event()

        def watch():
            while not stop.value and not halt.wait(0.05):
                pass
            halt.set()

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        ready.put(len(part))
        while not t0.value and not stop.value:
            time.sleep(0.001)
        if stop.value:
            halt.set()
        records = run_open_loop(bases, offsets, requests, workers=workers,
                                timeout=timeout, stop=halt, start=t0.value,
                                spin_s=spin_s)
        halt.set()
        watcher.join()
    # the engine returns the records it kept in schedule order: match
    # each to its arrival (gaps only where ``stop`` cut the run)
    indexed, j = [], 0
    for rec in records:
        while float(offsets[j]) != rec.offset_s \
                or requests[j].route != rec.route:
            j += 1
        indexed.append((part[j], rec))
        j += 1
    out.put(indexed)


def run_open_loop_process(bases, offsets, requests, *, workers: int,
                          timeout: float = 30.0, stop=None,
                          processes: int = None, spin_s: float = None,
                          cpus=None, nice: int = None, started=None):
    """``loadgen.run_open_loop`` in spawned processes of their own, under
    :func:`paced` → ``(records, started_unix)``: ``records`` in arrival
    order, as one sender gives them, ``started_unix`` the wall clock at
    the schedule's start. The schedule is dealt round-robin over
    ``processes`` senders (default :data:`SENDER_PROCESSES`; never more
    than ``workers``) with ``workers`` threads in all, every process
    timing its arrivals from one shared instant; each sender spins the
    last ``spin_s`` (default :data:`SENDER_SPIN_S`) before its arrival,
    on the CPUs ``cpus`` (default: any), at the niceness ``nice``
    (default :data:`SENDER_NICE`; where the process may not raise its
    priority it keeps the default). ``stop`` (an event of this process)
    ends the run early, as it does in-process; ``started`` (an event of
    this process) is set once every sender is up, :data:`START_RUNWAY_S`
    before the schedule's offset 0 (spawning the senders takes seconds
    on a slow host: a caller that acts under load waits for it)."""
    import multiprocessing
    import queue

    n = min(len(offsets), len(requests))
    procs_n = max(1, min(processes or SENDER_PROCESSES, workers, n or 1))
    ctx = multiprocessing.get_context("spawn")
    out, ready = ctx.Queue(), ctx.Queue()
    t0, child_stop = ctx.RawValue("d", 0.0), ctx.RawValue("b", 0)
    procs = []
    for p in range(procs_n):
        part = list(range(p, n, procs_n))
        share = workers // procs_n + (p < workers % procs_n)
        procs.append(ctx.Process(
            target=_open_loop_child, daemon=True,
            args=(part, list(bases), [offsets[i] for i in part],
                  [requests[i] for i in part], share, timeout,
                  SENDER_SPIN_S if spin_s is None else spin_s,
                  sorted(cpus) if cpus else None,
                  SENDER_NICE if nice is None else nice, ready, t0,
                  child_stop, out)))
    for proc in procs:
        proc.start()

    def alive():
        # a sender that delivered exits 0; any other exit lost its part
        codes = [proc.exitcode for proc in procs]
        if any(code not in (None, 0) for code in codes):
            raise RuntimeError(f"an open-loop process exited with {codes}")

    def collect(q, count):
        got = []
        while len(got) < count:
            if stop is not None and stop.is_set():
                child_stop.value = 1
            try:
                got.append(q.get(timeout=0.2))
            except queue.Empty:
                alive()
        return got

    try:
        collect(ready, procs_n)
        # a runway for every sender to wake and start its threads
        start = time.perf_counter() + START_RUNWAY_S
        started_unix = time.time() + (start - time.perf_counter())
        t0.value = start
        if started is not None:
            started.set()
        merged = sorted((pair for part in collect(out, procs_n)
                         for pair in part), key=lambda pair: pair[0])
        return [rec for _, rec in merged], started_unix
    finally:
        child_stop.value = 1
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()


def pin_process(pid: int, cpus) -> None:
    """Every thread of the process ``pid`` (one of this script's own)
    onto ``cpus``; threads it starts later inherit the mask."""
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (ProcessLookupError, OSError):
            pass     # a thread that ended meanwhile


def pace_check(report: dict) -> dict:
    """An open-loop summary's pace under :data:`PACE_LIMIT`:
    ``send_delay_p99_ms``, ``pace_limit_ms`` (the run's latency p50) and
    ``generator_lagged``. A run without either figure (nothing was
    sent, or nothing answered) cannot show its pace and counts as
    lagged."""
    delay = (report.get("send_delay") or {}).get("p99_ms")
    limit = (report.get("latency") or {}).get("p50_ms")
    lagged = delay is None or limit is None or delay > limit
    return {"send_delay_p99_ms": delay, "pace_limit_ms": limit,
            "rule": PACE_LIMIT, "generator_lagged": bool(lagged)}


def early_pace_check(records, window_s: float = 1.0) -> dict:
    """:func:`pace_check` over the arrivals of a run's first
    ``window_s``: in an overload arm built to back up, every sender
    ends up waiting on the servers' queue (the whole run's
    ``send_delay`` is then the backlog's), so the generator's own pace
    shows before the backlog forms."""
    from routest_tpu_torch.loadgen import summarize

    early = [r for r in records if r.offset_s < window_s]
    return dict(pace_check(summarize(early, window_s, len(early))),
                window_s=window_s)


def passed(ok: bool, pace: dict) -> bool:
    """A scenario's verdict: its own checks, and a generator that kept
    its pace — a lagged run measured the generator, so it never
    passes."""
    return bool(ok) and not pace["generator_lagged"]


# ── HTTP ─────────────────────────────────────────────────────────────


def fetch(url: str, timeout: float = 30.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def post(url: str, body: dict, timeout: float = 120.0):
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


# ── the street extract ───────────────────────────────────────────────


def metro_streets(n_nodes: int, min_intersections: int = 1024) -> dict:
    """The OSM-topology network of about ``n_nodes`` nodes that the JAX
    router scripts build (``scripts/bench_{batch_solve,router_scale,
    router_serving}.py``): a k=4 street graph of ``max(1024, n_nodes /
    5.86)`` intersections from seed 0, two bends per street and a tenth
    one-way. The probing twins' :func:`build_extract` floors at 512
    intersections, as ``scripts/bench_probing.py`` does."""
    from routest_tpu_torch.data.road_graph import (generate_road_graph,
                                                   subdivide_graph)

    n_int = max(min_intersections, int(n_nodes / 5.86))
    base = generate_road_graph(n_nodes=n_int, k=4, seed=0)
    return subdivide_graph(base, bends_per_edge=2, oneway_frac=0.1, seed=0)


def oracle_max_rel_err(router, sources, dist) -> float:
    """Max relative error of a solve's ``dist`` rows against scipy's
    float64 Dijkstra from ``sources`` over the router's graph, as the
    JAX router scripts check it; infinite on a reachability disagreement
    in either direction."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    n = router.n_nodes
    adj = sp.coo_matrix(
        (router.length_m, (router.senders, router.receivers)),
        shape=(n, n)).tocsr()
    want = dijkstra(adj, directed=True,
                    indices=np.asarray(sources, np.int64))
    finite = np.isfinite(want)
    if (dist[finite] > 1e37).any() or (dist[~finite] < 1e37).any():
        return float("inf")
    err = np.abs(dist[finite] - want[finite]) / np.maximum(want[finite], 1.0)
    return float(err.max())


def build_extract(n_nodes: int, cache_dir: str) -> str:
    """Synthetic street extract, cached across scenarios and runs; the
    overlay is prebuilt (on the CPU) into ``ROUTEST_HIER_CACHE`` so
    every replica loads it instead of building it."""
    path = os.path.join(cache_dir, f"probing_{n_nodes}.osm.gz")
    if os.path.exists(path):
        return path
    from routest_tpu_torch.data.osm import load_osm, save_osm
    from routest_tpu_torch.optimize.road_router import RoadRouter

    save_osm(path, metro_streets(n_nodes, min_intersections=512))
    t0 = time.perf_counter()
    RoadRouter(graph=load_osm(path), use_gnn=False, use_transformer=False,
               device="cpu")
    print(f"  overlay prebuilt in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return path


# ── a fleet of the port ──────────────────────────────────────────────


class Fleet:
    """One scenario's fleet: supervisor + replicas on ``device`` +
    in-process gateway + (optionally) broker, probe drivers, and the
    armed prober. Replicas are device-blind: on one card every replica
    serves on it."""

    def __init__(self, *, live: bool, extract: str, cache_dir: str,
                 work_dir: str, device: str, replicas: int = 2,
                 drivers: int = 48, customize_s: float = 3.0,
                 probe_interval: float = PROBE_INTERVAL_S) -> None:
        from routest_tpu_torch.core.config import (FleetConfig,
                                                   ProberConfig,
                                                   RecorderConfig)
        from routest_tpu_torch.data.locations import SEED_LOCATIONS
        from routest_tpu_torch.obs.recorder import (FlightRecorder,
                                                    configure_recorder)
        from routest_tpu_torch.serve.fleet.gateway import Gateway
        from routest_tpu_torch.serve.fleet.supervisor import \
            ReplicaSupervisor

        self.live = live
        self.work_dir = work_dir
        self.recorder_dir = os.path.join(work_dir, "postmortems")
        self.recorder = FlightRecorder(RecorderConfig(
            dir=self.recorder_dir, min_interval_s=0.0))
        configure_recorder(self.recorder)
        self.model_path = os.path.join(work_dir, "eta_serving.msgpack")
        shutil.copy(MODEL, self.model_path)
        self.broker = None
        self.probe_fleet = None
        self.prober = None
        env = server_env(
            device, ROUTEST_WARM_BUCKETS="0", ROUTEST_MESH="0",
            ETA_MODEL_PATH=self.model_path, ROUTEST_RELOAD_SEC="0.5",
            RTPU_SWAP_MAX_DIV=f"{SWAP_MAX_DIV_MIN:g}",
            RTPU_RECORDER_DIR=os.path.join(work_dir, "workers"))
        if live:
            from routest_tpu_torch.serve.netbus import start_broker

            self.broker, _ = start_broker()
            env.update({
                "ROAD_GRAPH_OSM": extract,
                "ROUTEST_HIER_CACHE": os.path.join(cache_dir, "hier"),
                "REDIS_URL": f"tcp://127.0.0.1:{self.broker.port}",
                "RTPU_LIVE": "1",
                "RTPU_LIVE_CUSTOMIZE_S": f"{customize_s:g}",
                "RTPU_LIVE_HALF_LIFE_S": "10",
                "RTPU_LIVE_MIN_OBS_EDGES": "10",
            })
        self.env = env
        self.ports = [free_port() for _ in range(replicas)]
        self.sup = ReplicaSupervisor(self.ports, env=env, cwd=REPO,
                                     probe_interval_s=0.5,
                                     backoff_base_s=0.2,
                                     backoff_cap_s=2.0)
        self.sup.start()
        if not self.sup.ready(timeout=600):
            self.sup.drain(timeout=10)
            if self.broker is not None:
                self.broker.shutdown()
            raise RuntimeError("fleet workers never became ready")
        self.gw = Gateway([("127.0.0.1", p) for p in self.ports],
                          FleetConfig(hedge=False, max_inflight=64,
                                      queue_depth=256), supervisor=self.sup)
        self.httpd = self.gw.serve("127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        a, b = SEED_LOCATIONS[2], SEED_LOCATIONS[11]
        self.prober_cfg = ProberConfig(
            enabled=True, interval_s=probe_interval, timeout_s=20.0,
            eta_tolerance=SWAP_MAX_DIV_MIN,
            route_tolerance_rel=0.02,   # cross-replica EWMA drift
            routes=(f"{a[1]},{a[2]}|{b[1]},{b[2]}" if live else ""),
            skew_after=3, epoch_gap=2,
            fast_window_s=PROBE_FAST_S, slow_window_s=PROBE_SLOW_S)
        self._driver_count = drivers
        if live:
            self._wait_live_ready()

    def start_probe_drivers(self) -> None:
        """Seeded probe drivers publishing per-edge observations into
        the fleet's broker, so the live metric flips for real; the
        router they walk (on the CPU) is kept as ``oracle_router``."""
        from routest_tpu_torch.data.osm import load_osm
        from routest_tpu_torch.live.probes import ProbeFleet
        from routest_tpu_torch.optimize.road_router import RoadRouter
        from routest_tpu_torch.serve.netbus import NetBus

        if self.probe_fleet is not None:
            return
        router = RoadRouter(graph=load_osm(self.env["ROAD_GRAPH_OSM"]),
                            use_gnn=False, use_transformer=False,
                            device="cpu")
        self.oracle_router = router
        bus = NetBus(f"tcp://127.0.0.1:{self.broker.port}")
        self.probe_fleet = ProbeFleet(router.graph_dict(),
                                      self._driver_count, bus.publish,
                                      seed=42, obs_per_tick=6)
        self.probe_fleet.start(tick_s=1.0)

    def _wait_live_ready(self, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        for port in self.ports:
            while time.time() < deadline:
                try:
                    if fetch(f"http://127.0.0.1:{port}/api/live",
                             timeout=10).get("ready"):
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            else:
                raise RuntimeError(f"replica :{port} live never armed")

    def arm_prober(self):
        from routest_tpu_torch.obs.prober import BlackboxProber

        self.prober = BlackboxProber(
            self.prober_cfg, gateway_base=self.base,
            targets_fn=self.gw._probe_targets, recorder=self.recorder)
        self.gw.prober = self.prober     # /api/probes surfaces it
        self.prober.start()
        return self.prober

    def replica_rids(self):
        with self.gw._lock:
            return sorted((r.id for r in self.gw.replicas
                           if not r.draining),
                          key=lambda rid: int(rid[1:]))

    def inject_replacement(self, rid: str, overlay: dict,
                           version: str) -> str:
        """Roll ONE replica onto (version, overlay); returns the
        successor's rid — the replica the prober must name."""
        from routest_tpu_torch.serve.fleet.rollout import replace_replica

        old_port = self.ports[int(rid[1:])]
        result = replace_replica(self.sup, self.gw, rid,
                                 version=version, env=overlay,
                                 boot_timeout_s=300.0,
                                 health_timeout_s=60.0)
        if not result.get("ok"):
            raise RuntimeError(f"fault injection rollout failed: "
                               f"{result}")
        self.ports = [p for p in self.ports if p != old_port] \
            + [result["port"]]
        if self.live:
            self._wait_live_ready()
        return result["new_rid"]

    def metrics(self) -> dict:
        """The gateway's ``/api/metrics?replicas=1``."""
        return fetch(f"{self.base}/api/metrics?replicas=1")

    def stop(self) -> None:
        from routest_tpu_torch.obs.recorder import configure_recorder

        if self.prober is not None:
            self.prober.stop()
        if self.probe_fleet is not None:
            self.probe_fleet.stop()
        try:
            self.gw.drain(timeout=5)
        finally:
            self.sup.drain(timeout=15)
            if self.broker is not None:
                self.broker.shutdown()
                self.broker.server_close()
            configure_recorder(None)


def launch_delta(before: dict, after: dict) -> dict:
    """{replica: fused launches between two ``?replicas=1`` scrapes}, for
    the replicas that answered the second (a replica scaled away took
    its count with it)."""
    b, a = replica_launches(before), replica_launches(after)
    return {rid: a[rid] - b.get(rid, 0) for rid in sorted(a)}


def fleet_launches(base: str) -> int:
    """Fused launches a gateway's live replicas made since they booted
    (its ``/api/metrics?replicas=1``; 0 when it does not answer)."""
    try:
        return sum(replica_launches(
            fetch(f"{base}/api/metrics?replicas=1")).values())
    except OSError:
        return 0


def replica_launches(metrics: dict) -> dict:
    """``/api/metrics?replicas=1`` → {replica id: fused launches}; a
    replica that did not answer is left out."""
    out = {}
    for rid, snap in (metrics.get("replica_metrics") or {}).items():
        fam = ((snap or {}).get("registry") or {}).get(
            "rtpu_fused_launches") if isinstance(snap, dict) else None
        if fam and fam.get("series"):
            out[rid] = int(fam["series"][0]["value"])
    return out


def open_loop(base: str, rate: float, duration_s: float, stop=None,
              started=None):
    """Blocking open-loop predict_eta load (unique bodies) → records,
    from sender processes of their own (``started``: as
    :func:`run_open_loop_process`)."""
    from routest_tpu_torch.loadgen import (PlannedRequest, RateCurve,
                                           paced_schedule)

    offsets = paced_schedule(RateCurve.constant(rate), duration_s)
    requests = [PlannedRequest(
        method="POST", path="/api/predict_eta",
        body={"summary": {"distance": 7000 + i}, "weather": "Sunny",
              "traffic": "Medium", "driver_age": 33,
              "pickup_time": "2026-08-05T18:00:00"},
        route="predict_eta") for i in range(len(offsets))]
    return run_open_loop_process([base], offsets, requests, workers=8,
                                 timeout=30.0, stop=stop,
                                 started=started)[0]


def correctness_bundles(recorder_dir: str):
    out = []
    if not os.path.isdir(recorder_dir):
        return out
    for name in sorted(os.listdir(recorder_dir)):
        if not name.startswith("pm_") or "correctness" not in name:
            continue
        bundle = os.path.join(recorder_dir, name)
        try:
            with open(os.path.join(bundle, "probe_evidence.json")) as f:
                evidence = json.load(f)
            with open(os.path.join(bundle, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        out.append({"name": name, "evidence": evidence,
                    "manifest_reason": manifest.get("reason"),
                    "detail": manifest.get("detail")})
    return out


def judge_fault_bundle(bundles, faulty_rid: str,
                       require_dimensions=None) -> dict:
    """A correctness bundle must name the faulty replica and embed the
    probe request, served answer, oracle/pinned answer, divergence.
    ``require_dimensions`` additionally demands a skew failure on one
    of the given dimensions (e.g. the stale-epoch scenario must be
    identified AS an epoch skew, not only as a divergent answer)."""
    for b in bundles:
        ev = b["evidence"]
        if faulty_rid not in (ev.get("replicas") or []):
            continue
        for f in reversed(ev.get("failures") or []):
            named = faulty_rid in (f.get("replicas") or [])
            embedded = (f.get("request") is not None
                        and f.get("served") is not None
                        and (f.get("expected") is not None
                             or f.get("oracle") is not None
                             or f.get("dimensions") is not None))
            has_div = (f.get("divergence") is not None
                       or f.get("dimensions") is not None)
            dims = sorted(f.get("dimensions") or ())
            if require_dimensions is not None and \
                    not (set(dims) & set(require_dimensions)):
                continue
            if named and embedded and has_div:
                return {"ok": True, "bundle": b["name"],
                        "verdict": f.get("verdict"),
                        "divergence": f.get("divergence"),
                        "dimensions": dims}
    return {"ok": False,
            "bundles_seen": [b["name"] for b in bundles]}


def zero_pages(prober, recorder_dir: str) -> dict:
    """No correctness objective off ``ok`` and no correctness bundle."""
    snap = prober.slo.snapshot()
    states = {k: v["state"] for k, v in snap["objectives"].items()}
    bundles = correctness_bundles(recorder_dir)
    return {"objective_states": states,
            "correctness_bundles": len(bundles),
            "ok": all(s == "ok" for s in states.values()) and not bundles}


def wait_for_page(prober, bound_s: float) -> dict:
    """Poll the prober's own SLO engine until any correctness objective
    pages → ``{"paged", "objective", "detect_s"}``."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound_s:
        snap = prober.slo.snapshot()
        for name, obj in snap["objectives"].items():
            if obj["state"] == "page":
                return {"paged": True, "objective": name,
                        "detect_s": round(time.monotonic() - t0, 2)}
        time.sleep(0.2)
    return {"paged": False, "detect_s": None}


def p95_ms(records) -> float:
    """p95 latency of a run's answered requests, ms (nan: none)."""
    ok = sorted(r.latency_s for r in records if 200 <= r.status < 400)
    if not ok:
        return float("nan")
    return ok[min(len(ok) - 1, int(0.95 * len(ok)))] * 1000.0
