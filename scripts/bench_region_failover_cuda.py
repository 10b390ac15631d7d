"""Multi-region failover on the card → artifacts/region_failover_cuda.json.

The port's counterpart of ``scripts/bench_region_failover.py``: two
one-replica regions of the port, each its own broker
(``serve/netbus.py``) and fleet process (``FleetProcess``: ``python -m
routest_tpu_torch.serve.fleet``, the replica on the card), behind the
port's ``GeoFront``, live probe state bridged both ways
(``live/bridge.py``), the cross-region fan-out prober armed with its
``reach`` dimension — then a whole region is SIGKILLed and brought
back:

- ``bridged_convergence`` — a corridor jam observed ONLY by region
  east's drivers (published only into east's bus) must show up in
  region west's served live metric within ``CONVERGE_BOUND_S``: the
  bridge is the only path it can take.
- ``region_loss`` — ``region.kill`` on east (fleet process group AND
  broker die at once): the survivor absorbs the redirected open-loop
  traffic, the writes taken during the outage land in east's journal
  (zero lost), the survivor's staleness stays bounded, and the reach
  probe pages naming the dead region.
- ``rejoin`` — east comes back on the same broker port (outside the
  host's ephemeral range, as every port here): the journal drains with
  every write replayed, live state catches up, the reach offender and
  the page clear, and a clean watch window records no new failure.

The constants are the JAX script's; every time is recorded beside its
bound, with the fused launches the regions' replicas made, the card's
name and power limit, and the host's cores. The helpers of
``bench_probing.py`` come from ``cuda_harness``; the open-loop load
sends from processes of its own, and its pace is recorded (no check
reads its latency).
``--cpu`` serves both regions on the CPU for a rehearsal; without a
card and without ``--cpu`` the script exits 2.

Usage: python3 scripts/bench_region_failover_cuda.py [--quick] [--cpu]
       [--out artifacts/region_failover_cuda.json] [--cache-dir DIR]
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

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import cuda_harness as harness  # noqa: E402

DRIVERS = 24                   # ambient probe drivers per region
JAM_SPEED_FACTOR = 0.25        # corridor traffic at quarter speed
JAM_WIDTH_M = 1500.0
JAM_RATIO = 1.5                # corridor metric must rise ≥ this
CALM_RATIO = 1.25              # …while off-corridor stays under this
CONVERGE_BOUND_S = 90.0        # jam → bridged region's served metric
PAGE_BOUND_S = 90.0            # region death → reach page naming it
SLO_RECOVER_BOUND_S = 60.0     # survivor user SLO back to ok
CATCHUP_BOUND_S = 120.0        # rejoin → journal drained + live ready
CLEAN_S = 15.0                 # quiet watch after recovery
STALE_BOUND_S = 30.0           # survivor live staleness bound
K_WRITES = 24                  # tracker writes taken during the outage
SLO_FAST_S, SLO_SLOW_S = 15.0, 45.0


# ── topology ─────────────────────────────────────────────────────────


class Region:
    """One region: broker + fleet subprocess + ambient probe drivers.
    ``kill()`` is a true region loss — the fleet process group AND the
    broker (with its live handler sockets) die at once — and every bus
    the bench keeps pointed at the region is reset so degraded-mode
    publish buffering kicks in instead of zombie-handler ACKs."""

    def __init__(self, name: str, *, extract: str, cache_dir: str,
                 work: str, device: str, replicas: int = 1) -> None:
        from routest_tpu_torch.serve.fleet.geofront import FleetProcess

        self.name = name
        self.broker_port = harness.free_port()
        self.bus_url = f"tcp://127.0.0.1:{self.broker_port}"
        self.broker = None
        self.model_path = os.path.join(work, f"eta_{name}.msgpack")
        shutil.copy(harness.MODEL, self.model_path)
        env = harness.server_env(
            device,
            ROUTEST_WARM_BUCKETS="0",
            ROUTEST_MESH="0",
            ETA_MODEL_PATH=self.model_path,
            ROUTEST_RELOAD_SEC="0.5",
            RTPU_SWAP_MAX_DIV=f"{harness.SWAP_MAX_DIV_MIN:g}",
            RTPU_RECORDER_DIR=os.path.join(work, f"workers_{name}"),
            ROAD_GRAPH_OSM=extract,
            ROUTEST_HIER_CACHE=os.path.join(cache_dir, "hier"),
            RTPU_LIVE="1",
            RTPU_LIVE_CUSTOMIZE_S="3",
            RTPU_LIVE_HALF_LIFE_S="10",
            RTPU_LIVE_MIN_OBS_EDGES="10",
            # Probe-scale SLO windows so a burn decays inside the bench.
            RTPU_SLO_FAST_S=f"{SLO_FAST_S:g}",
            RTPU_SLO_SLOW_S=f"{SLO_SLOW_S:g}",
            RTPU_SLO_TICK_S="1",
            # The survivor's autoscaler is armed for redirected load
            # (on the card a grown replica is the plan's growth slice).
            RTPU_AUTOSCALE="1",
            RTPU_AUTOSCALE_MIN="1",
            RTPU_AUTOSCALE_MAX="2",
            RTPU_AUTOSCALE_TICK_S="1")
        if device == "cpu":
            # a stand-in card for the placement plan, served on the CPU
            env.update({"RTPU_FLEET_CHIPS": "1",
                        "RTPU_FLEET_PLATFORM": "gpu"})
        env.pop("RTPU_REGIONS", None)   # the bench owns the topology
        self.fleet = FleetProcess(
            name, gateway_port=harness.free_port(),
            base_port=harness.free_port(), replicas=replicas,
            redis_url=self.bus_url, env=env)
        self.base = self.fleet.base
        self.probe_bus = None
        self.probe_fleet = None
        self._reset_on_kill = []       # buses that publish INTO us

    def start(self) -> None:
        from routest_tpu_torch.serve.netbus import start_broker

        if self.broker is None:
            self.broker, _ = start_broker(port=self.broker_port)
        self.fleet.start()

    def start_drivers(self, graph, scenario=None, seed: int = 0) -> None:
        from routest_tpu_torch.live.probes import ProbeFleet
        from routest_tpu_torch.serve.netbus import NetBus

        self.probe_bus = NetBus(self.bus_url, reconnect_s=0.5)
        self.probe_fleet = ProbeFleet(graph, DRIVERS,
                                      self.probe_bus.publish, seed=seed,
                                      obs_per_tick=6, scenario=scenario)
        self.probe_fleet.start(tick_s=1.0)
        self._reset_on_kill.append(self.probe_bus)

    def watch_bus(self, bus) -> None:
        """Register a bus whose cached conns must drop on kill()."""
        self._reset_on_kill.append(bus)

    def kill(self) -> None:
        self.fleet.kill()
        self._stop_broker()
        # Drop cached keep-alive conns: a zombie handler thread of the
        # dead broker would otherwise keep ACKing publishes into its
        # memory; a fresh connect fails and the frame buffers instead.
        for bus in self._reset_on_kill:
            bus._reset()

    def rejoin(self) -> None:
        self.start()

    def _stop_broker(self) -> None:
        if self.broker is None:
            return
        with self.broker._subs_lock:
            handlers = {h for hs in self.broker._subs.values()
                        for h in hs}
        self.broker.shutdown()
        self.broker.server_close()
        for h in handlers:
            try:
                h.connection.close()
            except OSError:
                pass
        self.broker = None

    def launches(self) -> dict:
        """{replica: fused launches} read through the region's gateway
        ({} when it does not answer)."""
        try:
            return harness.replica_launches(
                harness.fetch(f"{self.base}/api/metrics?replicas=1",
                              timeout=30))
        except OSError:
            return {}

    def stop(self) -> None:
        if self.probe_fleet is not None:
            self.probe_fleet.stop()
        self.fleet.terminate(timeout=30)
        self._stop_broker()


def _build_topology(extract: str, cache_dir: str, work: str, device: str):
    """Boot east+west fleets, the geo-front, and both bridges; start
    ambient drivers (east's are scenario-priced — the jam is a region-
    east physical event). Returns a context namespace."""
    from types import SimpleNamespace

    from routest_tpu_torch.core.config import ProberConfig, RegionConfig
    from routest_tpu_torch.data.locations import SEED_LOCATIONS
    from routest_tpu_torch.data.osm import load_osm
    from routest_tpu_torch.live.bridge import ProbeBridge
    from routest_tpu_torch.live.probes import (CongestionScenario,
                                               corridor_edges)
    from routest_tpu_torch.optimize.road_router import RoadRouter
    from routest_tpu_torch.serve.fleet.geofront import GeoFront, RegionHandle
    from routest_tpu_torch.serve.netbus import NetBus

    east = Region("east", extract=extract, cache_dir=cache_dir, work=work,
                  device=device)
    west = Region("west", extract=extract, cache_dir=cache_dir, work=work,
                  device=device)
    t0 = time.perf_counter()
    east.start()
    west.start()
    boot_s = {}
    for r in (east, west):
        if not r.fleet.wait_ready(timeout=600):
            raise RuntimeError(f"region {r.name} fleet never ready")
        boot_s[r.name] = round(time.perf_counter() - t0, 3)

    rc = RegionConfig(enabled=True, regions=("east", "west"),
                      default="east", bridge=True, health_s=0.5,
                      unhealthy_after=2, failover=True,
                      stale_bound_s=STALE_BOUND_S, journal_limit=4096,
                      replay_s=0.25, prober=True)
    front = GeoFront([
        RegionHandle("east", east.base, bus_url=east.bus_url,
                     kill=east.kill, rejoin=east.rejoin),
        RegionHandle("west", west.base, bus_url=west.bus_url,
                     kill=west.kill, rejoin=west.rejoin),
    ], rc)
    front.serve("127.0.0.1", harness.free_port())

    # Bridges both directions; reconnect_s buses so a dead endpoint
    # means buffering + replay, never a crashed bridge thread.
    bridges = []
    for src, dst in ((east, west), (west, east)):
        src_bus = NetBus(src.bus_url, reconnect_s=0.5)
        dst_bus = NetBus(dst.bus_url, reconnect_s=0.5)
        dst.watch_bus(dst_bus)
        b = ProbeBridge(src.name, dst.name, src_bus, dst_bus)
        b.start()
        bridges.append(b)
    front.bridges.extend(bridges)

    # Corridor geometry + the jam scenario (east-only physical event).
    router = RoadRouter(graph=load_osm(extract), use_gnn=False,
                        use_transformer=False, device="cpu")
    g = router.graph_dict()
    a = (SEED_LOCATIONS[2][1], SEED_LOCATIONS[2][2])
    b_ = (SEED_LOCATIONS[11][1], SEED_LOCATIONS[11][2])
    corridor = corridor_edges(g["node_coords"], g["senders"],
                              g["receivers"], a, b_, width_m=JAM_WIDTH_M)
    scenario = CongestionScenario(corridor, speed_factor=JAM_SPEED_FACTOR)
    scenario.set_active(False)
    east.start_drivers(g, scenario=scenario, seed=42)
    west.start_drivers(g, scenario=None, seed=1042)

    prober_cfg = ProberConfig(
        enabled=True, interval_s=1.0, timeout_s=20.0,
        eta_tolerance=harness.SWAP_MAX_DIV_MIN,
        # No pinned route probes: a failover legally flips the serving
        # region (and its metric). The golden fan-out and reach
        # dimensions are the cross-region correctness probes.
        routes="",
        skew_after=3,
        # Live epochs count customize flips since each region's OWN
        # boot — never comparable across regions. The reach dimension
        # is the pager here; epoch skew stays replica-scope.
        epoch_gap=10 ** 6,
        fast_window_s=harness.PROBE_FAST_S,
        slow_window_s=harness.PROBE_SLOW_S,
        fanout_reach=True)

    return SimpleNamespace(east=east, west=west, front=front,
                           bridges=bridges, graph=g, corridor=corridor,
                           scenario=scenario, prober_cfg=prober_cfg,
                           boot_s=boot_s)


# ── metric helpers ───────────────────────────────────────────────────


def _edge_export(front_base: str, region: str):
    payload = harness.fetch(f"{front_base}/api/live?metric=1&region={region}",
                        timeout=30)
    arr = payload.get("edge_time_s")
    return (np.asarray(arr, np.float64) if arr else None), payload


def _median_ratio(base: np.ndarray, now: np.ndarray, idx) -> float:
    r = now[idx] / np.maximum(base[idx], 1e-6)
    return float(np.median(r))


def _wait_live(front_base: str, region: str, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            p = harness.fetch(f"{front_base}/api/live?region={region}",
                          timeout=10)
            if p.get("ready") and (p.get("epoch") or 0) >= 1:
                return True
        except OSError:
            pass
        time.sleep(0.5)
    return False


def _tracker_body(i: int) -> dict:
    return {"route_id": f"rf-{i}", "driver_name": f"driver-{i % 4}",
            "vehicle_type": "motorcycle", "duration": 1200.0,
            "distance": 5200.0, "trips": 1,
            "destinations": [f"stop-{i}"],
            "route": [[14.55 + 0.001 * i, 121.02]],
            "pickup_time": "2026-08-05T18:00:00"}


# ── scenarios ────────────────────────────────────────────────────────


def scenario_bridged_convergence(ctx) -> dict:
    """Jam east's corridor (east bus only); west's served metric must
    converge to the jammed prices through the bridge."""
    from bench_dispatch_cuda import CorridorSweep  # guaranteed coverage
    from routest_tpu_torch.serve.netbus import NetBus

    out: dict = {"scenario": "bridged_convergence"}
    g, corridor = ctx.graph, ctx.corridor
    rng = np.random.default_rng(7)
    off = rng.choice(np.setdiff1d(np.arange(len(g["length_m"])),
                                  corridor),
                     size=min(2000, len(g["length_m"]) - len(corridor)),
                     replace=False)
    out["corridor_edges"] = int(len(corridor))

    ready = {r: _wait_live(ctx.front.base, r, 300.0)
             for r in ("east", "west")}
    base = {}
    for r in ("east", "west"):
        arr, _ = _edge_export(ctx.front.base, r)
        base[r] = arr
    fwd0 = [b.forwarded for b in ctx.bridges]

    # The sweep publishes ONLY into east's bus: every corridor edge,
    # scenario-priced, once a second — the jam as region-east sees it.
    sweep_bus = NetBus(ctx.east.bus_url, reconnect_s=0.5)
    ctx.east.watch_bus(sweep_bus)
    sweep = CorridorSweep(sweep_bus.publish, corridor, g["length_m"],
                          g["road_class"], ctx.scenario)
    converge = {"east": None, "west": None}
    try:
        time.sleep(5.0)                 # pre-jam coverage settles
        ctx.scenario.set_active(True)
        t0 = time.monotonic()
        while time.monotonic() - t0 < CONVERGE_BOUND_S:
            for r in ("east", "west"):
                if converge[r] is not None or base[r] is None:
                    continue
                arr, _ = _edge_export(ctx.front.base, r)
                if arr is not None and \
                        _median_ratio(base[r], arr, corridor) >= JAM_RATIO:
                    converge[r] = round(time.monotonic() - t0, 1)
            if all(v is not None for v in converge.values()):
                break
            time.sleep(2.0)
        final = {}
        for r in ("east", "west"):
            arr, _ = _edge_export(ctx.front.base, r)
            if arr is not None and base[r] is not None:
                final[r] = {
                    "corridor_ratio": round(
                        _median_ratio(base[r], arr, corridor), 3),
                    "off_corridor_ratio": round(
                        _median_ratio(base[r], arr, off), 3)}
        out["converge_s"] = converge
        out["bound_s"] = CONVERGE_BOUND_S
        out["ratios"] = final
        out["bridge_forwarded"] = [
            {"src": b.src_region, "dst": b.dst_region,
             "frames": b.forwarded - f0, "dropped": b.dropped}
            for b, f0 in zip(ctx.bridges, fwd0)]
    finally:
        ctx.scenario.set_active(False)
        sweep.stop()

    checks = {
        "both_regions_live_ready": all(ready.values()),
        "east_jam_visible": converge["east"] is not None,
        "west_converged_within_bound": converge["west"] is not None,
        "off_corridor_calm": all(
            v["off_corridor_ratio"] <= CALM_RATIO
            for v in out.get("ratios", {}).values()) and bool(out.get("ratios")),
        "bridges_forwarding": all(
            row["frames"] > 0 for row in out["bridge_forwarded"]),
    }
    out["checks"] = checks
    out["pass"] = all(checks.values())
    return out


def scenario_region_loss(ctx, rate: float) -> dict:
    """``region.kill`` east: survivor absorbs, journal holds every
    write, staleness bounded+metered, the reach probe pages by name."""
    from routest_tpu_torch.chaos import _INJECTIONS
    from routest_tpu_torch.loadgen import summarize
    from routest_tpu_torch.serve.fleet.geofront import _front_metrics

    out: dict = {"scenario": "region_loss",
                 "bounds_s": {"page": PAGE_BOUND_S,
                              "user_slo_recovers": SLO_RECOVER_BOUND_S,
                              "staleness": STALE_BOUND_S}}
    front = ctx.front
    # Settle after the jam, then arm the cross-region prober and
    # require a clean baseline before pulling the trigger.
    time.sleep(15.0)
    prober = front.arm_prober(ctx.prober_cfg)
    time.sleep(8.0)
    pre_states = {n: o["state"] for n, o in
                  prober.slo.snapshot()["objectives"].items()}
    out["pre_kill_slo"] = pre_states

    m = _front_metrics()
    chaos0 = _INJECTIONS.labels(point="region.kill", kind="kill").value
    dropped0 = m["journal_dropped"].labels(region="east").value
    west_fleet0 = harness.fetch(f"{front.base}/api/metrics?region=west",
                            timeout=30).get("fleet", {})

    ctx.launches_east_pre_kill = ctx.east.launches()
    front.kill_region("east")
    t_kill = time.monotonic()
    chaos1 = _INJECTIONS.labels(point="region.kill", kind="kill").value

    # Store-mutating writes taken DURING the outage: served by the
    # survivor, journaled for the corpse.
    for i in range(K_WRITES):
        harness.post(f"{front.base}/api/update_tracker", _tracker_body(i),
                 timeout=60.0)
    # Redirected open-loop user load through the front.
    stop = threading.Event()
    records = harness.open_loop(front.base, rate, 20.0, stop=stop)
    ok = sum(1 for r in records if 200 <= r.status < 400)
    out["survivor_load"] = {"requests": len(records), "ok": ok,
                            "success_ratio": round(ok / max(1, len(records)), 4)}
    pace = harness.pace_check(summarize(records, 20.0, len(records)))
    out["pace"] = pace

    page = harness.wait_for_page(prober, PAGE_BOUND_S)
    page["since_kill_s"] = round(time.monotonic() - t_kill, 1)
    out["page"] = page
    out["reach_offenders"] = list(prober._skew_offenders.get("reach", []))

    west_fleet1 = harness.fetch(f"{front.base}/api/metrics?region=west",
                            timeout=30).get("fleet", {})
    shed_delta = (west_fleet1.get("shed", 0) or 0) \
        - (west_fleet0.get("shed", 0) or 0)
    out["survivor_shed"] = {"delta": shed_delta,
                           "frac": round(shed_delta / max(1, len(records)), 4)}
    out["survivor_autoscale"] = harness.fetch(
        f"{front.base}/api/autoscale?region=west", timeout=30)

    snap = front.snapshot()["regions"]
    out["survivor_staleness_s"] = snap["west"]["staleness_s"]
    out["journal"] = {
        "depth_east": front.journal_depth("east"),
        "dropped": m["journal_dropped"].labels(region="east").value
        - dropped0}

    # The survivor's user SLO must come back to ok inside the bound
    # (probe traffic and the region death never burn user budget).
    slo_ok_s = None
    t0 = time.monotonic()
    while time.monotonic() - t0 < SLO_RECOVER_BOUND_S:
        worst = harness.fetch(f"{front.base}/api/slo", timeout=30)["worst"]
        if worst == "ok":
            slo_ok_s = round(time.monotonic() - t0, 1)
            break
        time.sleep(1.0)
    out["user_slo_ok_s"] = slo_ok_s

    checks = {
        "pre_kill_clean": all(s == "ok" for s in pre_states.values()),
        "chaos_recorded": chaos1 == chaos0 + 1,
        "survivor_absorbs": out["survivor_load"]["success_ratio"] >= 0.8,
        "shed_bounded": out["survivor_shed"]["frac"] <= 0.2,
        "paged_within_bound": bool(page.get("paged")),
        "dead_region_named": out["reach_offenders"] == ["east"],
        "journal_holds_writes":
            out["journal"]["depth_east"] == K_WRITES
            and out["journal"]["dropped"] == 0,
        "survivor_staleness_bounded":
            0.0 <= out["survivor_staleness_s"] <= STALE_BOUND_S,
        "user_slo_recovers": slo_ok_s is not None,
    }
    out["checks"] = checks
    # the survivor load's pace is recorded, not gated: its checks read
    # answers, not latency
    out["pass"] = all(checks.values())
    return out


def scenario_rejoin(ctx) -> dict:
    """East returns: journal drains (zero lost writes), live state
    catches up through bridge replay, the page clears, clean window."""
    from routest_tpu_torch.serve.fleet.geofront import _front_metrics

    out: dict = {"scenario": "rejoin",
                 "bounds_s": {"catch_up": CATCHUP_BOUND_S,
                              "clean_watch": CLEAN_S}}
    front, prober = ctx.front, ctx.front.prober
    m = _front_metrics()
    replayed0 = m["journal_replayed"].labels(region="east").value
    dropped0 = m["journal_dropped"].labels(region="east").value
    depth0 = front.journal_depth("east")
    out["journal_depth_at_rejoin"] = depth0

    t_rejoin = time.monotonic()
    front.rejoin_region("east")
    ready = ctx.east.fleet.wait_ready(timeout=600)
    out["respawn_s"] = round(time.monotonic() - t_rejoin, 3)
    ctx.launches_east_rejoined = ctx.east.launches()

    drained_s = caught_up_s = None
    t0 = time.monotonic()
    while time.monotonic() - t0 < CATCHUP_BOUND_S:
        if drained_s is None and front.journal_depth("east") == 0:
            drained_s = round(time.monotonic() - t0, 1)
        if caught_up_s is None:
            try:
                p = harness.fetch(f"{front.base}/api/live?region=east",
                              timeout=10)
                ingest = p.get("ingest") or {}
                if p.get("ready") and (p.get("epoch") or 0) >= 1 \
                        and (ingest.get("total_observations") or 0) > 0:
                    caught_up_s = round(time.monotonic() - t0, 1)
            except OSError:
                pass
        if drained_s is not None and caught_up_s is not None:
            break
        time.sleep(1.0)
    out["drained_s"] = drained_s
    out["caught_up_s"] = caught_up_s
    out["bound_s"] = CATCHUP_BOUND_S
    out["journal"] = {
        "replayed": m["journal_replayed"].labels(region="east").value
        - replayed0,
        "dropped": m["journal_dropped"].labels(region="east").value
        - dropped0}

    # The reach offender and the page must clear…
    reach_clear_s = no_page_s = None
    t0 = time.monotonic()
    while time.monotonic() - t0 < CATCHUP_BOUND_S:
        if not prober._skew_offenders.get("reach"):
            reach_clear_s = reach_clear_s or round(
                time.monotonic() - t0, 1)
            snap = prober.slo.snapshot()["objectives"]
            if all(o["state"] != "page" for o in snap.values()):
                no_page_s = round(time.monotonic() - t0, 1)
                break
        time.sleep(1.0)
    out["reach_clear_s"] = reach_clear_s
    out["no_page_s"] = no_page_s

    # …and a quiet watch window records zero NEW correctness failures.
    fail0 = len(prober._failures)
    time.sleep(CLEAN_S)
    out["clean_window"] = {"seconds": CLEAN_S,
                           "new_failures": len(prober._failures) - fail0}
    out["regions"] = ctx.front.snapshot()["regions"]

    checks = {
        "rejoined_ready": ready,
        "journal_drained": drained_s is not None,
        "all_writes_replayed":
            out["journal"]["replayed"] == depth0
            and out["journal"]["dropped"] == 0,
        "live_caught_up": caught_up_s is not None,
        "reach_clears": reach_clear_s is not None,
        "page_clears": no_page_s is not None,
        "clean_window_quiet": out["clean_window"]["new_failures"] == 0,
    }
    out["checks"] = checks
    out["pass"] = all(checks.values())
    return out


def _launches_total(ctx) -> dict:
    """Fused launches the regions' replicas made over the scenarios:
    west's over the whole run, east's up to its kill and again after
    its rejoin (a killed replica takes its count with it)."""
    def delta(after, before):
        return sum(max(0, v - before.get(rid, 0))
                   for rid, v in after.items())

    out = {"west": delta(ctx.west.launches(), ctx.launches0["west"])}
    east = delta(getattr(ctx, "launches_east_pre_kill", {}),
                 ctx.launches0["east"])
    rejoined = getattr(ctx, "launches_east_rejoined", None)
    if rejoined is not None:
        east += delta(ctx.east.launches(), rejoined)
    out["east"] = east
    out["total"] = out["west"] + east
    return out


# ── record ───────────────────────────────────────────────────────────


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="smaller extract")
    parser.add_argument("--cpu", action="store_true",
                        help="serve both regions on the CPU "
                             "(ROUTEST_DEVICE=cpu); without it the "
                             "script needs a card")
    parser.add_argument("--nodes", type=int, default=6000)
    parser.add_argument("--rate", type=float, default=2.0)
    parser.add_argument("--cache-dir", default=os.path.join(
        REPO, "build", "bench_cache", "region_failover_cuda"))
    parser.add_argument("--out", default=None,
                        help="record path (default: artifacts/"
                             "region_failover_cuda.json; build/"
                             "region_failover_cpu.json with --cpu)")
    args = parser.parse_args()
    device = harness.require_card(args.cpu, "bench_region_failover_cuda")
    if args.out is None:
        args.out = os.path.join(REPO, "artifacts",
                                "region_failover_cuda.json") \
            if device == "cuda" \
            else os.path.join(REPO, "build", "region_failover_cpu.json")
    if args.quick:
        args.nodes = min(args.nodes, 4000)
    os.makedirs(args.cache_dir, exist_ok=True)
    os.environ["ROUTEST_HIER_CACHE"] = os.path.join(args.cache_dir, "hier")

    t0 = time.time()
    print(f"[1/5] extract + overlay cache ({args.nodes:,} nodes)…",
          flush=True)
    extract = harness.build_extract(args.nodes, args.cache_dir)

    work = tempfile.mkdtemp(prefix="region-failover-")
    record: dict = {}
    checks: dict = {}
    scenarios: dict = {}
    ctx = None
    print("[2/5] booting two regions + geo-front + bridges…", flush=True)
    try:
        ctx = _build_topology(extract, args.cache_dir, work, device)
        record["boot_s"] = ctx.boot_s
        ctx.launches0 = {r.name: r.launches() for r in (ctx.east, ctx.west)}
        plan = [
            ("bridged_convergence",
             lambda: scenario_bridged_convergence(ctx)),
            ("region_loss", lambda: scenario_region_loss(ctx, args.rate)),
            ("rejoin", lambda: scenario_rejoin(ctx)),
        ]
        for i, (name, run) in enumerate(plan):
            print(f"[{i + 3}/5] scenario {name}…", flush=True)
            t = time.perf_counter()
            try:
                scenarios[name] = run()
            except Exception as e:
                scenarios[name] = {"scenario": name, "pass": False,
                                   "error": f"{type(e).__name__}: {e}"}
            scenarios[name]["wall_s"] = round(time.perf_counter() - t, 1)
            checks[name] = bool(scenarios[name].get("pass"))
            print(f"  {name}: {'PASS' if checks[name] else 'FAIL'} "
                  f"({scenarios[name]['wall_s']}s) "
                  f"{json.dumps(scenarios[name].get('checks'))}",
                  flush=True)
        record["launches"] = _launches_total(ctx)
    finally:
        if ctx is not None:
            ctx.front.drain(timeout=10)
            ctx.east.stop()
            ctx.west.stop()
        shutil.rmtree(work, ignore_errors=True)
    record["scenarios"] = scenarios
    record.update({
        "generated_unix": int(t0),
        "card": harness.card_identity(device),
        "host": {"cpus": harness.card_identity("cpu")["cpu_count"],
                 "platform": sys.platform, "device": device},
        "config": {
            "nodes": args.nodes, "rate_rps": args.rate,
            "drivers_per_region": DRIVERS,
            "jam_speed_factor": JAM_SPEED_FACTOR,
            "jam_width_m": JAM_WIDTH_M,
            "jam_ratio": JAM_RATIO, "calm_ratio": CALM_RATIO,
            "converge_bound_s": CONVERGE_BOUND_S,
            "page_bound_s": PAGE_BOUND_S,
            "slo_recover_bound_s": SLO_RECOVER_BOUND_S,
            "catchup_bound_s": CATCHUP_BOUND_S,
            "clean_s": CLEAN_S,
            "stale_bound_s": STALE_BOUND_S,
            "journal_writes": K_WRITES,
            "quick": bool(args.quick),
        },
        "checks": checks,
    })
    record["all_pass"] = (len(checks) == 3 and all(checks.values()))
    record["wall_s"] = round(time.time() - t0, 1)
    harness.write_record(args.out, record)
    print(f"\nwrote {args.out} "
          f"(all_pass={record['all_pass']}, {record['wall_s']}s)",
          flush=True)
    # _exit: probe-driver daemon threads racing interpreter teardown
    # must not turn a written verdict into a crash
    os._exit(0 if record["all_pass"] else 1)


if __name__ == "__main__":
    main()
