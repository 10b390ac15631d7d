"""Replica supervisor: keep N worker processes alive, restart crashes.

The counterpart of ``routest_tpu/serve/fleet/supervisor.py``. Each
replica is a full server process (default command:
``python -m routest_tpu_torch.serve`` with ``PORT`` set) — shared-nothing, so
a crash takes out one batcher, not the fleet. The monitor thread
detects exits AND failed health probes (``/up``), restarts with capped
exponential backoff (a worker that keeps dying must not busy-loop the
host), and resets the backoff once a worker has been up long enough to
count as stable. ``drain()`` is the SIGTERM path: TERM every child,
wait, KILL stragglers.

The fleet is **elastic**: ``add_replica``/``remove_replica``/
``scale_to`` change membership at runtime (the autoscaler's actuators,
``serve/fleet/autoscaler.py``). Added replicas follow the normal
spawn/startup-probe path (``wait_port_ready`` is the explicit startup
probe); removed ones are *retired* — flagged so the monitor never
restarts them — then SIGTERMed, which the worker's graceful-shutdown
path turns into drain-then-exit. Replica indices are minted from a
monotonic counter and never reused, so the ``r<i>`` identity in logs,
metrics, and the gateway stays unambiguous across scale events.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.supervisor")
_m_restarts = get_registry().counter(
    "rtpu_supervisor_restarts_total",
    "Worker restarts (crash or failed liveness).", ("replica",))


# Fresh replica ports are drawn from [_LOWEST_PORT, the ephemeral
# range's low end) when that pool holds at least _MIN_POOL ports.
_LOWEST_PORT = 10000
_MIN_POOL = 1000


def ephemeral_port_range() -> Optional[Tuple[int, int]]:
    """``/proc/sys/net/ipv4/ip_local_port_range`` → (low, high), or None
    where it cannot be read."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low, high = (int(v) for v in f.read().split()[:2])
    except (OSError, ValueError):
        return None
    return low, high


def free_port() -> int:
    """A free loopback port outside the host's ephemeral range, below
    it where there is room, else above it. A closed client connection
    (a probe, a ``urllib`` scrape, a load generator's reset) leaves its
    TIME_WAIT on an ephemeral port, and a replica spawned on such a
    port cannot bind it and exits 1 (ROADMAP Queue C 14): a port outside
    the range is never one. Deliberate divergence: the JAX supervisor
    takes the OS's ephemeral pick. Where the range cannot be read, the
    OS picks as before."""
    span = ephemeral_port_range()
    if span is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    low, high = span
    rng = random.Random()
    below = range(_LOWEST_PORT, low)
    above = range(high + 1, 65536)
    for pool in (below, above):
        if len(pool) < _MIN_POOL:
            continue
        for _ in range(64):
            port = rng.choice(pool)
            try:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port))
                return port
            except OSError:
                continue
    raise RuntimeError(f"supervisor: no free port outside the "
                       f"ephemeral range {low}-{high}")


def default_worker_command(port: int) -> List[str]:
    # The existing single-process stack IS the worker; the supervisor
    # only multiplies it.
    return [sys.executable, "-m", "routest_tpu_torch.serve"]


class _Replica:
    __slots__ = ("index", "port", "proc", "restarts", "started_at",
                 "next_start_at", "consecutive_crashes", "health_failures",
                 "last_exit_code", "last_probe_at", "ever_up", "waiting",
                 "retired", "env", "version", "placement_env", "chips",
                 "capacity", "placement_label")

    def __init__(self, index: int, port: int,
                 env: Optional[Dict[str, str]] = None,
                 version: Optional[str] = None,
                 placement: Optional[Dict[str, str]] = None,
                 chips: int = 1, capacity: Optional[float] = None,
                 label: Optional[str] = None) -> None:
        # Set under the supervisor lock when the replica is being
        # scaled away: the monitor must never restart a retired worker.
        self.retired = False
        self.index = index
        self.port = port
        # Per-replica env overlay + version label (safe change delivery:
        # a canary runs the same command with a different overlay —
        # model path, chaos spec, RTPU_VERSION — and the monitor's
        # respawns reuse the SAME overlay, so a restart never silently
        # reverts a replica to the fleet default).
        self.env = dict(env) if env else None
        self.version = version
        # Topology: the placement overlay that pins this replica's
        # devices (kept SEPARATE from the rollout overlay above so a
        # rolling restart can change the version overlay while the
        # device pinning survives verbatim), how many chips the slice
        # owns, and its capacity units (predicted throughput in 1-chip
        # units — what the gateway's weighted router normalizes by).
        self.placement_env = dict(placement) if placement else None
        self.chips = max(1, int(chips))
        self.capacity = float(capacity) if capacity else float(self.chips)
        self.placement_label = label
        self.proc: Optional[subprocess.Popen] = None
        self.restarts = 0
        self.started_at = 0.0
        self.next_start_at = 0.0          # backoff gate for the next spawn
        self.consecutive_crashes = 0
        self.health_failures = 0
        self.last_exit_code: Optional[int] = None
        self.last_probe_at = 0.0
        # Startup-probe semantics: liveness failures only count once the
        # worker has answered /up at least once this incarnation — a
        # slow boot (torch import, kernel build + bucket warm) must not
        # be killed into a restart loop.
        self.ever_up = False
        self.waiting = False              # crashed, sitting out backoff


class ReplicaSupervisor:
    """Spawn + babysit one worker process per port.

    ``command`` maps a port to an argv (tests substitute a cheap stub
    worker); ``env`` is the base environment — ``PORT`` is set per
    worker. A worker is restarted when its process exits OR when
    ``unhealthy_after`` consecutive ``/up`` probes fail (hung-but-alive
    processes are indistinguishable from dead ones to callers).
    """

    # A worker that stayed up this long gets its crash backoff reset.
    STABLE_RESET_S = 30.0

    def __init__(self, ports: Sequence[int],
                 command: Optional[Callable[[int], List[str]]] = None,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 unhealthy_after: int = 3,
                 backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0,
                 health_path: str = "/up",
                 quiet: bool = True,
                 version: Optional[str] = None,
                 placement=None) -> None:
        # Fleet-default version label + env overlay for NEW replicas
        # (``set_default`` repoints them after a promoted rollout, so
        # autoscaler spawns come up on the promoted version).
        self._default_version = version
        self._default_overlay: Optional[Dict[str, str]] = None
        # Topology-aware placement (serve/fleet/placement.py): slice i
        # pins replica i's devices via its env overlay; growth spawns
        # (autoscaler) take the plan's growth slice instead of an
        # unpinned 1-chip default. None = the device-blind legacy
        # behavior (every replica sees whatever the base env shows).
        self._plan = placement
        slices = list(placement.slices) if placement is not None else []
        self._replicas = []
        for i, p in enumerate(ports):
            s = slices[i] if i < len(slices) else (
                placement.growth_slice(i) if placement is not None
                else None)
            self._replicas.append(_Replica(
                i, p, version=version,
                placement=dict(s.env) if s is not None else None,
                chips=s.chips if s is not None else 1,
                capacity=s.capacity if s is not None else None,
                label=s.label if s is not None else None))
        self._next_index = len(self._replicas)   # monotonic, never reused
        self._command = command or default_worker_command
        self._env = dict(env if env is not None else os.environ)
        self._cwd = cwd
        self._probe_interval_s = probe_interval_s
        self._probe_timeout_s = probe_timeout_s
        self._unhealthy_after = max(1, unhealthy_after)
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._health_path = health_path
        self._quiet = quiet
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ── lifecycle ──────────────────────────────────────────────────────

    @property
    def ports(self) -> List[int]:
        with self._lock:
            return [r.port for r in self._replicas if not r.retired]

    def replica_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if not r.retired)

    def start(self) -> None:
        for r in list(self._replicas):
            self._spawn(r)
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="fleet-supervisor")
        self._thread.start()

    def _spawn(self, r: _Replica) -> None:
        env = dict(self._env)
        # Placement (device pinning) under the rollout overlay: a
        # canary/rollout overlay may change anything EXCEPT which
        # devices the replica owns — unless it explicitly names one of
        # the placement keys, in which case the operator wins.
        if r.placement_env:
            env.update(r.placement_env)
        if r.env:
            env.update(r.env)
        env["PORT"] = str(r.port)
        argv = self._command(r.port)
        # Chaos fault point ``replica.boot`` (+ a per-version variant so
        # a spec can doom exactly one rollout's spawns): a boot fault
        # cannot raise inside a worker that does not exist yet, so the
        # injection happens HERE and substitutes an argv that exits
        # immediately — the monitor sees a real crash and walks the
        # normal backoff-restart path, which is exactly what a bad
        # deploy's crash loop looks like. A ``latency`` rule simply
        # delays the spawn (slow boot).
        from routest_tpu_torch.chaos import ChaosError
        from routest_tpu_torch.chaos import inject as chaos_inject

        try:
            chaos_inject("replica.boot")
            if r.version:
                chaos_inject(f"replica.boot.{r.version}")
        except ChaosError as e:
            argv = [sys.executable, "-c", "import sys; sys.exit(13)"]
            _log.warning("replica_boot_chaos", index=r.index, port=r.port,
                         version=r.version, error=str(e))
        out = subprocess.DEVNULL if self._quiet else None
        r.proc = subprocess.Popen(argv, env=env,
                                  cwd=self._cwd, stdout=out, stderr=out)
        r.started_at = time.time()
        r.health_failures = 0
        r.ever_up = False
        r.waiting = False
        r.last_exit_code = None
        _log.info("replica_spawned", index=r.index, port=r.port,
                  pid=r.proc.pid, restarts=r.restarts, version=r.version)

    def ready(self, timeout: float = 240.0) -> bool:
        """Block until every replica answers its health probe."""
        deadline = time.time() + timeout
        with self._lock:
            replicas = [r for r in self._replicas if not r.retired]
        for r in replicas:
            while time.time() < deadline and not self._stopping.is_set():
                if self._probe(r.port):
                    break
                time.sleep(0.2)
            else:
                return False
        return True

    # ── elastic membership ─────────────────────────────────────────────

    def add_replica(self, port: Optional[int] = None, *,
                    env: Optional[Dict[str, str]] = None,
                    version: Optional[str] = None,
                    placement: Optional[Dict[str, str]] = None,
                    chips: Optional[int] = None,
                    capacity: Optional[float] = None,
                    label: Optional[str] = None) -> Tuple[int, int]:
        """Spawn one more worker → ``(index, port)``. The index comes
        from the monotonic counter (never reused); the port defaults to
        a fresh one outside the ephemeral range (``free_port``) —
        deterministic ``base_port + i`` schemes collide with retired
        ports still in TIME_WAIT. The
        caller owns readiness (``wait_port_ready`` is the startup
        probe); the monitor babysits the new worker like any other.

        ``env`` overlays the base environment for THIS replica (and its
        monitor respawns); ``version`` labels it for rollout/version-
        skew tracking. Both default to the fleet defaults installed by
        ``set_default`` (which a promoted rollout repoints).
        ``placement``/``chips``/``capacity``/``label`` pin the device
        slice; when omitted and a placement plan is installed, the
        plan's growth slice is used — autoscaler growth spawns the next
        slice of the plan, never an unpinned 1-chip default."""
        if port is None:
            port = free_port()
        with self._lock:
            if env is None:
                env = self._default_overlay
            if version is None:
                version = self._default_version
            if placement is None and chips is None \
                    and self._plan is not None:
                s = self._plan.growth_slice(self._next_index)
                placement, chips = dict(s.env), s.chips
                capacity, label = s.capacity, s.label
            r = _Replica(self._next_index, port, env=env, version=version,
                         placement=placement, chips=chips or 1,
                         capacity=capacity, label=label)
            self._next_index += 1
            self._replicas.append(r)
            self._spawn(r)
        return r.index, r.port

    def set_default(self, env: Optional[Dict[str, str]] = None,
                    version: Optional[str] = None) -> None:
        """Repoint the fleet default overlay/version for FUTURE spawns
        (the promote step of a rollout: once the new version owns the
        fleet, autoscaler growth must come up on it too)."""
        with self._lock:
            self._default_overlay = dict(env) if env else None
            self._default_version = version

    def replica_status(self, index: int) -> Optional[Dict]:
        """One replica's liveness/restart view → dict or None for an
        unknown/retired index. The rollout controller's boot watch
        reads this: a spawn that keeps exiting shows up as a climbing
        ``restarts`` long before any startup-probe timeout."""
        with self._lock:
            r = next((x for x in self._replicas
                      if x.index == index and not x.retired), None)
            if r is None:
                return None
            return {
                "index": r.index,
                "port": r.port,
                "alive": r.proc is not None and r.proc.poll() is None,
                "restarts": r.restarts,
                "ever_up": r.ever_up,
                "last_exit_code": r.last_exit_code,
                "version": r.version,
                "env": dict(r.env) if r.env else None,
                "placement_env": dict(r.placement_env)
                if r.placement_env else None,
                "chips": r.chips,
                "capacity": r.capacity,
                "placement_label": r.placement_label,
            }

    def wait_port_ready(self, port: int, timeout: float = 120.0) -> bool:
        """Startup probe for one replica: poll ``/up`` until it answers
        (or the supervisor is stopping / the timeout lapses)."""
        deadline = time.time() + timeout
        while time.time() < deadline and not self._stopping.is_set():
            if self._probe(port):
                return True
            time.sleep(0.2)
        return False

    def remove_replica(self, index: int, timeout: float = 20.0) -> bool:
        """Retire + stop the replica with supervisor index ``index``
        (drain-then-stop: SIGTERM first — the worker's graceful-
        shutdown path finishes inflight requests — then SIGKILL past
        ``timeout``). Returns False for an unknown/already-retired
        index. Callers that front this replica with a gateway must
        deregister it there FIRST so no new work routes to it."""
        with self._lock:
            r = next((x for x in self._replicas
                      if x.index == index and not x.retired), None)
            if r is None:
                return False
            r.retired = True        # the monitor must not restart it
            proc = r.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
            except OSError:
                pass
        with self._lock:
            self._replicas = [x for x in self._replicas
                              if x.index != index]
        _log.info("replica_retired", index=index, port=r.port)
        return True

    def scale_to(self, n: int) -> Dict[str, List[Tuple[int, int]]]:
        """Grow or shrink the fleet to ``n`` workers → ``{"added":
        [(index, port), …], "removed": [(index, port), …]}``. Shrinking
        retires the newest replicas first (LIFO keeps long-lived
        identities stable). Growing spawns; readiness is the caller's
        to await (``wait_port_ready``)."""
        n = max(0, int(n))
        added: List[Tuple[int, int]] = []
        removed: List[Tuple[int, int]] = []
        while self.replica_count() < n:
            added.append(self.add_replica())
        while self.replica_count() > n:
            with self._lock:
                live = [r for r in self._replicas if not r.retired]
                victim = max(live, key=lambda r: r.index)
            if not self.remove_replica(victim.index):
                break
            removed.append((victim.index, victim.port))
        return {"added": added, "removed": removed}

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful stop: TERM everyone, wait, KILL stragglers."""
        self._stopping.set()
        with self._lock:
            procs = [r.proc for r in self._replicas
                     if r.proc is not None and r.proc.poll() is None]
        for p in procs:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.time() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def kill_replica(self, index: int) -> bool:
        """Chaos hook — the ``replica.kill`` fault point. Hard-kills one
        worker process (SIGKILL: a crash, not a drain); the monitor
        notices the exit and walks the normal backoff-restart path.
        Returns True when a live process was killed. A process kill
        cannot be a probability draw inside the victim, so the harness
        actuates it here and the chaos ledger records it."""
        with self._lock:
            r = next((x for x in self._replicas if x.index == index), None)
            if r is None:
                return False
            proc = r.proc
            if proc is None or proc.poll() is not None:
                return False
        try:
            proc.kill()
        except OSError:
            return False
        from routest_tpu_torch.chaos import get_chaos

        get_chaos().record("replica.kill", "kill")
        _log.warning("replica_chaos_killed", index=index, port=r.port,
                     pid=proc.pid)
        return True

    # ── monitoring ─────────────────────────────────────────────────────

    def _probe(self, port: int) -> bool:
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{self._health_path}")
            with urllib.request.urlopen(
                    req, timeout=self._probe_timeout_s) as resp:
                return 200 <= resp.status < 400
        except Exception:  # rtpulint: disable=broad-except-unlogged -- liveness probe: any failure maps to unhealthy=False
            return False

    def _backoff_s(self, r: _Replica) -> float:
        return min(self._backoff_cap_s,
                   self._backoff_base_s * (2 ** max(0, r.consecutive_crashes - 1)))

    def _note_crash(self, r: _Replica) -> None:
        # Stable-for-a-while workers crash with a fresh backoff clock.
        if time.time() - r.started_at > self.STABLE_RESET_S:
            r.consecutive_crashes = 0
        r.consecutive_crashes += 1
        r.restarts += 1
        _m_restarts.labels(replica=f"r{r.index}").inc()
        r.next_start_at = time.time() + self._backoff_s(r)

    def _monitor(self) -> None:
        while not self._stopping.is_set():
            with self._lock:
                replicas = list(self._replicas)   # membership may change
            for r in replicas:
                now = time.time()
                with self._lock:
                    if self._stopping.is_set() or r.proc is None \
                            or r.retired:
                        continue
                    code = r.proc.poll()
                    if code is not None:
                        if not r.waiting:
                            r.waiting = True
                            r.last_exit_code = code
                            self._note_crash(r)
                            _log.error("replica_exited", index=r.index,
                                       port=r.port, code=code,
                                       backoff_s=round(
                                           r.next_start_at - now, 2))
                        elif r.next_start_at <= now:
                            self._spawn(r)
                        continue
                # Alive — liveness probe OUTSIDE the lock (2 s timeout
                # each; holding the lock would stall drain()).
                if now - r.last_probe_at < self._probe_interval_s:
                    continue
                r.last_probe_at = now
                if self._probe(r.port):
                    r.ever_up = True
                    r.health_failures = 0
                    if now - r.started_at > self.STABLE_RESET_S:
                        r.consecutive_crashes = 0
                elif r.ever_up:
                    r.health_failures += 1
                    if r.health_failures >= self._unhealthy_after:
                        _log.error("replica_unresponsive", index=r.index,
                                   port=r.port, failures=r.health_failures)
                        with self._lock:
                            if r.proc is not None:
                                try:
                                    r.proc.kill()
                                except OSError:
                                    pass
                        # the exit is picked up next tick → backoff path
            self._stopping.wait(min(0.2, self._probe_interval_s))

    # ── observability ──────────────────────────────────────────────────

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for r in self._replicas:
                if r.retired:
                    continue
                alive = r.proc is not None and r.proc.poll() is None
                out[f"r{r.index}"] = {
                    "port": r.port,
                    "alive": alive,
                    "restarts": r.restarts,
                    "version": r.version,
                    "chips": r.chips,
                    "capacity": r.capacity,
                    "placement": r.placement_label,
                    "uptime_s": round(time.time() - r.started_at, 1)
                    if alive else 0.0,
                }
            return out
