"""SLO-driven autoscaler: close the loop from signals to fleet size.

The counterpart of ``routest_tpu/serve/fleet/autoscaler.py``. The
gateway and the SLO engine give the signals (admission-queue depth,
per-replica outstanding, burn-rate SLOs), the supervisor and the
gateway's registration the actuators; this module is the controller in
between, shaped like
Autopilot's horizontal scaling loop (Rzadca et al., EuroSys 2020):
read service signals, decide with hysteresis, actuate within bounds,
and record every decision where the postmortem can find it.

Control policy (knobs: ``AutoscaleConfig`` / ``RTPU_AUTOSCALE_*``):

- **Scale up** when ANY pressure signal holds for ``up_stable_ticks``
  consecutive ticks: the admission queue is ≥ ``up_queue_frac``
  occupied, outstanding per fleet CAPACITY UNIT ≥ ``up_outstanding``
  (capacity-weighted: a 4-chip mesh replica counts as 4 units, so a
  mesh-heavy fleet is not scaled as if every replica were 1-chip), or
  the worst fast-window SLO burn ≥ ``up_burn``. OR-semantics because
  each signal sees a different failure mode first (queue depth leads
  latency; burn leads availability).
- **Scale down** only when EVERY quiet signal holds for
  ``down_stable_ticks`` ticks: empty queue, outstanding ≤
  ``down_outstanding``, burn below ``up_burn``. AND-semantics plus a
  longer cooldown: flapping down during a lull costs a cold boot when
  the next wave lands.
- Cooldowns gate each direction separately; ``min_replicas`` /
  ``max_replicas`` bound the actuation; a scale-up that cannot finish
  booting within ``startup_timeout_s`` is abandoned and retired.

Actuation is asynchronous where it must be: a spawned worker boots for
seconds (torch import, kernel build + model load), so the tick loop tracks it
as *pending* and registers it with the gateway — through the half-open
probe path — only once its startup probe answers. Removal inverts the
order: deregister at the gateway first (drain: no new picks, inflight
finishes), then SIGTERM via the supervisor.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional

from routest_tpu_torch.core.config import AutoscaleConfig, load_autoscale_config
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.autoscaler")


@dataclasses.dataclass
class Signals:
    """One tick's view of the fleet — separated from the decision so
    tests can drive the policy with synthetic inputs."""

    replicas: int               # registered, non-draining upstreams
    pending: int                # spawned, not yet past startup probe
    queued: int
    queue_depth: int
    inflight: int
    max_inflight: int
    outstanding: int            # summed across live upstreams
    burn_fast: float            # worst fast-window burn across objectives
    # Total capacity units across live upstreams (1-chip-replica
    # equivalents). 0.0 = unknown topology → fall back to the replica
    # count, which is exactly the old per-replica semantics.
    capacity: float = 0.0
    pending_capacity: float = 0.0

    @property
    def queue_frac(self) -> float:
        return self.queued / self.queue_depth if self.queue_depth else 0.0

    @property
    def outstanding_per_replica(self) -> float:
        return self.outstanding / max(1, self.replicas)

    @property
    def outstanding_per_capacity(self) -> float:
        """Outstanding normalized by FLEET CAPACITY UNITS, not replica
        count — the pre-placement signal treated a 4-chip replica like
        a 1-chip one, so a mesh-heavy fleet scaled up 4× too eagerly
        (and a shrink decision compared against the wrong load)."""
        return self.outstanding / max(1.0, self.capacity
                                      or float(self.replicas))


@dataclasses.dataclass
class _Pending:
    index: int
    port: int
    spawned_at: float
    chips: int = 1
    capacity: float = 1.0


class Autoscaler:
    """Ticks on a daemon thread; owns no state the gateway/supervisor
    don't already have except the decision history."""

    def __init__(self, supervisor, gateway,
                 config: Optional[AutoscaleConfig] = None) -> None:
        self.supervisor = supervisor
        self.gateway = gateway
        self.config = config or load_autoscale_config()
        self._pending: List[_Pending] = []
        self._up_ticks = 0
        self._down_ticks = 0
        self._rollout_hold = False
        self._last_up = -float("inf")
        self._last_down = -float("inf")
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self._history: Deque[dict] = collections.deque(maxlen=64)
        reg = get_registry()
        self._m_decisions = reg.counter(
            "rtpu_autoscale_decisions_total",
            "Autoscale actuations, by direction.", ("direction",))
        from routest_tpu_torch.obs.recorder import get_recorder

        self._recorder = get_recorder()
        gateway.autoscaler = self

    # ── signals ───────────────────────────────────────────────────────

    def read_signals(self) -> Signals:
        gw = self.gateway
        with gw._lock:
            live = [r for r in gw.replicas if not r.draining]
            outstanding = sum(r.outstanding for r in live)
            capacity = sum(getattr(r, "capacity", 1.0) for r in live)
            n_live = len(live)
            queued = gw._waiters
            inflight = gw._inflight
        burn = 0.0
        if gw.slo is not None:
            snap = gw.slo.snapshot()
            burns = [o.get("burn_fast", 0.0)
                     for o in snap.get("objectives", {}).values()]
            burn = max(burns, default=0.0)
        with self._lock:
            pending = len(self._pending)
            pending_cap = sum(p.capacity for p in self._pending)
        return Signals(
            replicas=n_live, pending=pending, queued=queued,
            queue_depth=gw.config.queue_depth, inflight=inflight,
            max_inflight=gw.config.max_inflight,
            outstanding=outstanding, burn_fast=burn,
            capacity=capacity, pending_capacity=pending_cap)

    # ── policy (pure-ish: counters live on self, inputs are Signals) ──

    def pressure(self, sig: Signals) -> List[str]:
        """The scale-up signals currently firing, by name (the decision
        history records WHY, not just that)."""
        cfg = self.config
        out = []
        if sig.queue_frac >= cfg.up_queue_frac:
            out.append(f"queue_frac={sig.queue_frac:.2f}")
        if sig.outstanding_per_capacity >= cfg.up_outstanding:
            out.append(
                f"outstanding_per_capacity="
                f"{sig.outstanding_per_capacity:.1f}")
        if sig.burn_fast >= cfg.up_burn:
            out.append(f"burn_fast={sig.burn_fast:.1f}")
        return out

    def quiet(self, sig: Signals) -> bool:
        cfg = self.config
        return (sig.queued == 0
                and sig.outstanding_per_capacity <= cfg.down_outstanding
                and sig.burn_fast < cfg.up_burn)

    def decide(self, sig: Signals,
               now: Optional[float] = None) -> Optional[str]:
        """→ ``"up"``, ``"down"``, or None. Updates the hysteresis
        counters; respects bounds + cooldowns. Pending spawns count
        toward the size bound (a booting replica is capacity already
        ordered — ordering more each tick is how controllers
        overshoot)."""
        now = time.monotonic() if now is None else now
        cfg = self.config
        total = sig.replicas + sig.pending
        reasons = self.pressure(sig)
        if reasons:
            self._up_ticks += 1
            self._down_ticks = 0
        elif self.quiet(sig):
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = 0
            self._down_ticks = 0
        if (reasons and self._up_ticks >= cfg.up_stable_ticks
                and total < cfg.max_replicas
                and now - self._last_up >= cfg.up_cooldown_s):
            return "up"
        if (self._down_ticks >= cfg.down_stable_ticks
                and sig.replicas > cfg.min_replicas
                and sig.pending == 0
                and now - self._last_down >= cfg.down_cooldown_s):
            return "down"
        return None

    # ── actuation ─────────────────────────────────────────────────────

    def _scale_up(self, sig: Signals, reasons: List[str]) -> None:
        cfg = self.config
        n_new = min(cfg.up_step,
                    cfg.max_replicas - (sig.replicas + sig.pending))
        spawned = []
        for _ in range(max(0, n_new)):
            # The supervisor spawns the placement plan's growth slice
            # (device overlay + chips) — not a bare 1-chip default.
            index, port = self.supervisor.add_replica()
            status = self.supervisor.replica_status(index) or {}
            chips = int(status.get("chips") or 1)
            capacity = float(status.get("capacity") or chips)
            with self._lock:
                self._pending.append(_Pending(index, port,
                                              time.monotonic(),
                                              chips=chips,
                                              capacity=capacity))
            spawned.append({"index": index, "port": port, "chips": chips,
                            "capacity": capacity,
                            "placement": status.get("placement_label")})
        self._last_up = time.monotonic()
        self._up_ticks = 0
        self._m_decisions.labels(direction="up").inc()
        record_change("autoscale.grow",
                      detail={"reasons": reasons,
                              "spawned": len(spawned),
                              "replicas": sig.replicas})
        detail = {"direction": "up", "reasons": reasons,
                  "spawned": spawned, "replicas": sig.replicas,
                  "pending": sig.pending + len(spawned)}
        self._note(detail)

    def _scale_down(self, sig: Signals) -> None:
        cfg = self.config
        gw = self.gateway
        # Victim: the non-draining upstream with the fewest outstanding
        # requests, newest id on ties (LIFO keeps r0's history stable).
        with gw._lock:
            live = [r for r in gw.replicas if not r.draining]
            if len(live) <= cfg.min_replicas:
                return
            victim = min(live, key=lambda r: (r.outstanding, -_rid_num(r.id)))
            rid = victim.id
        self._last_down = time.monotonic()
        self._down_ticks = 0
        self._m_decisions.labels(direction="down").inc()
        record_change("autoscale.shrink",
                      detail={"replica": rid, "replicas": sig.replicas})
        self._note({"direction": "down", "replica": rid,
                    "replicas": sig.replicas})
        # Deregister first (drain: no new picks, inflight finishes),
        # THEN stop the process. Both block; we are on the tick thread
        # and the down-cooldown absorbs the pause.
        gw.remove_replica(rid, timeout=cfg.drain_timeout_s)
        self.supervisor.remove_replica(_rid_num(rid),
                                       timeout=cfg.drain_timeout_s)
        self._note({"direction": "down", "replica": rid,
                    "phase": "stopped"})

    def _admit_pending(self) -> None:
        """Move booted replicas from pending into the gateway (via the
        half-open probe path); abandon ones that blew the startup
        timeout."""
        cfg = self.config
        with self._lock:
            pending = list(self._pending)
        for p in pending:
            if self.supervisor._probe(p.port):
                status = self.supervisor.replica_status(p.index) or {}
                # Capacity travels with the join: the gateway's
                # weighted router and capacity gauge must see the new
                # slice's units from its first pick.
                rid = self.gateway.add_replica("127.0.0.1", p.port,
                                               rid=f"r{p.index}",
                                               version=status.get(
                                                   "version"),
                                               chips=int(
                                                   status.get("chips")
                                                   or p.chips),
                                               capacity=float(
                                                   status.get("capacity")
                                                   or p.capacity))
                with self._lock:
                    self._pending = [x for x in self._pending
                                     if x.index != p.index]
                self._note({"direction": "up", "phase": "joined",
                            "replica": rid, "port": p.port,
                            "boot_s": round(time.monotonic()
                                            - p.spawned_at, 1)})
            elif time.monotonic() - p.spawned_at > cfg.startup_timeout_s:
                with self._lock:
                    self._pending = [x for x in self._pending
                                     if x.index != p.index]
                self.supervisor.remove_replica(p.index)
                _log.error("autoscale_startup_timeout", index=p.index,
                           port=p.port, timeout_s=cfg.startup_timeout_s)
                self._note({"direction": "up", "phase": "startup_timeout",
                            "index": p.index})

    def _note(self, detail: Dict) -> None:
        rec = {"t": round(time.time(), 3), **detail}
        with self._lock:
            self._history.append(rec)
        self._recorder.record_event("autoscale", detail)
        _log.info("autoscale", **detail)

    # ── loop ──────────────────────────────────────────────────────────

    def tick(self) -> Optional[str]:
        """One control iteration; returns the actuated direction (for
        tests/benches polling the loop synchronously)."""
        # Change delivery owns the fleet while a rollout is in flight:
        # membership churn would corrupt the canary/baseline cohorts
        # and race the drain sequences, so the controller HOLDS —
        # hysteresis resets, one history note per rollout. (No scale
        # decisions mid-rollout; the rollout's own bake comparison is
        # the safety valve meanwhile.)
        rollout = getattr(self.gateway, "rollout", None)
        if rollout is not None and rollout.active():
            self._up_ticks = 0
            self._down_ticks = 0
            if not self._rollout_hold:
                self._rollout_hold = True
                self._note({"direction": "hold",
                            "reason": "rollout_active"})
            return None
        self._rollout_hold = False
        self._admit_pending()
        sig = self.read_signals()
        decision = self.decide(sig)
        if decision == "up":
            self._scale_up(sig, self.pressure(sig))
        elif decision == "down":
            self._scale_down(sig)
        return decision

    def start(self) -> threading.Event:
        if self._stop is not None:
            return self._stop
        self._stop = stop = threading.Event()

        def run() -> None:
            while not stop.wait(self.config.tick_s):
                try:
                    self.tick()
                except Exception as e:
                    # The controller must outlive a bad tick (a replica
                    # that died mid-drain, a probe socket error): log
                    # loudly, keep ticking.
                    _log.error("autoscale_tick_failed",
                               error=f"{type(e).__name__}: {e}")

        threading.Thread(target=run, daemon=True,
                         name="fleet-autoscaler").start()
        return stop

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def snapshot(self) -> dict:
        sig = self.read_signals()
        with self._lock:
            history = list(self._history)
            pending = [{"index": p.index, "port": p.port,
                        "chips": p.chips, "capacity": p.capacity,
                        "waiting_s": round(time.monotonic()
                                           - p.spawned_at, 1)}
                       for p in self._pending]
        return {
            "enabled": True,
            "config": dataclasses.asdict(self.config),
            "signals": dataclasses.asdict(sig),
            "up_ticks": self._up_ticks,
            "down_ticks": self._down_ticks,
            "pending": pending,
            "history": history,
        }


def _rid_num(rid: str) -> int:
    """``r7`` → 7 (gateway rid ↔ supervisor index; the autoscaler mints
    them in lockstep)."""
    try:
        return int(rid.lstrip("r"))
    except ValueError:
        return -1
