"""Safe change delivery: rolling restarts + SLO-gated canary rollout.

The counterpart of ``routest_tpu/serve/fleet/rollout.py``.

Bad deploys — not hardware — cause most real outages, so a fleet that
can scale itself (autoscaler) and judge itself (SLO engine) still isn't
robust until it can *change* itself safely. This module is that layer:

- :func:`replace_replica` / :func:`rolling_restart` — retire one worker
  (gateway drain first: no new picks, inflight finishes; then SIGTERM
  via the supervisor), spawn its successor with a new env overlay +
  version label, watch the boot (a climbing supervisor restart count is
  a crash loop, caught long before the startup-probe timeout), gate on
  the replica's own ``/api/health`` model check (artifact verification:
  a corrupt model serves ``degraded``, never joins), and register it
  through the gateway's half-open probe path. ``max_unavailable`` bounds
  how many replicas are out simultaneously.
- :class:`RolloutController` — the canary → bake → promote state
  machine. A rollout replaces ``canary_replicas`` workers with the new
  version, routes ``canary_fraction`` of traffic to them (an exact
  credit split in the gateway, so blast radius is bounded by
  construction), and bakes: the canary and baseline cohorts are
  compared through an :class:`~routest_tpu_torch.obs.slo.SloEngine` whose
  objectives roll up the gateway's version-labeled request families —
  windowed error rate and over-threshold latency fraction, the same
  burn-rate machinery that pages on outages. Any rollback trigger
  (boot crash loop, artifact-verification failure, canary error/latency
  regression, a fleet-wide SLO page, operator abort) restores the
  previous version, restores the fleet size, and writes a
  flight-recorder bundle naming the offending version. A clean bake
  promotes: the remaining replicas roll to the new version and the
  supervisor's defaults repoint so future autoscaler spawns come up on
  it.

The autoscaler holds while a rollout is active (``Autoscaler.tick``
checks ``gateway.rollout``): membership churn mid-rollout would corrupt
the cohorts and race the drain sequences. Knobs: ``RolloutConfig`` /
``RTPU_ROLLOUT_*``; surface: ``GET/POST /api/rollout`` on the gateway.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
import urllib.request
from typing import Deque, Dict, List, Optional, Tuple

from routest_tpu_torch.core.config import (RolloutConfig, SloConfig,
                                     load_rollout_config)
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.rollout")

IDLE = "idle"
CANARY = "canary"
BAKING = "baking"
PROMOTING = "promoting"
DONE = "done"
ROLLING_BACK = "rolling_back"
ROLLED_BACK = "rolled_back"
FAILED = "failed"

_STATE_LEVEL = {IDLE: 0, CANARY: 1, BAKING: 2, PROMOTING: 3, DONE: 4,
                ROLLING_BACK: 5, ROLLED_BACK: 6, FAILED: 7}
_ACTIVE_STATES = (CANARY, BAKING, PROMOTING, ROLLING_BACK)

# Canary-vs-baseline comparison runs four objectives with ONE shared
# target, so equal budgets make burn-rate comparisons identical to raw
# rate comparisons — the engine supplies the windowing, the controller
# supplies the judgement.
_COMPARE_TARGET = 0.95
_COMPARE_BUDGET = 1.0 - _COMPARE_TARGET

_UNVERSIONED = "unversioned"


def _rid_num(rid: str) -> int:
    """``r7`` → 7 (gateway rid ↔ supervisor index, minted in lockstep)."""
    try:
        return int(rid.lstrip("r"))
    except ValueError:
        return -1


def _get_json(port: int, path: str, timeout: float = 3.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return json.loads(resp.read())
    except Exception:  # rtpulint: disable=broad-except-unlogged -- poll helper: unreachable replicas are an expected probing outcome
        return None


def _model_health(port: int) -> Tuple[Optional[bool], dict]:
    """→ (model-ok or None when unreachable, detail). The model check is
    final by the time the replica answers HTTP (EtaService is built
    before the listener), so one successful fetch decides."""
    payload = _get_json(port, "/api/health")
    if not isinstance(payload, dict):
        return None, {}
    model = ((payload.get("checks") or {}).get("model")) or {}
    ok = model.get("status") == "ok"
    detail = {k: model.get(k) for k in ("status", "error", "generation",
                                        "fingerprint") if k in model}
    return ok, detail


def replace_replica(supervisor, gateway, rid: str, *,
                    version: Optional[str], env: Optional[Dict[str, str]],
                    drain_timeout_s: float = 15.0,
                    boot_timeout_s: float = 120.0,
                    crash_restarts: Optional[int] = 2,
                    health_gate: bool = True,
                    health_timeout_s: float = 20.0) -> dict:
    """Replace ONE replica with a successor on ``(version, env)``.

    Sequence: gateway drain (no new picks, inflight finishes) →
    supervisor retire+SIGTERM → spawn successor → boot watch (startup
    probe, with ``crash_restarts`` supervisor restarts read as a crash
    loop) → ``/api/health`` model gate → gateway half-open join.

    On ANY failure the broken successor is retired and the result says
    why — the fleet is then one replica short, which the caller
    (rollback / restore) must repair. Returns a dict with ``ok``,
    ``old`` (the victim's version/env for rollback), and the
    successor's identity on success."""
    index = _rid_num(rid)
    old = supervisor.replica_status(index) or {}
    result: dict = {"ok": False, "rid": rid,
                    "old": {"version": old.get("version"),
                            "env": old.get("env")}}
    gateway.remove_replica(rid, timeout=drain_timeout_s)
    supervisor.remove_replica(index, timeout=drain_timeout_s)
    # The successor inherits the victim's PLACEMENT verbatim (device
    # overlay, chips, capacity, slice label): a rolling restart or
    # canary changes what a replica serves, never which devices it
    # owns — otherwise every rollout would silently unpin the fleet.
    new_index, new_port = supervisor.add_replica(
        env=env, version=version,
        placement=old.get("placement_env"),
        chips=old.get("chips"), capacity=old.get("capacity"),
        label=old.get("placement_label"))
    result.update({"index": new_index, "port": new_port,
                   "version": version,
                   "chips": old.get("chips"),
                   "placement": old.get("placement_label")})
    deadline = time.monotonic() + boot_timeout_s
    booted = False
    while time.monotonic() < deadline:
        status = supervisor.replica_status(new_index)
        if status is None:
            result["reason"] = "successor retired externally"
            return result
        if crash_restarts is not None \
                and status["restarts"] >= crash_restarts:
            supervisor.remove_replica(new_index, timeout=2.0)
            result.update({"reason": "boot_crash_loop",
                           "restarts": status["restarts"],
                           "last_exit_code": status["last_exit_code"]})
            return result
        if supervisor._probe(new_port):
            booted = True
            break
        time.sleep(0.2)
    if not booted:
        supervisor.remove_replica(new_index, timeout=2.0)
        result["reason"] = "boot_timeout"
        return result
    if health_gate:
        verdict: Optional[bool] = None
        detail: dict = {}
        gate_deadline = time.monotonic() + health_timeout_s
        while time.monotonic() < gate_deadline:
            verdict, detail = _model_health(new_port)
            if verdict is not None:
                break
            time.sleep(0.2)
        if verdict is not True:
            supervisor.remove_replica(new_index, timeout=2.0)
            result.update({"reason": "verify_failed", "model": detail})
            return result
        result["model"] = detail
    status = supervisor.replica_status(new_index) or {}
    new_rid = gateway.add_replica("127.0.0.1", new_port,
                                  rid=f"r{new_index}", version=version,
                                  chips=int(status.get("chips") or 1),
                                  capacity=status.get("capacity"))
    result.update({"ok": True, "new_rid": new_rid,
                   "restarts_at_join": status.get("restarts", 0)})
    return result


def rolling_restart(supervisor, gateway, *,
                    version: Optional[str] = None,
                    env: Optional[Dict[str, str]] = None,
                    rids: Optional[List[str]] = None,
                    max_unavailable: int = 1,
                    drain_timeout_s: float = 15.0,
                    boot_timeout_s: float = 120.0,
                    crash_restarts: Optional[int] = 2,
                    health_gate: bool = True,
                    health_timeout_s: float = 20.0) -> dict:
    """Replace every replica in ``rids`` (default: the whole live
    fleet, oldest first) with successors on ``(version, env)``, at most
    ``max_unavailable`` out at a time. Stops at the first failed batch
    → ``{"ok": False, ...}`` with per-replica results; the caller
    decides whether that means rollback (the controller) or surgery
    (an operator)."""
    if rids is None:
        with gateway._lock:
            rids = sorted((r.id for r in gateway.replicas
                           if not r.draining), key=_rid_num)
    step = max(1, int(max_unavailable))
    replaced: List[dict] = []
    for i in range(0, len(rids), step):
        batch = rids[i:i + step]
        results: List[Optional[dict]] = [None] * len(batch)

        def run(slot: int, rid: str) -> None:
            results[slot] = replace_replica(
                supervisor, gateway, rid, version=version, env=env,
                drain_timeout_s=drain_timeout_s,
                boot_timeout_s=boot_timeout_s,
                crash_restarts=crash_restarts, health_gate=health_gate,
                health_timeout_s=health_timeout_s)

        if len(batch) == 1:
            run(0, batch[0])
        else:
            threads = [threading.Thread(target=run, args=(slot, rid),
                                        daemon=True)
                       for slot, rid in enumerate(batch)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        replaced.extend(r for r in results if r is not None)
        if any(not r["ok"] for r in replaced[-len(batch):]):
            return {"ok": False, "replaced": replaced}
    return {"ok": True, "replaced": replaced}


def _version_source(version_label: str, threshold_s: Optional[float] = None):
    """Cumulative ``(total, bad)`` for ONE version label over the
    gateway's version-labeled request families — exact label equality,
    not the substring match the route objectives use (``v1`` must not
    swallow ``v10``). With ``threshold_s``, bad = observations over the
    covering log bucket (latency); without, bad = the 5xx counter."""
    reg = get_registry()

    def read() -> Tuple[float, float]:
        total = under = bad = 0.0
        m = reg.get("rtpu_gateway_version_request_seconds")
        if m is not None:
            li = m.labelnames.index("version")
            for key, child in m.items():
                if key[li] != version_label:
                    continue
                total += child.count
                if threshold_s is not None:
                    cum = child.cumulative()
                    under += next((c for bound, c in cum
                                   if bound >= threshold_s), cum[-1][1])
        if threshold_s is not None:
            return total, max(0.0, total - under)
        e = reg.get("rtpu_gateway_version_request_errors_total")
        if e is not None:
            li = e.labelnames.index("version")
            for key, child in e.items():
                if key[li] == version_label:
                    bad += child.value
        return total, min(bad, total)

    return read


class RolloutController:
    """Owns one rollout at a time; attaches itself as
    ``gateway.rollout`` (the ``/api/rollout`` surface, and the flag the
    autoscaler holds on). The run executes on a daemon thread —
    ``start()`` returns immediately, ``wait()`` joins it (benches,
    tests)."""

    def __init__(self, supervisor, gateway,
                 config: Optional[RolloutConfig] = None) -> None:
        self.supervisor = supervisor
        self.gateway = gateway
        self.config = config or load_rollout_config()
        self._lock = threading.Lock()
        self._state = IDLE
        self._abort = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._history: Deque[dict] = collections.deque(maxlen=64)
        self._version: Optional[str] = None
        self._env: Optional[Dict[str, str]] = None
        self._baseline: Dict = {"version": None, "env": None}
        self._canaries: List[dict] = []   # join results for the cohort
        self._fleet_size0 = 0
        self._started_unix: Optional[float] = None
        self._last_verdict: Optional[dict] = None
        self._last_bundle: Optional[str] = None
        reg = get_registry()
        self._m_state = reg.gauge(
            "rtpu_rollout_state",
            "Rollout state machine position (0 idle … 4 done, "
            "5 rolling_back, 6 rolled_back, 7 failed).")
        self._m_state.set(0)
        self._m_rollbacks = reg.counter(
            "rtpu_rollout_rollbacks_total",
            "Automatic rollbacks, by trigger.", ("trigger",))
        self._m_promotions = reg.counter(
            "rtpu_rollout_promotions_total",
            "Rollouts promoted to the full fleet.")
        from routest_tpu_torch.obs.recorder import get_recorder

        self._recorder = get_recorder()
        gateway.rollout = self

    # ── introspection ─────────────────────────────────────────────────

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def active(self) -> bool:
        with self._lock:
            return self._state in _ACTIVE_STATES

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "state": self._state,
                "active": self._state in _ACTIVE_STATES,
                "version": self._version,
                "baseline": {"version": self._baseline.get("version")},
                "canary": {
                    "rids": [c.get("new_rid") for c in self._canaries
                             if c.get("new_rid")],
                    "fraction": self.config.canary_fraction,
                },
                "started_unix": self._started_unix,
                "last_verdict": self._last_verdict,
                "last_bundle": self._last_bundle,
                "config": dataclasses.asdict(self.config),
                "history": list(self._history),
            }

    def _set_state(self, state: str) -> None:
        with self._lock:
            previous, self._state = self._state, state
        self._m_state.set(_STATE_LEVEL[state])
        record_change("rollout.phase", version=self._version,
                      detail={"from": previous, "to": state})
        self._note({"event": "state", "from": previous, "to": state})

    def _note(self, detail: Dict) -> None:
        rec = {"t": round(time.time(), 3), "version": self._version,
               **detail}
        with self._lock:
            self._history.append(rec)
        self._recorder.record_event("rollout", rec)
        _log.info(f"rollout_{detail.get('event', 'note')}",
                  **{k: v for k, v in detail.items() if k != "event"})

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self, version: str, env: Optional[Dict[str, str]] = None
              ) -> bool:
        """Begin a rollout to ``version`` (worker env overlaid with
        ``env``). Returns False when one is already in flight."""
        with self._lock:
            if self._state in _ACTIVE_STATES:
                return False
            self._state = CANARY
            self._version = version
            self._env = dict(env) if env else None
            self._canaries = []
            self._baseline = {"version": None, "env": None}
            self._started_unix = round(time.time(), 3)
            self._last_verdict = None
            self._last_bundle = None
            self._abort.clear()
        self._m_state.set(_STATE_LEVEL[CANARY])
        self._note({"event": "started", "env_keys": sorted(env or ())})
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-rollout")
        self._thread.start()
        return True

    def abort(self, reason: str = "operator") -> bool:
        """Request a rollback of the in-flight rollout (picked up
        between steps / bake ticks). Returns False when idle."""
        if not self.active():
            return False
        self._note({"event": "abort_requested", "reason": reason})
        self._abort.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> str:
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
        return self.state

    # ── the run ───────────────────────────────────────────────────────

    def _run(self) -> None:
        try:
            if self._canary_phase() and self._bake_phase():
                self._promote_phase()
        except Exception as e:  # a broken step must still roll back
            _log.error("rollout_run_failed",
                       error=f"{type(e).__name__}: {e}")
            self._rollback("internal_error",
                           {"error": f"{type(e).__name__}: {e}"})

    def _live_rids(self) -> List[str]:
        with self.gateway._lock:
            return sorted((r.id for r in self.gateway.replicas
                           if not r.draining), key=_rid_num)

    def _canary_phase(self) -> bool:
        cfg = self.config
        live = self._live_rids()
        self._fleet_size0 = len(live)
        if not live:
            self._note({"event": "no_live_replicas"})
            self._set_state(FAILED)
            return False
        # Newest replicas first: r0's identity (and its warm history)
        # stays stable, same convention as scale-down.
        victims = sorted(live, key=_rid_num,
                         reverse=True)[:max(1, cfg.canary_replicas)]
        for rid in victims:
            if self._abort.is_set():
                self._rollback("aborted", {})
                return False
            result = replace_replica(
                self.supervisor, self.gateway, rid,
                version=self._version, env=self._env,
                drain_timeout_s=cfg.drain_timeout_s,
                boot_timeout_s=cfg.boot_timeout_s,
                crash_restarts=cfg.crash_restarts,
                health_gate=True, health_timeout_s=cfg.health_timeout_s)
            if self._baseline["version"] is None \
                    and self._baseline["env"] is None:
                self._baseline = dict(result["old"])
            self._note({"event": "canary_replace", **{
                k: result.get(k) for k in ("rid", "new_rid", "ok",
                                           "reason", "model", "port")}})
            if not result["ok"]:
                self._rollback(result.get("reason", "canary_boot_failed"),
                               {k: v for k, v in result.items()
                                if k not in ("ok", "old")})
                return False
            self._canaries.append(result)
        return True

    def _bake_phase(self) -> bool:
        from routest_tpu_torch.obs.slo import PAGE, SloEngine, SloObjective

        cfg = self.config
        canary_rids = [c["new_rid"] for c in self._canaries]
        self.gateway.set_canary(canary_rids, cfg.canary_fraction)
        self._set_state(BAKING)
        canary_label = self._version or _UNVERSIONED
        baseline_label = self._baseline.get("version") or _UNVERSIONED
        threshold_s = cfg.latency_threshold_ms / 1000.0
        window = max(5.0, cfg.bake_s + cfg.tick_s)
        engine = SloEngine(SloConfig(
            enabled=True, tick_s=cfg.tick_s, fast_window_s=window,
            slow_window_s=2 * window), component="rollout")
        sources = {}
        for name, label, thr in (
                ("availability:canary", canary_label, None),
                ("availability:baseline", baseline_label, None),
                ("latency:canary", canary_label, threshold_s),
                ("latency:baseline", baseline_label, threshold_s)):
            source = _version_source(label, thr)
            sources[name] = source
            engine.add_objective(SloObjective(
                name, "latency" if thr else "availability",
                _COMPARE_TARGET, source, detail={"version": label}))
        start_canary_total = sources["availability:canary"]()[0]
        deadline = time.monotonic() + cfg.bake_s
        while time.monotonic() < deadline:
            if self._abort.is_set():
                self._rollback("aborted", {})
                return False
            engine.tick()
            snap = engine.snapshot()["objectives"]
            canary_n = snap["availability:canary"]["total"] \
                - start_canary_total
            verdict = self._judge(snap, canary_n)
            if verdict is not None:
                self._last_verdict = verdict
                self._rollback(verdict["trigger"], verdict)
                return False
            # Fleet-wide page during the bake: whatever the cohort math
            # says, a paging fleet is not the moment to keep rolling.
            if self.gateway.slo is not None \
                    and self.gateway.slo.worst_state() == PAGE:
                self._rollback("slo_page", {"canary_requests": canary_n})
                return False
            # A canary that crashes AFTER joining (supervisor restarts
            # climbing) is a bad deploy even if its error rate hasn't
            # caught up yet.
            for c in self._canaries:
                status = self.supervisor.replica_status(c["index"])
                if status is None or status["restarts"] \
                        > c.get("restarts_at_join", 0):
                    self._rollback("canary_crash", {
                        "replica": c.get("new_rid"),
                        "restarts": None if status is None
                        else status["restarts"]})
                    return False
            time.sleep(cfg.tick_s)
        snap = engine.snapshot()["objectives"]
        canary_n = snap["availability:canary"]["total"] - start_canary_total
        self._last_verdict = {
            "trigger": None,
            "canary_requests": canary_n,
            "canary_error_rate": round(
                snap["availability:canary"]["burn_fast"]
                * _COMPARE_BUDGET, 4),
            "baseline_error_rate": round(
                snap["availability:baseline"]["burn_fast"]
                * _COMPARE_BUDGET, 4),
        }
        self._note({"event": "bake_passed", **self._last_verdict})
        return True

    def _judge(self, snap: dict, canary_n: float) -> Optional[dict]:
        """Canary-vs-baseline verdict from the engine's fast-window
        burns (equal budgets → burn comparisons are rate comparisons).
        None until the canary has served ``min_canary_requests``."""
        cfg = self.config
        if canary_n < cfg.min_canary_requests:
            return None
        c_err = snap["availability:canary"]["burn_fast"] * _COMPARE_BUDGET
        b_err = snap["availability:baseline"]["burn_fast"] * _COMPARE_BUDGET
        if c_err > max(cfg.max_error_rate, cfg.max_error_ratio * b_err):
            return {"trigger": "canary_error_rate",
                    "canary_error_rate": round(c_err, 4),
                    "baseline_error_rate": round(b_err, 4),
                    "canary_requests": int(canary_n)}
        c_slow = snap["latency:canary"]["burn_fast"] * _COMPARE_BUDGET
        b_slow = snap["latency:baseline"]["burn_fast"] * _COMPARE_BUDGET
        if c_slow > b_slow + cfg.max_latency_regression:
            return {"trigger": "canary_latency",
                    "canary_slow_frac": round(c_slow, 4),
                    "baseline_slow_frac": round(b_slow, 4),
                    "threshold_ms": cfg.latency_threshold_ms,
                    "canary_requests": int(canary_n)}
        return None

    def _promote_phase(self) -> bool:
        cfg = self.config
        # The new version is trusted now: stop splitting traffic and
        # roll the remainder of the fleet onto it.
        self.gateway.clear_canary()
        self._set_state(PROMOTING)
        with self.gateway._lock:
            remaining = sorted(
                (r.id for r in self.gateway.replicas
                 if not r.draining and r.version != self._version),
                key=_rid_num)
        if remaining:
            if self._abort.is_set():
                self._rollback("aborted", {})
                return False
            result = rolling_restart(
                self.supervisor, self.gateway, version=self._version,
                env=self._env, rids=remaining,
                max_unavailable=cfg.max_unavailable,
                drain_timeout_s=cfg.drain_timeout_s,
                boot_timeout_s=cfg.boot_timeout_s,
                crash_restarts=cfg.crash_restarts,
                health_gate=True, health_timeout_s=cfg.health_timeout_s)
            self._note({"event": "promote_restart", "ok": result["ok"],
                        "replaced": len(result["replaced"])})
            if not result["ok"]:
                bad = next((r for r in result["replaced"]
                            if not r["ok"]), {})
                self._rollback(bad.get("reason", "promote_failed"),
                               {k: v for k, v in bad.items()
                                if k not in ("ok", "old")})
                return False
        # Future spawns (autoscaler growth, monitor policy) come up on
        # the promoted version from here on.
        self.supervisor.set_default(env=self._env, version=self._version)
        self._m_promotions.inc()
        self._set_state(DONE)
        self._note({"event": "promoted",
                    "replicas": len(self._live_rids())})
        return True

    # ── rollback ──────────────────────────────────────────────────────

    def _rollback(self, trigger: str, detail: dict) -> None:
        cfg = self.config
        self._set_state(ROLLING_BACK)
        self.gateway.clear_canary()
        self._m_rollbacks.labels(trigger=trigger).inc()
        record = {"event": "rollback", "trigger": trigger,
                  "offending_version": self._version, **detail}
        self._note(record)
        # The postmortem FIRST, while the rings still hold the canary's
        # requests: the bundle names the offending version and why.
        self._last_bundle = self._recorder.trigger(
            "rollout_rollback", record, force=True)
        base_version = self._baseline.get("version")
        base_env = self._baseline.get("env")
        failed = False
        # Replace every live replica still on the offending version.
        with self.gateway._lock:
            tainted = sorted((r.id for r in self.gateway.replicas
                              if not r.draining
                              and r.version == self._version),
                             key=_rid_num)
        for rid in tainted:
            result = replace_replica(
                self.supervisor, self.gateway, rid, version=base_version,
                env=base_env, drain_timeout_s=cfg.drain_timeout_s,
                boot_timeout_s=cfg.boot_timeout_s, crash_restarts=None,
                health_gate=False)
            self._note({"event": "rollback_replace", **{
                k: result.get(k) for k in ("rid", "new_rid", "ok",
                                           "reason")}})
            failed = failed or not result["ok"]
        # Restore fleet size (a canary that never booted left a hole).
        guard = 0
        while not failed and len(self._live_rids()) < self._fleet_size0 \
                and guard < self._fleet_size0:
            guard += 1
            index, port = self.supervisor.add_replica(env=base_env,
                                                      version=base_version)
            if not self.supervisor.wait_port_ready(
                    port, timeout=cfg.boot_timeout_s):
                self.supervisor.remove_replica(index, timeout=2.0)
                self._note({"event": "rollback_respawn_failed",
                            "index": index})
                failed = True
                break
            status = self.supervisor.replica_status(index) or {}
            rid = self.gateway.add_replica(
                "127.0.0.1", port, rid=f"r{index}", version=base_version,
                chips=int(status.get("chips") or 1),
                capacity=status.get("capacity"))
            self._note({"event": "rollback_respawn", "replica": rid,
                        "port": port})
        if failed:
            # Loud terminal state: the fleet needs an operator. The
            # gateway keeps serving whatever replicas remain.
            _log.error("rollout_rollback_failed", version=self._version,
                       trigger=trigger)
            self._set_state(FAILED)
        else:
            self._set_state(ROLLED_BACK)
            self._note({"event": "rolled_back",
                        "restored_version": base_version,
                        "replicas": len(self._live_rids())})
