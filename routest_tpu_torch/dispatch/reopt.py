"""Live re-optimization: re-solve degraded dispatches on metric flips.

The counterpart of ``routest_tpu/dispatch/reopt.py``. Active dispatches
(``dispatch/registry.py``) carry their corridor — the stop coordinates
their plan was priced over — and the plan's cost under the metric it
was confirmed on (``baseline_cost``). When the live metric epoch flips
(``routest_tpu_torch/live/``), every geographic dispatch's corridor is
re-priced under the NEW metric (``matrix_fn``; the serving wiring
prices over the live road router, the same pricer serving requests).
Plans whose current cost degraded past ``RTPU_DISPATCH_DEGRADE_RATIO``
× baseline are re-solved in ONE batched pass through the dispatch
batcher, and each updated plan is pushed over the dispatch's SSE channel
(``serve/bus.py``) as a ``plan_update`` event; the driver sim restarts
against the new stop order under the dispatch's stored ``sim_seed``, so
the replay is deterministic.

Coherency rules:

- one epoch, one pass: a tick prices every active dispatch against the
  same metric generation (the flip is atomic on the router; a tick that
  straddles a flip reprices next tick — epochs only move forward);
- exactly the degraded re-solve: plans whose corridor cost stayed
  within the ratio keep serving untouched (no churn on healthy plans);
- chaos point ``dispatch.resolve`` guards the re-solve pass: a dropped
  pass leaves every previous plan serving and the epoch unconsumed —
  healthy records included — and the next tick retries, as the live
  customizer's flip does. Each pass is one ``dispatch_reopt`` record in
  the goodput ledger.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from routest_tpu_torch import chaos
from routest_tpu_torch.dispatch.batcher import (DispatchBatcher,
                                                DispatchProblem)
from routest_tpu_torch.dispatch.registry import (ActiveDispatch,
                                                 DispatchRegistry)
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.efficiency import get_ledger
from routest_tpu_torch.optimize.vrp import trips_cost
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.dispatch.reopt")

_m_reopt = get_registry().counter(
    "rtpu_dispatch_reopt_total",
    "Re-optimization passes, by result (clean / resolved / chaos / "
    "error).", ("result",))
_m_updates = get_registry().counter(
    "rtpu_dispatch_plan_updates_total",
    "plan_update events pushed to dispatch SSE channels.")


def plan_cost(matrix, plan: dict) -> float:
    """Cost of an existing plan under a (possibly new) matrix: the real
    trips plus the penalty lane as one more trip — the spill lane is
    driven too, so a jam on it degrades the plan the same way."""
    trips = list(plan.get("trips") or [])
    lane = plan.get("spill_lane") or []
    if lane:
        trips.append(list(lane))
    return trips_cost(matrix, trips)


class ReoptLoop:
    """Epoch-watcher + batched re-solver over the active registry.

    ``epoch_fn`` → current live metric epoch (0 when live is off);
    ``matrix_fn(latlon)`` → (N+1, N+1) cost matrix under the CURRENT
    metric; ``publish(channel, event)`` → SSE fan-out;
    ``sim_restart(rec)`` (optional) restarts the driver sim against the
    updated plan — injected by the serving wiring so tests can fake it.
    """

    def __init__(self, registry: DispatchRegistry,
                 batcher: DispatchBatcher, publish,
                 epoch_fn: Callable[[], int],
                 matrix_fn: Callable, *,
                 degrade_ratio: float = 1.2,
                 poll_s: float = 1.0,
                 sim_restart: Optional[Callable] = None) -> None:
        self.registry = registry
        self.batcher = batcher
        self.publish = publish
        self.epoch_fn = epoch_fn
        self.matrix_fn = matrix_fn
        self.degrade_ratio = float(degrade_ratio)
        self.poll_s = float(poll_s)
        self.sim_restart = sim_restart
        self._last_epoch: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._ticks = 0
        self._resolves = 0
        self._last_result: dict = {}

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dispatch-reopt")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception as e:  # loop must survive anything
                _m_reopt.labels(result="error").inc()
                _log.error("reopt_tick_failed",
                           error=f"{type(e).__name__}: {e}")

    # ── one pass ──────────────────────────────────────────────────────

    def tick(self, force: bool = False) -> dict:
        """One re-optimization pass; exposed so tests and the smoke run
        can drive flips synchronously. Returns what happened."""
        epoch = int(self.epoch_fn())
        if self._last_epoch is None:
            # First observation arms the watermark; nothing was
            # confirmed under an older metric than "now".
            self._last_epoch = epoch
            if not force:
                return {"result": "armed", "epoch": epoch}
        if epoch == self._last_epoch and not force:
            return {"result": "idle", "epoch": epoch}

        active = self.registry.active()
        degraded: List[ActiveDispatch] = []
        healthy: List[ActiveDispatch] = []
        matrices = {}
        skipped = 0
        for rec in active:
            if rec.latlon is None:
                skipped += 1      # matrix-mode: no geography to re-price
                continue
            matrix = self.matrix_fn(rec.latlon)
            matrices[rec.id] = matrix
            current = plan_cost(matrix, rec.plan)
            ratio = current / max(rec.baseline_cost, 1e-9)
            if ratio > self.degrade_ratio:
                degraded.append(rec)
            else:
                healthy.append(rec)

        out = {"epoch": epoch, "checked": len(active),
               "skipped": skipped,
               "degraded": [r.id for r in degraded], "resolved": []}
        if not degraded:
            for rec in healthy:
                rec.epoch = epoch   # healthy under the new metric
            self._last_epoch = epoch
            with self._lock:
                self._ticks += 1
                self._last_result = dict(out, result="clean")
            _m_reopt.labels(result="clean").inc()
            return dict(out, result="clean")

        try:
            # The whole re-solve pass is one fault point: a dropped pass
            # leaves every previous plan serving (the epoch stays
            # unconsumed → retried next tick). Chunked to the batcher's
            # drain size: a mass degradation (max_active can exceed
            # max_rows) must not submit one oversized entry.
            chaos.inject("dispatch.resolve")
            results: List[dict] = []
            t_pass = time.perf_counter()
            step = max(1, self.batcher.max_rows)
            for i in range(0, len(degraded), step):
                results.extend(self.batcher.solve([
                    DispatchProblem(matrices[r.id], r.demands,
                                    r.capacity, r.max_cost,
                                    r.tw_open, r.tw_close)
                    for r in degraded[i:i + step]]))
            # The ledger sees the pass as its own program: every row is
            # real (the batcher's dispatch_solve records account the
            # padding underneath).
            get_ledger().record(
                "dispatch_reopt", real_rows=len(degraded),
                padded_rows=len(degraded),
                compute_s=time.perf_counter() - t_pass)
        except chaos.ChaosError:
            _m_reopt.labels(result="chaos").inc()
            with self._lock:
                self._ticks += 1
                self._last_result = dict(out, result="chaos")
            return dict(out, result="chaos")

        for rec in healthy:
            rec.epoch = epoch       # healthy under the new metric
        for rec, plan in zip(degraded, results):
            matrix = matrices[rec.id]
            old_cost = plan_cost(matrix, rec.plan)
            rec.plan = plan
            rec.baseline_cost = plan_cost(matrix, plan)
            rec.epoch = epoch
            rec.updates += 1
            event = {
                "event": "plan_update",
                "dispatch_id": rec.id,
                "epoch": epoch,
                "plan": plan,
                "reason": {
                    "previous_cost": round(old_cost, 3),
                    "new_cost": round(rec.baseline_cost, 3),
                    "degrade_ratio": self.degrade_ratio,
                },
            }
            try:
                self.publish(rec.channel, event)
                _m_updates.inc()
            except Exception as e:  # bus hiccup: plan still updated
                _log.error("plan_update_publish_failed",
                           dispatch_id=rec.id,
                           error=f"{type(e).__name__}: {e}")
            if self.sim_restart is not None:
                try:
                    self.sim_restart(rec)
                except Exception as e:
                    _log.error("sim_restart_failed", dispatch_id=rec.id,
                               error=f"{type(e).__name__}: {e}")
            out["resolved"].append(rec.id)

        self._last_epoch = epoch
        with self._lock:
            self._ticks += 1
            self._resolves += len(out["resolved"])
            self._last_result = dict(out, result="resolved")
        _m_reopt.labels(result="resolved").inc()
        return dict(out, result="resolved")

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "running": self._thread is not None,
                "poll_s": self.poll_s,
                "degrade_ratio": self.degrade_ratio,
                "last_epoch": self._last_epoch,
                "ticks": self._ticks,
                "resolves": self._resolves,
                "last": dict(self._last_result),
            }
