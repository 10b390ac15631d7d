"""Cross-request dispatch coalescing: one padded device batch per drain.

The counterpart of ``routest_tpu/dispatch/batcher.py``: concurrent
``POST /api/dispatch`` callers — each one VRP problem — merge into ONE
call of the batched dispatch solver (``optimize/vrp.py::
solve_host_dispatch_batch``) on the batcher's device. The solver's batch
axis is batch-of-problems by design, so merged results are exactly what
lone solves return; the merge only amortizes launches and copies.

Zero added latency by construction with the default 0 ms window: a lone
request dispatches immediately; arrivals during an in-flight solve
queue and drain as the NEXT merged batch (natural batching — occupancy
grows exactly when the device is the bottleneck). ``window_s > 0`` adds
a fixed pre-drain wait for forced batch shapes.

Problems priced under different live-metric epochs never share a drain
(their cost matrices disagree about the world); the leader drains one
epoch group per round, in arrival order.

Chaos point ``dispatch.solve``: the silently-wrong-plan fault. A
``skew`` injection perturbs every merged cost matrix before the solve,
so the replica keeps answering well-formed 200 plans — confidently, and
wrong. Each drain is one ``dispatch_solve`` record in the goodput
ledger, and each caller's solve one ``dispatch.batch_solve`` span.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from routest_tpu_torch import chaos
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.efficiency import get_ledger
from routest_tpu_torch.obs.trace import trace_span
from routest_tpu_torch.optimize.vrp import solve_host_dispatch_batch

_m_dispatches = get_registry().counter(
    "rtpu_dispatch_batch_dispatches_total",
    "Merged dispatch-solve drains executed.")
_m_rows = get_registry().counter(
    "rtpu_dispatch_batch_rows_total",
    "VRP problems solved through merged dispatch drains.")
_m_merged = get_registry().counter(
    "rtpu_dispatch_batch_merged_total",
    "Dispatch requests that shared a drain with at least one other.")
_m_solve = get_registry().histogram(
    "rtpu_dispatch_solve_seconds",
    "One merged dispatch drain: pad + batched VRP solve + unpack.")


class DispatchProblem:
    """One VRP problem as the batcher consumes it: a cost matrix (row/col
    0 = depot) plus constraints. ``tw_open``/``tw_close`` may be None
    (no windows — spillover-only semantics)."""

    __slots__ = ("dist", "demands", "capacity", "max_cost",
                 "tw_open", "tw_close")

    def __init__(self, dist: np.ndarray, demands: np.ndarray,
                 capacity: float, max_cost: float,
                 tw_open: Optional[np.ndarray] = None,
                 tw_close: Optional[np.ndarray] = None) -> None:
        self.dist = np.asarray(dist, np.float32)
        self.demands = np.asarray(demands, np.float32)
        self.capacity = float(capacity)
        self.max_cost = float(max_cost)
        self.tw_open = None if tw_open is None \
            else np.asarray(tw_open, np.float32)
        self.tw_close = None if tw_close is None \
            else np.asarray(tw_close, np.float32)


class _Entry:
    __slots__ = ("problems", "key", "event", "results", "error",
                 "dispatch_rows", "dispatch_requests", "t_q")

    def __init__(self, problems: Sequence[DispatchProblem], key) -> None:
        self.problems = list(problems)
        self.key = key
        self.event = threading.Event()
        self.results: Optional[List[dict]] = None
        self.error: Optional[BaseException] = None
        self.dispatch_rows = 0
        self.dispatch_requests = 0
        # Enqueue stamp for the goodput ledger's queue/compute split.
        self.t_q = time.monotonic()


class DispatchBatcher:
    """Leader/follower merge queue over the batched dispatch solver on
    ``device`` (None: the configured serving device, ``cuda`` by
    default; asking for the card where there is none raises at the
    first solve)."""

    def __init__(self, max_rows: int = 64, window_s: float = 0.0,
                 epoch_fn=None, device=None) -> None:
        self.max_rows = int(max_rows)
        self.window_s = float(window_s)
        self.device = device
        # Epoch provider: problems priced under different live-metric
        # generations must not share a drain. None → everything merges.
        self._epoch_fn = epoch_fn
        self._lock = threading.Lock()
        self._queue: List[_Entry] = []
        self._busy = False
        self._dispatches = 0
        self._rows = 0
        self._requests = 0
        self._merged_requests = 0
        self._max_occupancy = 0
        self._oversized = 0

    def stats(self) -> Dict:
        with self._lock:
            d = max(1, self._dispatches)
            return {"max_rows": self.max_rows,
                    "window_ms": round(self.window_s * 1000, 3),
                    "dispatches": self._dispatches,
                    "rows": self._rows,
                    "requests": self._requests,
                    "merged_requests": self._merged_requests,
                    "max_occupancy": self._max_occupancy,
                    # entries waiting behind the in-flight solve, and how
                    # often an oversized head entry rode a drain alone
                    # past max_rows
                    "queue_depth": len(self._queue),
                    "oversized_batches": self._oversized,
                    "mean_rows_per_dispatch": round(self._rows / d, 3)}

    def solve(self, problems: Sequence[DispatchProblem]) -> List[dict]:
        """One caller's problems through the merge queue → one plan per
        problem, in order, traced with how many rows and requests rode
        the drain that carried it."""
        with trace_span("dispatch.batch_solve",
                        rows=len(problems)) as span:
            entry = self._solve_entry(problems)
            span.set_attr("dispatch_rows", entry.dispatch_rows)
            span.set_attr("merged_requests", entry.dispatch_requests)
            return entry.results

    def _solve_entry(self, problems: Sequence[DispatchProblem]) -> _Entry:
        key = self._epoch_fn() if self._epoch_fn is not None else 0
        entry = _Entry(problems, key)
        with self._lock:
            self._queue.append(entry)
            self._requests += 1
            leader = not self._busy
            if leader:
                self._busy = True
        if not leader:
            if not entry.event.wait(120.0):
                raise TimeoutError("dispatch batcher wedged")
            if entry.error is not None:
                raise entry.error
            return entry
        drain_error: Optional[BaseException] = None
        try:
            if self.window_s > 0:
                time.sleep(self.window_s)
            while True:
                with self._lock:
                    if not self._queue:
                        # Clearing the flag and observing the empty
                        # queue must be one atomic step (an arrival in
                        # between would wait on a departed leader).
                        self._busy = False
                        break
                    k0 = self._queue[0].key
                    batch: List[_Entry] = []
                    rest: List[_Entry] = []
                    rows = 0
                    for it in self._queue:
                        if it.key != k0:
                            rest.append(it)
                        elif (not batch
                                or rows + len(it.problems)
                                <= self.max_rows):
                            # The head entry rides even when it alone
                            # exceeds max_rows (the solver pads to any
                            # batch size): refusing it would requeue it
                            # every round while its caller hangs.
                            batch.append(it)
                            rows += len(it.problems)
                        else:
                            rest.append(it)
                    self._queue = rest
                    self._dispatches += 1
                    self._rows += rows
                    self._max_occupancy = max(self._max_occupancy, rows)
                    if len(batch) > 1:
                        self._merged_requests += len(batch)
                _m_dispatches.inc()
                _m_rows.inc(rows)
                if len(batch) > 1:
                    _m_merged.inc(len(batch))
                self._dispatch(batch)
        except BaseException as e:  # drain-loop bug: fail loudly
            drain_error = e
            raise
        finally:
            if drain_error:
                with self._lock:
                    leftovers = list(self._queue)
                    self._queue = []
                    self._busy = False
            else:
                leftovers = []
            for it in leftovers:
                if not it.event.is_set():
                    it.error = drain_error
                    it.event.set()
        if entry.error is not None:
            raise entry.error
        return entry

    def _dispatch(self, batch: List[_Entry]) -> None:
        merged: List[DispatchProblem] = []
        for it in batch:
            merged.extend(it.problems)
        oversized = len(merged) > self.max_rows
        if oversized:
            with self._lock:
                self._oversized += 1
        queue_s = max(0.0, time.monotonic() - min(it.t_q for it in batch))
        t0 = time.perf_counter()
        try:
            dists = [p.dist for p in merged]
            # Chaos 'dispatch.solve' skew: perturb the cost matrices the
            # device solves over — the plan comes back well-formed and
            # wrong. The magnitude is a PERCENT relative perturbation
            # (``dispatch.solve:skew=1.0/40`` ≙ up to 40% per-leg cost
            # error) with a deterministic per-magnitude pattern.
            skew = chaos.inject("dispatch.solve")
            if skew:
                rel = abs(skew) / 100.0
                rng = np.random.default_rng(
                    int(abs(skew) * 1e3) & 0x7FFFFFFF)
                dists = [
                    d * (1.0 + rel
                         * rng.random(d.shape).astype(np.float32))
                    for d in dists]
            results = solve_host_dispatch_batch(
                dists,
                [p.demands for p in merged],
                [p.capacity for p in merged],
                [p.max_cost for p in merged],
                tw_opens=[p.tw_open for p in merged],
                tw_closes=[p.tw_close for p in merged],
                device=self.device)
        except BaseException as e:  # propagate to every merged caller
            for it in batch:
                it.error = e
                it.event.set()
            return
        compute_s = time.perf_counter() - t0
        _m_solve.observe(compute_s)
        # Goodput ledger: the solver pads the problem axis to the next
        # power of two — that is the launched batch this drain counts.
        n = len(merged)
        b_pad = 1 << max(0, n - 1).bit_length()
        get_ledger().record(
            "dispatch_solve", real_rows=n, padded_rows=b_pad,
            bucket=b_pad, queue_s=queue_s, compute_s=compute_s,
            oversized=oversized)
        pos = 0
        for it in batch:
            m = len(it.problems)
            it.results = results[pos:pos + m]
            it.dispatch_rows = len(merged)
            it.dispatch_requests = len(batch)
            pos += m
            it.event.set()
