"""ETA inference service: request-coalescing dynamic batcher → one kernel.

The counterpart of ``routest_tpu/serve/ml_service.py``. Concurrent
requests coalesce into one device batch, padded to a small set of bucket
sizes. On the card every batch is scored by the hand-written fused
kernel (``ops/fused_mlp.py``): the weights are packed once and stay on
the device, each flush copies its bucket slab host→device, launches the
kernel and copies the result back. There is no selection record and no
fallback: a kernel that does not build or launch fails the self-check
and health reports the model degraded. On an explicit CPU run
(``device="cpu"``) the same wrapper runs the kernel's plain PyTorch
version.

Failure semantics mirror the reference: a missing/broken model artifact
makes ``predict`` return ``(None, None)`` and the caller degrades
gracefully (``/predict_eta`` surfaces 503).

A changed artifact file hot-swaps in without a restart
(``reload_if_changed``, polled by ``start_reload_watcher`` when
``ROUTEST_RELOAD_SEC`` > 0): the replacement service is built, self-
checked and warmed off to the side, scores the golden batch on its own
batcher (the verified-swap gate), and only then does the single
``_serving`` reference flip. ``predict_eta_wire`` is the binary wire
path's entry: pre-encoded rows in, minutes and epoch-ms completion
stamps out, bitwise the JSON path's.
"""

from __future__ import annotations

import datetime as dt
import hashlib
import itertools
import math
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from routest_tpu_torch.chaos import ChaosError
from routest_tpu_torch.chaos import inject as chaos_inject
from routest_tpu_torch.core.config import ServeConfig, resolve_device
from routest_tpu_torch.core.dtypes import backend_compute_policy
from routest_tpu_torch.data.features import encode_requests
from routest_tpu_torch.live import metric_epoch
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.efficiency import get_ledger
from routest_tpu_torch.obs.export import maybe_device_trace
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.obs.trace import trace_span
from routest_tpu_torch.ops.fused_mlp import (fused_eta_forward,
                                             pack_eta_params,
                                             resolve_kernel_dtype)
from routest_tpu_torch.serve.deadline import DeadlineExceeded
from routest_tpu_torch.train.checkpoint import (JAX_EXPORT_MAGIC,
                                                TORCH_EXPORT_MAGIC,
                                                default_model_path,
                                                load_exported_serving_fn,
                                                load_model)
from routest_tpu_torch.utils.logging import get_logger


class _ServingState:
    """One immutable bundle of everything a prediction needs — model,
    batcher, quantile levels. Readers snapshot ``self._serving`` ONCE
    per request and use only the snapshot, so a later swap of the
    single attribute can never hand a request one state's batcher with
    another's quantile metadata.

    ``generation`` is a process-unique id for this serving state; the
    fast-lane prediction cache keys on it."""

    __slots__ = ("model", "batcher", "quantiles", "generation")

    def __init__(self, model, batcher, quantiles,
                 generation: int = -1) -> None:
        self.model = model
        self.batcher = batcher
        self.quantiles = tuple(quantiles or ())
        self.generation = generation


_EMPTY_SERVING = _ServingState(None, None, ())

# Model-generation counter: every serving state that goes live in the
# process draws a fresh id.
_GENERATION = itertools.count()

# Every verified-swap verdict counts here; the gauge below tracks the
# LIVE generation.
_m_swaps = get_registry().counter(
    "rtpu_model_swaps_total",
    "Model hot-swap attempts, by result (accepted / rejected).",
    ("result",))
_m_generation = get_registry().gauge(
    "rtpu_model_generation",
    "Generation id of the live serving model (monotonic per process).")
_m_cold_start = get_registry().gauge(
    "rtpu_replica_cold_start_seconds",
    "Service-construction-to-ready wall time of the live serving state "
    "(model load + pack + self-check + warmup).")


def _artifact_fingerprint(path: str) -> Optional[str]:
    """Content fingerprint of the serving artifact (sha256, short)."""
    try:
        digest = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        return digest.hexdigest()[:16]
    except OSError:
        return None


def pad_rows(array: np.ndarray, target_rows: int) -> np.ndarray:
    """Zero-pad axis 0 up to target_rows (the batch's bucket)."""
    n = array.shape[0]
    if n == target_rows:
        return array
    if n > target_rows:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    pad_widths = [(0, target_rows - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_widths)


_GOLDEN_BATCH: Optional[np.ndarray] = None


def golden_batch() -> np.ndarray:
    """Deterministic verification rows spanning the feature domain: every
    (weather × traffic) category pair twice, with weekday/hour/distance/
    driver-age swept across their ranges. Encoded once per process."""
    global _GOLDEN_BATCH
    if _GOLDEN_BATCH is None:
        from routest_tpu_torch.data.features import (TRAFFIC_CATEGORIES,
                                                     WEATHER_CATEGORIES)

        combos = [(w, t) for w in WEATHER_CATEGORIES
                  for t in TRAFFIC_CATEGORIES]
        n = 2 * len(combos)
        _GOLDEN_BATCH = encode_requests(
            weather=[w for w, _ in combos] * 2,
            traffic=[t for _, t in combos] * 2,
            weekday=[i % 7 for i in range(n)],
            hour=[(7 * i) % 24 for i in range(n)],
            distance_km=[0.5 + (i % 12) * 2.5 for i in range(n)],
            driver_age=[20.0 + (i % 8) * 5.0 for i in range(n)],
        )
    return _GOLDEN_BATCH


def _parse_pickup_single(pickup_time) -> dt.datetime:
    """Single-row pickup parsing (reference semantics, ``Flaskr/ml.py``):
    ISO string → datetime (offset preserved), datetime passes through,
    anything else → now."""
    if isinstance(pickup_time, str):
        try:
            return dt.datetime.fromisoformat(pickup_time)
        except ValueError:
            return dt.datetime.now()
    if isinstance(pickup_time, dt.datetime):
        return pickup_time
    return dt.datetime.now()


def _band_label(level: float) -> str:
    """Quantile level → response-field suffix: 0.1 → "p10", 0.975 →
    "p97.5"."""
    return f"p{level * 100:.10g}"


class _InReload(threading.local):
    """Set on the thread building a hot-reload replacement: that service
    starts no watcher of its own and leaves the live gauges alone."""
    flag = False


_in_reload = _InReload()


class _Pending:
    """One waiter. Rows live in ONE of two places: the batcher's staging
    slab (``slab=True``, located by ``offset``) — the zero-copy fast
    path — or the waiter's own array (``rows``), the fallback for
    oversized submissions and slab overflow."""

    __slots__ = ("rows", "slab", "offset", "n", "event", "result", "error",
                 "deadline", "t_q")

    def __init__(self, rows: Optional[np.ndarray] = None,
                 deadline: Optional[float] = None, *,
                 n: Optional[int] = None, offset: int = 0) -> None:
        self.rows = rows          # fallback path only (slab entries: None)
        self.slab = rows is None
        self.offset = offset      # row offset inside the staging slab
        self.n = len(rows) if rows is not None else int(n or 0)
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # Absolute time.monotonic() deadline captured from the ambient
        # request context at submit; None = no budget.
        self.deadline = deadline
        # Enqueue time: the goodput ledger's queue-vs-compute split.
        self.t_q = time.monotonic()


class _WindowController:
    """Adaptive flush window (EWMA-rate form): pick the wait the CURRENT
    arrival rate justifies. At low rates the window collapses to
    ``min_wait`` (latency mode); at high rates it grows toward
    ``max_wait``, sized to fill the largest bucket the rate can fill
    within the cap (throughput mode)."""

    __slots__ = ("buckets", "max_wait", "min_wait", "tau", "rate", "_last")

    def __init__(self, buckets: Sequence[int], max_wait_s: float,
                 min_wait_s: float = 0.0, tau_s: float = 0.5) -> None:
        self.buckets = tuple(buckets)
        self.max_wait = max_wait_s
        self.min_wait = min(min_wait_s, max_wait_s)
        self.tau = tau_s
        self.rate = 0.0           # rows/s, EWMA
        self._last: Optional[float] = None

    def observe(self, n_rows: int, now: float) -> None:
        if self._last is None:
            self._last = now
            self.rate = 0.0
            return
        gap = max(now - self._last, 1e-6)
        self._last = now
        # Time-constant EWMA: a long idle stretch decays the rate toward
        # the new (low) instantaneous value instead of remembering a burst.
        w = 1.0 - math.exp(-gap / self.tau)
        self.rate += w * (n_rows / gap - self.rate)

    def window_s(self, flush_s: float = 0.0) -> float:
        """The wait the current rate justifies, in seconds. Once arrivals
        come faster than flushes complete (``rate × flush_s ≥ 1``),
        waiting ~one flush duration coalesces at zero marginal latency."""
        if self.max_wait <= 0:
            return self.min_wait
        fillable = self.rate * self.max_wait
        busy = self.rate * max(flush_s, 0.0) >= 1.0
        if fillable < self.buckets[0] and not busy:
            return self.min_wait
        bucket = max((b for b in self.buckets if b <= fillable),
                     default=self.buckets[0])
        want = bucket / self.rate if self.rate > 0 else self.max_wait
        if busy:
            want = max(want, flush_s)
        return min(self.max_wait, max(want, self.min_wait))


class DynamicBatcher:
    """Coalesce concurrent scoring requests into bucket-padded device calls.

    Requests enqueue feature rows and block; a flusher drains the queue
    whenever ``max_batch`` rows are waiting or the oldest request has
    waited ``max_wait_ms``. Flushing happens on the caller thread that
    triggers the condition — no dedicated thread, no idle spinning.
    """

    def __init__(self, score_fn, buckets: Sequence[int], max_batch: int,
                 max_wait_ms: float, hard_cap_s: float = 60.0,
                 adaptive: bool = False, min_wait_ms: float = 0.0,
                 device="cpu") -> None:
        self._score = score_fn
        # The device ``score_fn`` runs on: a sampled flush's device trace
        # records its CUDA activity when it is the card.
        self._device = device
        # Waiter give-up bound: a submit with no request deadline still
        # cannot wait past this — a wedged flush (device hang) must
        # surface as DeadlineExceeded, not pin the waiter forever.
        self._hard_cap_s = hard_cap_s
        self._buckets = sorted(set(buckets))
        self._max_batch = max_batch
        # Drain cap: flush shapes stay bucketed even when max_batch is
        # set above the largest bucket.
        self._drain_cap = min(max_batch, self._buckets[-1])
        self._max_wait = max_wait_ms / 1000.0
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._queued_rows = 0
        self._flushing = False
        # Zero-copy staging: submits write rows straight into a
        # preallocated slab (capacity = the largest bucket); a flush
        # detaches the slab, pads IN PLACE, and hands a view to the
        # device copy. ``_spare`` recycles the one detached slab a flush
        # can have in flight at a time.
        self._slab: Optional[np.ndarray] = None
        self._spare: Optional[np.ndarray] = None
        self._staged = 0
        self._ctrl = (_WindowController(self._buckets, self._max_wait,
                                        min_wait_ms / 1000.0)
                      if adaptive else None)
        # EWMA flush duration feeding the adaptive controller's
        # saturation floor (rate × flush ≥ 1 → waiting is free).
        self._flush_ewma_s = 0.0
        self.stats = {"flushes": 0, "rows": 0, "max_batch_seen": 0,
                      "zero_copy_flushes": 0}
        reg = get_registry()
        self._m_queue_wait = reg.histogram(
            "rtpu_batcher_queue_wait_seconds",
            "Submit-to-result wait inside the dynamic batcher.")
        self._m_flush = reg.histogram(
            "rtpu_batcher_flush_seconds",
            "One drain: assembly + pad + device compute.")
        self._m_compute = reg.histogram(
            "rtpu_batcher_device_compute_seconds",
            "Device scoring call per flush, by pad bucket.", ("bucket",))
        self._m_fill = reg.histogram(
            "rtpu_batcher_fill_ratio", "Real rows / padded bucket rows.",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        self._m_rows = reg.counter(
            "rtpu_batcher_rows_total", "Rows scored through the batcher.")
        self._m_flushes = reg.counter(
            "rtpu_batcher_flushes_total", "Batcher drains executed.")
        self._m_expired = reg.counter(
            "rtpu_batcher_expired_total",
            "Requests whose deadline expired inside the batcher: "
            "dropped at drain time (stage=drain) or abandoned by their "
            "waiter (stage=wait). Expired rows never reach the device.",
            ("stage",))
        self._m_window = reg.gauge(
            "rtpu_batcher_wait_window_ms",
            "Flush window currently in force (adaptive controller or "
            "the fixed max_wait_ms).")
        self._m_window.set(max_wait_ms)
        self._m_zero_copy = reg.counter(
            "rtpu_batcher_zero_copy_flushes_total",
            "Flushes assembled in place from the staging slab "
            "(no concatenate/pad allocation).")

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return n  # oversized: exact shape

    def _stage_locked(self, rows: np.ndarray, deadline) -> _Pending:
        """Lock held: place the rows. Fast path writes them straight
        into the staging slab; fallback (oversized rows, slab full under
        a flush in flight, unexpected shape) keeps the waiter's own
        array for the concatenate path."""
        n = len(rows)
        cap = self._buckets[-1]
        if getattr(rows, "ndim", 0) == 2 and n <= cap - self._staged:
            if self._slab is None:
                self._slab = np.empty((cap, rows.shape[1]), np.float32)
            if self._slab.shape[1] == rows.shape[1]:
                offset = self._staged
                self._slab[offset:offset + n] = rows
                self._staged += n
                return _Pending(deadline=deadline, n=n, offset=offset)
        return _Pending(rows, deadline=deadline)

    def _repack_locked(self, src: np.ndarray) -> None:
        """Lock held: re-pack every queued slab entry into a dense
        prefix of the CURRENT slab, reading each entry's rows from
        ``src`` (the old slab after a drain detached it, or the current
        one after a mid-queue withdrawal left a hole)."""
        dst = 0
        for p in self._queue:
            if not p.slab:
                continue
            if src is not self._slab or p.offset != dst:
                self._slab[dst:dst + p.n] = src[p.offset:p.offset + p.n]
                p.offset = dst
            dst += p.n
        self._staged = dst

    def _withdraw_locked(self, pending: _Pending) -> bool:
        """Lock held: remove a still-queued entry (deadline give-up)."""
        if pending not in self._queue:
            return False
        self._queue.remove(pending)
        self._queued_rows -= pending.n
        if pending.slab and self._slab is not None:
            self._repack_locked(self._slab)
        return True

    def submit(self, rows: np.ndarray) -> np.ndarray:
        from routest_tpu_torch.serve.deadline import current_deadline

        t_submit = time.perf_counter()
        t_mono = time.monotonic()
        req_deadline = current_deadline()
        # Waiter give-up point: the request's own deadline when it has
        # one, else the batcher's hard cap.
        give_up_at = t_mono + self._hard_cap_s
        if req_deadline is not None:
            give_up_at = min(give_up_at, req_deadline)
        with trace_span("batcher.queue_wait", rows=len(rows)) as qs:
            with self._lock:
                pending = self._stage_locked(rows, req_deadline)
                self._queue.append(pending)
                self._queued_rows += pending.n
                if self._ctrl is not None:
                    self._ctrl.observe(pending.n, t_mono)
                    wait_s = self._ctrl.window_s(self._flush_ewma_s)
                    if wait_s <= 0.0 and (self._flushing
                                          or len(self._queue) > 1):
                        # Latency mode only when the batcher is IDLE: with a
                        # flush in flight (or peers queued) an immediate
                        # drain would fragment batches into lone-row flushes.
                        wait_s = min(max(self._flush_ewma_s, 0.0005),
                                     self._max_wait)
                    self._m_window.set(wait_s * 1000.0)
                else:
                    wait_s = self._max_wait
                should_flush = (self._queued_rows >= self._max_batch
                                and not self._flushing)
            # A flush exception here may belong to OTHER requests' rows; our
            # own failure arrives via pending.error below. A zero adaptive
            # window is latency mode: drain NOW.
            if should_flush or wait_s <= 0.0:
                self._flush_quietly()
            deadline = time.monotonic() + wait_s
            spin = 0.001
            while True:
                # Oldest-waiter timeout: whoever wakes first drains the
                # queue. After the deadline, escalating short waits (1 → 50
                # ms) keep a flush in flight on another thread from being
                # hot-spun against; ``give_up_at`` bounds the whole wait.
                now = time.monotonic()
                if now >= give_up_at and not pending.event.is_set():
                    with self._lock:
                        self._withdraw_locked(pending)
                    if not pending.event.is_set():
                        qs.set_attr("expired", True)
                        self._m_expired.labels(stage="wait").inc()
                        self._m_queue_wait.observe(
                            time.perf_counter() - t_submit)
                        raise DeadlineExceeded(
                            f"batcher wait exceeded "
                            f"{(now - t_mono) * 1000:.0f} ms budget")
                remaining = deadline - now
                if remaining <= 0:
                    remaining = spin
                    spin = min(spin * 2, 0.05)
                wait = max(min(remaining, give_up_at - now + 0.001), 0.001)
                if pending.event.wait(timeout=wait):
                    break
                if time.monotonic() >= give_up_at:
                    continue
                self._flush_quietly()
            qs.set_attr("flushed_inline", should_flush)
        self._m_queue_wait.observe(time.perf_counter() - t_submit)
        if pending.error is not None:
            # A dead device must surface as an error on EVERY waiter,
            # not only the thread that happened to run the flush.
            raise pending.error
        assert pending.result is not None
        return pending.result

    def _flush_quietly(self) -> None:
        """Run a flush whose exceptions belong to the affected waiters
        (delivered via their ``pending.error``), not to this caller."""
        try:
            self._flush()
        except Exception as e:
            get_logger("routest_tpu_torch.serve").debug(
                "batcher_flush_failed", error=f"{type(e).__name__}: {e}")

    def _flush(self) -> None:
        while True:
            expired: List[_Pending] = []
            batch_slab: Optional[np.ndarray] = None
            with self._lock:
                if self._flushing or not self._queue:
                    return
                # Deadline drop at drain time: an entry whose budget
                # expired while queued is withdrawn BEFORE batch
                # assembly (its waiter gets 504 below).
                now = time.monotonic()
                keep = []
                for p in self._queue:
                    if p.deadline is not None and now >= p.deadline:
                        expired.append(p)
                        self._queued_rows -= p.n
                    else:
                        keep.append(p)
                if expired:
                    self._queue[:] = keep
                    if any(p.slab for p in expired) and self._slab is not None:
                        self._repack_locked(self._slab)
                if not self._queue:
                    batch: List[_Pending] = []
                    taken = 0
                else:
                    self._flushing = True
                    # Drain at most the drain cap (whole requests): with
                    # submissions pre-chunked to the largest bucket,
                    # every flush shape stays bucketed.
                    taken = cnt = 0
                    for p in self._queue:
                        if cnt and taken + p.n > self._drain_cap:
                            break
                        taken += p.n
                        cnt += 1
                    batch = self._queue[:cnt]
                    del self._queue[:cnt]
                    self._queued_rows -= taken
                    if batch and all(p.slab for p in batch):
                        # Zero-copy drain: the batch IS the slab's
                        # [0:taken] prefix. Detach it, install the spare,
                        # and move leftover staged rows across.
                        batch_slab = self._slab
                        self._slab = (self._spare if self._spare is not None
                                      else np.empty_like(batch_slab))
                        self._spare = None
                        self._repack_locked(batch_slab)
                    elif batch:
                        # Mixed batch: materialize the slab rows and
                        # take the concatenate path; leftovers re-pack.
                        for p in batch:
                            if p.slab:
                                p.rows = self._slab[
                                    p.offset:p.offset + p.n].copy()
                                p.slab = False
                        if self._slab is not None:
                            self._repack_locked(self._slab)
            for p in expired:
                p.error = DeadlineExceeded("expired in batch queue")
                p.event.set()
            if expired:
                self._m_expired.labels(stage="drain").inc(len(expired))
            if not batch:
                return
            try:
                t_flush = time.perf_counter()
                queue_s = max(0.0, time.monotonic()
                              - min(p.t_q for p in batch))
                with trace_span("batcher.flush", requests=cnt) as fs:
                    n = taken
                    bucket = self._bucket(n)
                    fs.set_attr("rows", n)
                    fs.set_attr("bucket", bucket)
                    fs.set_attr("zero_copy", batch_slab is not None)
                    with trace_span("batcher.pad", rows=n, bucket=bucket,
                                    pad_rows=bucket - n):
                        if batch_slab is not None:
                            # Pad in place: zero the tail rows of the
                            # detached slab and hand the device copy a
                            # VIEW.
                            if bucket > n:
                                batch_slab[n:bucket] = 0.0
                            padded = batch_slab[:bucket]
                        else:
                            padded = pad_rows(
                                np.concatenate([p.rows for p in batch],
                                               axis=0), bucket)
                    t_dev = time.perf_counter()
                    with trace_span("batcher.device_compute", rows=n,
                                    bucket=bucket) as ds:
                        # Chaos fault point: an injected error here is
                        # indistinguishable from a dead device — every
                        # waiter in this batch surfaces it, nothing is
                        # scored anywhere else, and the slab is only
                        # recycled below. A ``skew`` fault returns a
                        # magnitude added to the scored outputs.
                        skew = chaos_inject("device.compute")
                        # Budget permitting, a sampled flush also
                        # records the torch.profiler trace that
                        # explains it (one trace id across both).
                        with maybe_device_trace(ds, self._device):
                            preds = np.asarray(self._score(padded))[:n]
                        if skew:
                            preds = preds + skew
                    if batch_slab is not None and \
                            np.shares_memory(preds, batch_slab):
                        # The slab is about to be recycled, so waiters
                        # must own their rows.
                        preds = preds.copy()
                    compute_s = time.perf_counter() - t_dev
                    self._m_compute.labels(bucket=bucket).observe(
                        compute_s)
                get_ledger().record(
                    "eta_score", real_rows=n, padded_rows=bucket,
                    bucket=bucket, queue_s=queue_s, compute_s=compute_s,
                    oversized=n > self._buckets[-1])
                flush_dur = time.perf_counter() - t_flush
                self._m_flush.observe(flush_dur)
                self._flush_ewma_s += 0.3 * (flush_dur - self._flush_ewma_s)
                self._m_fill.observe(n / bucket if bucket else 1.0)
                self._m_rows.inc(n)
                self._m_flushes.inc()
                self.stats["flushes"] += 1
                self.stats["rows"] += n
                if batch_slab is not None:
                    self.stats["zero_copy_flushes"] += 1
                    self._m_zero_copy.inc()
                self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n)
                offset = 0
                for p in batch:
                    p.result = preds[offset: offset + p.n]
                    offset += p.n
                    p.event.set()
            except Exception as e:
                for p in batch:
                    p.error = e
                    p.event.set()
                raise
            finally:
                with self._lock:
                    self._flushing = False
                    # The detached slab re-enters circulation only after
                    # the flush's device copy consumed it.
                    if batch_slab is not None and self._spare is None:
                        self._spare = batch_slab
                    more = self._queued_rows >= self._drain_cap
            if not more:
                return


class EtaService:
    """Model lifecycle + prediction API for the serving layer.

    ``device``: "cuda" (default: ``cfg.device``) serves through the
    hand kernel and raises at construction when there is no card;
    "cpu" serves through the kernel's plain version."""

    def __init__(self, cfg: Optional[ServeConfig] = None,
                 model_path: Optional[str] = None,
                 device: Optional[str] = None) -> None:
        cfg = cfg or ServeConfig()
        self._t_construct = time.perf_counter()
        self._cfg = cfg
        self.device = resolve_device(device or cfg.device, "EtaService")
        self._model = None
        self._params = None
        self._packed = None
        self._score = None
        self._error: Optional[str] = None
        self.kernel_dtype: Optional[str] = None
        self.kernel = ("cuda_fused" if self.device.type == "cuda"
                       else "torch_plain")
        self._path = model_path or default_model_path()
        # Taken before the load: a file changed during it is picked up
        # by the next poll.
        self._loaded_mtime_ns = self._artifact_mtime_ns()
        self._reload_lock = threading.Lock()
        self.fingerprint: Optional[str] = None
        self.loaded_unix: Optional[float] = None
        self._batcher: Optional[DynamicBatcher] = None
        self._serving = _EMPTY_SERVING
        # Fast lane (serve/fastlane.py): per-row prediction cache +
        # singleflight consulted in _predict_rows before the batcher.
        self._fastlane = None
        if cfg.fastlane_cache or cfg.fastlane_singleflight:
            from routest_tpu_torch.serve.fastlane import FastLane

            self._fastlane = FastLane(
                capacity=cfg.fastlane_cache_size,
                ttl_s=cfg.fastlane_cache_ttl_s,
                cache=cfg.fastlane_cache,
                singleflight=cfg.fastlane_singleflight,
                max_rows=cfg.fastlane_max_rows)
        # Hot-reload watcher (cfg.reload_sec > 0): the service owns it,
        # so embedders constructing EtaService directly get it too.
        # Suppressed inside a reload's own replacement construction.
        if cfg.reload_sec > 0 and not _in_reload.flag:
            self._watcher_stop = self.start_reload_watcher(cfg.reload_sec)
        self._load(self._path)
        if self._model is not None:
            self._finish_init()

    def _load(self, path: str) -> None:
        """Load + pack once: the packed weights stay on the device. The
        file's magic is sniffed first: a ``torch.export`` artifact
        (``RTPUT1``) serves its own program on the device (kernel
        ``torch_export``), and a JAX StableHLO export (``RTPUX1``) is
        refused by name. Otherwise an ``RTPU1`` artifact is tried, then
        the reference's own model family, an XGBoost JSON file, served
        as tensorized gather chains (``models/gbdt.py``) on the same
        device. When both fail, the first loader's error is the one
        reported."""
        # Chaos fault point: an injected fault degrades exactly like a
        # corrupt file — load_error set, the old model (if any) keeps
        # serving.
        try:
            chaos_inject("model.load")
        except ChaosError as e:
            self._error = f"chaos injected at model.load: {e}"
            return
        self.fingerprint = _artifact_fingerprint(path)
        try:
            with open(path, "rb") as f:
                head = f.read(len(TORCH_EXPORT_MAGIC))
        except OSError:
            head = b""  # load_model reports the missing path
        if head in (TORCH_EXPORT_MAGIC, JAX_EXPORT_MAGIC):
            try:
                self._model = load_exported_serving_fn(path, self.device)
            except Exception as e:
                self._error = f"{type(e).__name__}: {e}"
                return
            self._params = None  # weights are constants in the program
            self.kernel = "torch_export"
            self.kernel_dtype = self._model.header.get("compute_dtype")
            return
        try:
            model, params = load_model(path)
            model.policy = backend_compute_policy(model.policy, self.device)
            variant = resolve_kernel_dtype(model)
            self._packed = pack_eta_params(model, params, dtype=variant,
                                           device=self.device)
        except Exception as e:
            first_error = f"{type(e).__name__}: {e}"
        else:
            self._model, self._params = model, params
            self.kernel_dtype = variant
            return
        from routest_tpu_torch.models.gbdt import load_xgboost_eta

        try:
            self._model, self._params = load_xgboost_eta(
                path, device=self.device)
        except Exception:  # the RTPU1 loader's error is what health shows
            self._error = first_error
            return
        self.kernel = "gbdt_gather"
        self.kernel_dtype = "float32"

    def _score_fn(self):
        """The scorer of THIS model: one bucket slab → host→device copy,
        one forward (the fused kernel over this packing, or the tree
        ensemble's gathers), result back to the host. It closes over
        the model, so a batcher keeps scoring its own model after a hot
        swap replaces the service's fields."""
        device = self.device
        if self.kernel == "torch_export":
            program = self._model

            def score(x: np.ndarray) -> np.ndarray:
                xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
                with torch.no_grad():
                    return program(xt.to(device)).cpu().numpy()

            return score
        if self._packed is None:
            ensemble, params = self._model, self._params

            def score(x: np.ndarray) -> np.ndarray:
                xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
                return ensemble.apply(params, xt.to(device)).cpu().numpy()

            return score
        packed, n_q = self._packed, len(self.quantiles)

        def score(x: np.ndarray) -> np.ndarray:
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return fused_eta_forward(packed, xt.to(device),
                                     n_q=n_q).cpu().numpy()

        return score

    def _finish_init(self) -> None:
        """Batcher, one-row self-check, bucket warmup."""
        cfg = self._cfg
        self._score = self._score_fn()
        self._batcher = DynamicBatcher(
            self._score, cfg.batch_buckets, cfg.max_batch, cfg.max_wait_ms,
            adaptive=cfg.adaptive_wait, min_wait_ms=cfg.min_wait_ms,
            device=self.device)
        # Self-check: an artifact can deserialize fine yet be unusable,
        # and a kernel can fail to build or launch. Run one dummy row
        # now so breakage surfaces in health as model:degraded instead
        # of per-request 503s with health claiming ok.
        try:
            probe = np.zeros((1, self._model.n_features), np.float32)
            if not np.isfinite(self._batcher.submit(probe)).all():
                raise ValueError("self-check produced non-finite output")
        except Exception as e:
            self._error = f"model self-check failed: {type(e).__name__}: {e}"
            self._model = None
            self._params = None
            self._packed = None
            self._batcher = None
            self._score = None
            self.kernel_dtype = None
            self._serving = _EMPTY_SERVING
            return
        self._serving = _ServingState(self._model, self._batcher,
                                      self.quantiles,
                                      generation=next(_GENERATION))
        self.loaded_unix = time.time()
        # A replacement built for verification is NOT live yet; its
        # parent flips the gauge if (and only if) the swap lands.
        if not _in_reload.flag:
            _m_generation.set(self._serving.generation)
        self._warm_buckets()
        if not _in_reload.flag:
            _m_cold_start.set(time.perf_counter() - self._t_construct)

    def _artifact_mtime_ns(self) -> Optional[int]:
        try:
            return os.stat(self._path).st_mtime_ns
        except OSError:
            return None

    def reload_if_changed(self) -> bool:
        """Hot-reload the serving artifact when its file changed.

        The reference's only way to pick up a new model is a process
        restart (the pickle loads once, ``Flaskr/ml.py:11-21``); here a
        changed ``ETA_MODEL_PATH`` file swaps in WITHOUT dropping
        requests: a complete replacement service (model, packing and
        batcher, self-checked and bucket-warmed) is built off to the
        side, then the references flip — in-flight requests finish on
        the old batcher, new requests land on the new one. A broken
        replacement (missing/corrupt/failed self-check or golden-batch
        gate) keeps the old model serving and returns False. Returns
        True only after a successful swap."""
        with self._reload_lock:
            mtime = self._artifact_mtime_ns()
            if mtime is None or mtime == self._loaded_mtime_ns:
                return False
            log = get_logger("routest_tpu_torch.serve")
            _in_reload.flag = True
            try:
                fresh = EtaService(self._cfg, model_path=self._path,
                                   device=str(self.device))
            finally:
                _in_reload.flag = False
            if not fresh.available:
                _m_swaps.labels(result="rejected").inc()
                log.warning("model_reload_rejected", path=self._path,
                            fingerprint=fresh.fingerprint,
                            error=fresh.load_error)
                # remember the bad mtime: don't rebuild-and-reject on
                # every poll until the file changes again
                self._loaded_mtime_ns = mtime
                return False
            # Golden-batch gate: a deserializable, self-check-passing
            # artifact can still be wrong. Score the fixed golden rows
            # off-path and reject non-finite or wildly divergent outputs
            # BEFORE the generation flips.
            ok, verdict = self._verify_swap(fresh)
            if not ok:
                _m_swaps.labels(result="rejected").inc()
                log.warning("model_swap_rejected", path=self._path,
                            fingerprint=fresh.fingerprint, **verdict)
                self._loaded_mtime_ns = mtime
                return False
            # ONE reference flip makes the swap atomic for readers (they
            # snapshot _serving once per request); the individual fields
            # follow for stats/health introspection.
            self._serving = fresh._serving
            self._model = fresh._model
            self._params = fresh._params
            self._packed = fresh._packed
            self._batcher = fresh._batcher
            self._score = fresh._score
            self.kernel = fresh.kernel
            self.kernel_dtype = fresh.kernel_dtype
            self._error = None
            self._loaded_mtime_ns = fresh._loaded_mtime_ns
            self.fingerprint = fresh.fingerprint
            self.loaded_unix = fresh.loaded_unix
            _m_swaps.labels(result="accepted").inc()
            _m_generation.set(self._serving.generation)
            record_change("model.swap",
                          detail={"generation": self._serving.generation,
                                  "fingerprint": self.fingerprint,
                                  "path": self._path})
            # Correctness already holds (the new generation keys new
            # cache entries); this frees the dead generation's entries
            # now instead of at LRU/TTL time.
            if self._fastlane is not None:
                self._fastlane.invalidate()
            log.info("model_reloaded", path=self._path, kernel=self.kernel,
                     generation=self._serving.generation,
                     fingerprint=self.fingerprint, **verdict)
            return True

    def _verify_swap(self, fresh: "EtaService") -> Tuple[bool, dict]:
        """Score the golden batch on the REPLACEMENT service →
        ``(accept, verdict-detail)``. Two gates: every output finite,
        and — when the live model is comparable (same output shape; a
        point→quantile upgrade is a deliberate structural change and
        skips it) — median absolute divergence within
        ``swap_max_divergence`` minutes. Both run off-path, the first
        on the replacement's own batcher."""
        cfg = self._cfg
        if not cfg.swap_verify:
            return True, {"verified": False}
        golden = golden_batch()
        try:
            new = fresh._predict_rows(fresh._serving, golden)
        except Exception as e:
            return False, {"reason": "golden batch scoring failed: "
                                     f"{type(e).__name__}: {e}"}
        if new is None:
            return False, {"reason": "golden batch produced no output"}
        new = np.asarray(new, np.float64)
        finite = np.isfinite(new).reshape(len(new), -1).all(axis=1)
        if not finite.all():
            return False, {"reason": "non-finite golden outputs",
                           "bad_rows": int((~finite).sum()),
                           "rows": int(len(new))}
        bound = float(cfg.swap_max_divergence or 0.0)
        serving = self._serving
        if bound > 0 and serving.batcher is not None:
            try:
                old = self._predict_rows(serving, golden)
            except Exception as e:
                # live model unscoreable: the finiteness gate decides
                get_logger("routest_tpu_torch.serve").warning(
                    "swap_live_scoring_failed",
                    error=f"{type(e).__name__}: {e}")
                old = None
            if old is not None:
                old = np.asarray(old, np.float64)
                if old.shape == new.shape and bool(np.isfinite(old).all()):
                    div = float(np.median(np.abs(new - old)))
                    if div > bound:
                        return False, {"reason": "divergence beyond bound",
                                       "divergence": round(div, 3),
                                       "bound": bound}
                    return True, {"divergence": round(div, 4),
                                  "bound": bound}
        return True, {}

    def start_reload_watcher(self, interval_s: float) -> threading.Event:
        """Poll the artifact mtime every ``interval_s`` seconds on a
        daemon thread (``ROUTEST_RELOAD_SEC`` wires this in). Returns
        the stop event."""
        stop = threading.Event()

        def watch() -> None:
            while not stop.wait(interval_s):
                try:
                    self.reload_if_changed()
                except Exception as e:  # never kill the watcher
                    get_logger("routest_tpu_torch.serve").error(
                        "model_reload_failed",
                        error=f"{type(e).__name__}: {e}")

        threading.Thread(target=watch, name="eta-reload-watcher",
                         daemon=True).start()
        return stop

    def _warm_buckets(self) -> None:
        """Run every batch bucket once at startup (the kernel's first
        launch loads the library; later buckets touch their allocation
        sizes), so no customer request pays it. ``ROUTEST_WARM_BUCKETS=0``
        opts out. A failure here logs and leaves the lazy path: it must
        never tear down a model the self-check just proved serviceable."""
        if os.environ.get("ROUTEST_WARM_BUCKETS", "1") == "0":
            return
        log = get_logger("routest_tpu_torch.serve")
        t0 = time.time()
        for bucket in self._batcher._buckets:
            try:
                self._score(np.zeros((bucket, self._model.n_features),
                                     np.float32))
            except Exception as e:
                log.warning("bucket_warm_failed", bucket=bucket,
                            error=f"{type(e).__name__}: {e}")
        log.info("batch_buckets_warmed", buckets=list(self._batcher._buckets),
                 seconds=round(time.time() - t0, 2))

    @property
    def available(self) -> bool:
        return self._model is not None

    @property
    def generation(self) -> int:
        """Generation id of the LIVE serving snapshot (-1 = nothing
        serving). The fast-lane cache keys on it."""
        return self._serving.generation

    @property
    def model_path(self) -> str:
        return self._path

    @property
    def quantiles(self) -> Tuple[float, ...]:
        """Quantile levels the serving model predicts; () for point models."""
        if self._model is None:
            return ()
        return tuple(self._model.quantiles)

    @property
    def load_error(self) -> Optional[str]:
        return self._error

    def scoring_info(self) -> dict:
        """Which model family serves (``eta_mlp``, or ``xgboost`` for a
        tree ensemble), through which compute path (``cuda_fused`` on
        the card, ``torch_plain`` on an explicit CPU run, ``gbdt_gather``
        for trees, ``torch_export`` for an exported program), at what
        dtype, where."""
        family = (None if self._model is None else
                  "eta_mlp" if self._packed is not None
                  or self.kernel == "torch_export" else "xgboost")
        return {"family": family, "kernel": self.kernel,
                "dtype": self.kernel_dtype, "device": str(self.device)}

    def mesh_info(self) -> dict:
        """The replica's device topology (health's ``checks.engine.mesh``)."""
        info: dict = {"platform": self.device.type, "sharded": False}
        if self.device.type == "cuda":
            info["devices"] = torch.cuda.device_count()
            info["device_name"] = torch.cuda.get_device_name(self.device)
        else:
            info["devices"] = 1
        return info

    def predict_batch(self, rows: np.ndarray) -> Optional[np.ndarray]:
        return self._predict_rows(self._serving, rows)

    def _predict_rows(self, serving: _ServingState, rows: np.ndarray,
                      blob=None) -> Optional[np.ndarray]:
        """Score rows against ONE serving snapshot. The fast lane is
        consulted first: cached rows never reach the batcher, novel rows
        coalesce with identical in-flight ones, and only the remainder
        costs a device slot. ``blob`` (the wire path) is the rows' raw
        float32 bytes, which the fast lane slices its keys from."""
        batcher = serving.batcher
        if batcher is None:
            return None
        rows = np.asarray(rows, np.float32)
        # Host-side non-finite containment: a NaN/Inf input row must not
        # poison its batch-mates — the device only ever sees finite rows.
        # Bad rows score as a finite placeholder and their outputs are
        # stamped back to NaN, which the response layer serializes as null.
        bad = ~np.isfinite(rows).all(axis=1)
        if bad.any():
            rows = np.where(bad[:, None], np.float32(0.0), rows)
            blob = None  # rewritten rows no longer match the wire bytes
        fl = self._fastlane
        if fl is not None and fl.accepts(len(rows)):
            # Cache key = (model generation, live-metric epoch): a metric
            # flip retires every cached prediction the same way a model
            # swap does. The epoch is 0 while live traffic is off.
            # The span carries the request's provenance: which model
            # generation and metric epoch served the rows, and how many
            # came from the cache.
            epoch = metric_epoch()
            with trace_span("fastlane.predict", rows=len(rows),
                            model_generation=serving.generation,
                            metric_epoch=epoch) as fspan:
                preds = fl.predict(
                    rows, (serving.generation, epoch),
                    lambda miss: self._submit_chunked(batcher, miss),
                    span=fspan, blob=blob)
        else:
            preds = self._submit_chunked(batcher, rows)
        if bad.any() and preds is not None:
            preds = np.array(preds, np.float64, copy=True)  # never mutate
            preds[bad] = np.nan                  # a cached/shared buffer
        return preds

    @staticmethod
    def _submit_chunked(batcher: DynamicBatcher,
                        rows: np.ndarray) -> np.ndarray:
        # Chunk oversize batches to the largest bucket.
        cap = batcher._buckets[-1]
        if len(rows) <= cap:
            return batcher.submit(rows)
        return np.concatenate([
            batcher.submit(rows[i: i + cap])
            for i in range(0, len(rows), cap)])

    def predict_eta_minutes(
        self, *, weather: str, traffic: str, distance_m: float,
        pickup_time, driver_age: float = 30.0,
    ) -> Tuple[Optional[float], Optional[str]]:
        """Reference-signature single prediction (``Flaskr/ml.py:23``):
        returns (eta_minutes, completion_iso) or (None, None)."""
        serving = self._serving
        if serving.batcher is None:
            return None, None
        pickup_dt = _parse_pickup_single(pickup_time)
        rows = encode_requests(
            weather=[weather], traffic=[traffic],
            weekday=[pickup_dt.weekday()], hour=[pickup_dt.hour],
            distance_km=[float(distance_m or 0) / 1000.0],
            driver_age=[float(driver_age or 30.0)],
        )
        try:
            preds = self._predict_rows(serving, rows)
        except DeadlineExceeded:
            raise  # 504, not "model unavailable": the budget ran out
        except Exception as e:
            get_logger("routest_tpu_torch.serve").error(
                "predict_failed", error=f"{type(e).__name__}: {e}")
            return None, None
        if preds is None:
            return None, None
        row = np.atleast_1d(preds[0])
        q = serving.quantiles
        # The row is servable iff its MEDIAN is finite.
        median = float(row[q.index(0.5)] if q else row[0])
        if not np.isfinite(median):
            return None, None
        eta_ts = (pickup_dt + dt.timedelta(minutes=median)).isoformat()
        return median, eta_ts

    def predict_eta_quantiles(
        self, *, weather: str, traffic: str, distance_m: float,
        pickup_time, driver_age: float = 30.0,
    ) -> Tuple[Optional[float], Optional[str], dict]:
        """Single prediction plus the uncertainty band: (eta_median,
        completion_iso, {"p10": …, "p90": …}). The dict is empty for
        point models."""
        if not self.quantiles:
            eta, iso = self.predict_eta_minutes(
                weather=weather, traffic=traffic, distance_m=distance_m,
                pickup_time=pickup_time, driver_age=driver_age)
            return eta, iso, {}
        pickup_dt = _parse_pickup_single(pickup_time)
        try:
            minutes, _iso, bands = self.predict_eta_batch(
                weather=[weather], traffic=[traffic], distance_m=[distance_m],
                pickup_time=pickup_dt, driver_age=[driver_age],
                return_quantiles=True)
        except DeadlineExceeded:
            raise  # budget expiry must surface as 504, not a null field
        except Exception as e:
            get_logger("routest_tpu_torch.serve").error(
                "predict_failed", error=f"{type(e).__name__}: {e}")
            return None, None, {}
        if minutes is None or not np.isfinite(minutes[0]):
            return None, None, {}
        # Completion stamp via the SINGLE-ROW formula (sub-second
        # precision, preserved UTC offset).
        eta_minutes = float(minutes[0])
        iso = (pickup_dt + dt.timedelta(minutes=eta_minutes)).isoformat()
        return (eta_minutes, iso,
                {k: float(v[0]) for k, v in bands.items()
                 if np.isfinite(v[0])})

    def predict_eta_batch(
        self, *, weather: Sequence[str], traffic: Sequence[str],
        distance_m: Sequence[float], pickup_time,
        driver_age: Sequence[float], return_quantiles: bool = False,
    ):
        """Batched scoring: N OD pairs → (minutes (N,), completion ISO (N,)).

        ``pickup_time`` may be a single ISO string (shared by the batch)
        or a sequence of N. Returns (None, None) when no model is
        serving. With ``return_quantiles=True`` a third element is a
        dict of per-level minute arrays (``{"p10": (N,), "p90": (N,)}``),
        empty for point models; minutes are the median.
        """
        serving = self._serving  # one snapshot: scoring + metadata
        if serving.batcher is None:
            return (None, None, {}) if return_quantiles else (None, None)
        n = len(distance_m)
        if isinstance(pickup_time, (str, dt.datetime)) or pickup_time is None:
            pickup_time = [pickup_time] * n

        def parse(p):
            # Shared single-row semantics, then keep offset-local WALL
            # time (drop tzinfo for datetime64).
            return _parse_pickup_single(p).replace(tzinfo=None)

        pickups = [parse(p) for p in pickup_time]
        rows = encode_requests(
            weather=list(weather), traffic=list(traffic),
            weekday=[p.weekday() for p in pickups],
            hour=[p.hour for p in pickups],
            distance_km=[float(d or 0) / 1000.0 for d in distance_m],
            driver_age=[float(a or 30.0) for a in driver_age],
        )
        preds = self._predict_rows(serving, rows)
        if preds is None:
            return (None, None, {}) if return_quantiles else (None, None)
        preds = np.asarray(preds, np.float64)
        q = serving.quantiles
        bands: dict = {}
        if q:
            minutes = preds[:, q.index(0.5)]
            if return_quantiles:
                bands = {_band_label(level): preds[:, i]
                         for i, level in enumerate(q) if level != 0.5}
        else:
            minutes = preds
        # Vectorized completion stamps (datetime64 arithmetic).
        base = np.asarray([np.datetime64(p, "ms") for p in pickups])
        completion = base + (minutes * 60_000.0).astype("timedelta64[ms]")
        iso = np.datetime_as_string(completion, unit="s")
        return (minutes, iso, bands) if return_quantiles else (minutes, iso)

    def predict_eta_wire(self, features: np.ndarray,
                         pickup_ms: np.ndarray, blob=None):
        """Binary-wire batched scoring: pre-encoded (N, 12) float32
        features + (N,) int64 pickup epoch-ms → ``(minutes (N,) f64,
        completion_ms (N,) i64, bands {label: (N,) f64})``, or None
        when no model is serving.

        The client featurized with the same ``encode_requests`` the JSON
        path uses, so scoring sees bit-identical rows, and the completion
        math below is the SAME float64 expression as the JSON path's
        datetime64 arithmetic (``ms + int64(minutes * 60_000.0)``): the
        two content-types answer bitwise-identically. NaN-minute rows
        stamp the datetime64 NaT sentinel (``wirecodec.COMPLETION_NAT``).
        ``blob`` is the frame's raw feature bytes, threaded to the fast
        lane's keys."""
        serving = self._serving  # one snapshot: scoring + metadata
        if serving.batcher is None:
            return None
        preds = self._predict_rows(serving, features, blob=blob)
        if preds is None:
            return None
        preds = np.asarray(preds, np.float64)
        q = serving.quantiles
        bands: dict = {}
        if q:
            minutes = preds[:, q.index(0.5)]
            bands = {_band_label(level): preds[:, i]
                     for i, level in enumerate(q) if level != 0.5}
        else:
            minutes = preds
        pickup_ms = np.asarray(pickup_ms, np.int64)
        from routest_tpu_torch.serve.wirecodec import COMPLETION_NAT

        finite = np.isfinite(minutes)
        completion_ms = np.full(minutes.shape, COMPLETION_NAT, np.int64)
        if finite.any():
            # float→int truncation toward zero, exactly what the JSON
            # path's float64→timedelta64[ms] astype performs.
            completion_ms[finite] = (
                pickup_ms[finite]
                + (minutes[finite] * 60_000.0).astype(np.int64))
        return minutes, completion_ms, bands

    @property
    def stats(self) -> dict:
        base = {"available": self.available, "error": self._error,
                "kernel": self.kernel, "generation": self.generation,
                "fingerprint": self.fingerprint}
        if self._batcher is not None:
            base.update(self._batcher.stats)
        if self._fastlane is not None:
            base["fastlane"] = self._fastlane.snapshot()
        return base
