"""Device goodput ledger + throughput-regression watchdog.

The efficiency axis of the observability spine. The SLOs watch latency
and errors, the prober correctness; this module measures whether the devices are doing *useful* work — the MFU/goodput
tradition (utilization-normalized throughput as the canonical health
signal) applied to this stack's device programs.

Two pieces:

- :class:`GoodputLedger` — always-on accounting every device-program
  call site reports into: the ETA scoring batcher
  (``serve/ml_service.py``), the fastlane cache in front of it
  (``serve/fastlane.py``, rows served *without* device compute), the
  road-solve batcher (``optimize/road_router.py``), and the dispatch
  batcher/reopt passes (``routest_tpu_torch/dispatch``). One ``record()`` per
  device call carries real rows, padded rows, the bucket chosen, and
  the queue-vs-compute wall split; the ledger rolls them into the
  ``rtpu_efficiency_*`` families on the process registry (so they flow
  through ``/api/timeline`` on both tiers with zero extra wiring) plus
  bounded per-(program, bucket) windows that expose LIVE per-bucket
  goodput — real rows per device-compute-second, the load-independent
  number a pinned throughput curve can be compared against.

- :class:`EfficiencyWatchdog` — pins the measured per-bucket
  throughput curve from the port's own kernel record
  (``artifacts/serving_kernel_cuda.json``, ``RTPU_EFF_KERNEL_ARTIFACT``;
  backend-matched: a record whose ``backend`` is not this process's —
  ``cuda`` on the card, ``cpu`` when the caller asked for the CPU — is
  refused as ``backend_mismatch``, and one whose ``device`` names
  another card than this process's as ``device_mismatch``: a curve
  measured on another card says nothing about this one), continuously
  compares live goodput against the pinned curve, and on sustained
  shortfall past ``RTPU_EFF_MIN_RATIO`` — or windowed padding waste
  past ``RTPU_EFF_MAX_WASTE`` — debounced over ``RTPU_EFF_AFTER``
  consecutive bad ticks (the prober's skew-verdict convention), emits
  verdicts into ``rtpu_efficiency_checks_total`` judged by a dedicated
  ``efficiency`` burn-rate engine whose page ships a flight-recorder
  bundle naming the program, replica, bucket, and the
  expected-vs-measured curve. Missing or foreign-backend artifacts
  degrade LOUDLY to ledger-only (no watchdog) — surfaced in
  ``/api/health`` and ``/api/efficiency``, never silently.

Hot-path discipline: ``record()`` is a handful of counter increments
plus one bounded deque append under a lock — no device calls, no
artifact IO (device identity is resolved lazily and cached off-path).
Disabled (``RTPU_EFF=0``) it is one attribute check.

The kernel record the watchdog pins from is a JSON object with
``backend`` (``"cuda"``), ``device`` (``torch.cuda.get_device_name``)
and ``rows``: one per batch size, ``{"batch": B, "kernel_mpreds_s": r,
"plain_mpreds_s": r}`` — the hand-written kernel's and its plain
PyTorch version's measured rates in millions of rows per second, the
port's counterparts of the JAX record's ``xla_mpreds_s`` /
``aot_mpreds_s``. ``scripts/bench_serving_kernel_cuda.py`` writes it on
the card (``rows`` are the served dtype's; other keys it writes, such
as ``kernel_us``, ``kernel_tile``, ``plain_us`` and ``rows_by_dtype``,
are not read here). The expected rate per bucket is the smaller of the
two. On more than one device the per-replica factor comes from the
fleet placement curve at ``chips_artifact`` (the port's
``artifacts/fleet_chips_cuda.json``), read by the placement planner's
own platform-matched reader; without a matching record it stays 1.0
(``chips_note`` says ``chips_artifact_unmatched``).
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from routest_tpu_torch.core.config import EfficiencyConfig, load_efficiency_config
from routest_tpu_torch.obs.registry import MetricsRegistry, get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.obs.efficiency")

# Every device program that reports into the ledger. Declared here so
# the watchdog and the SLO wiring judge a CLOSED set — a new call site
# adds its program name here and is covered by the padding objective
# from its first recorded row.
PROGRAMS: Tuple[str, ...] = (
    "eta_score", "route_solve", "dispatch_solve", "dispatch_reopt")

# Fill-fraction histogram bounds: real/padded per device call (1.0 =
# zero padding waste).
FILL_BUCKETS: Tuple[float, ...] = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def replica_label() -> str:
    """This process's identity in evidence bundles and fleet snapshots:
    host:port under a fleet supervisor (which sets ``PORT`` per
    replica), host:pid otherwise."""
    return f"{socket.gethostname()}:{os.environ.get('PORT') or os.getpid()}"


def device_identity(device=None) -> Dict[str, object]:
    """Backend/device identity recorded with every snapshot: backend
    ``cuda`` with ``torch.cuda.get_device_name``, or ``cpu`` when the
    caller asked for the CPU (``device``; None = the serving device,
    ``ROUTEST_DEVICE``). Lazy and fail-soft: the ledger must work (and
    the hot path must never pay) where no card can be queried."""
    try:
        import torch

        from routest_tpu_torch.core.config import load_config

        dev = torch.device(device if device is not None
                           else load_config().serve.device)
        if dev.type == "cpu":
            return {"backend": "cpu", "device": "cpu", "device_count": 1}
        return {"backend": "cuda",
                "device": torch.cuda.get_device_name(dev),
                "device_count": torch.cuda.device_count()}
    except Exception as e:  # no card to ask: unknown backend, surfaced
        return {"backend": None, "device": None, "device_count": 0,
                "error": f"{type(e).__name__}: {e}"}


class GoodputLedger:
    """Per-program real-vs-padded row accounting with live windowed
    per-bucket goodput. One instance per process (``get_ledger()``);
    tests construct their own against a private registry."""

    def __init__(self, config: Optional[EfficiencyConfig] = None,
                 registry: Optional[MetricsRegistry] = None) -> None:
        self.config = config if config is not None \
            else load_efficiency_config()
        self.enabled = self.config.enabled
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._m_rows = reg.counter(
            "rtpu_efficiency_rows_total",
            "Real (useful) rows computed on device, by program.",
            ("program",))
        self._m_padded = reg.counter(
            "rtpu_efficiency_padded_rows_total",
            "Padded rows actually launched on device (real + pad "
            "waste), by program.", ("program",))
        self._m_cached = reg.counter(
            "rtpu_efficiency_cached_rows_total",
            "Rows served WITHOUT device compute (cache hits, "
            "coalesced waiters), by program.", ("program",))
        self._m_calls = reg.counter(
            "rtpu_efficiency_calls_total",
            "Device-program launches recorded in the ledger, by "
            "program.", ("program",))
        self._m_oversized = reg.counter(
            "rtpu_efficiency_oversized_total",
            "Launches whose real rows exceeded the largest configured "
            "bucket (align-rounded / ride-alone paths), by program.",
            ("program",))
        self._m_fill = reg.histogram(
            "rtpu_efficiency_bucket_fill",
            "Bucket fill fraction per launch: real rows / padded rows "
            "(1.0 = no padding waste).", ("program",),
            buckets=FILL_BUCKETS)
        self._m_device_s = reg.counter(
            "rtpu_efficiency_device_seconds_total",
            "Wall seconds spent inside device compute, by program.",
            ("program",))
        self._m_queue_s = reg.counter(
            "rtpu_efficiency_queue_seconds_total",
            "Wall seconds requests spent queued before their device "
            "launch (per launch: oldest rider's wait), by program.",
            ("program",))
        self._m_goodput = reg.gauge(
            "rtpu_efficiency_goodput_rows_per_s",
            "Windowed goodput: real rows per device-compute-second, "
            "by program (load-independent health signal).", ("program",))
        self._m_waste = reg.gauge(
            "rtpu_efficiency_waste_fraction",
            "Windowed padding waste: 1 - real/padded over the ledger "
            "window, by program.", ("program",))
        self._lock = threading.Lock()
        # (program, bucket) → deque[(t_mono, real, padded, compute_s)]
        self._win: Dict[Tuple[str, int], deque] = {}
        self._identity: Optional[Dict[str, object]] = None
        # The serving device whose identity snapshots carry (None = the
        # configured one); bring-up binds the app's device.
        self._device = None

    # ── hot path ──────────────────────────────────────────────────────

    def record(self, program: str, *, real_rows: int, padded_rows: int,
               bucket: Optional[int] = None, queue_s: float = 0.0,
               compute_s: float = 0.0, oversized: bool = False) -> None:
        """One device launch: ``real_rows`` useful rows inside a
        ``padded_rows``-row launch (``bucket`` = the configured bucket
        chosen; defaults to ``padded_rows``), split into queue wait vs
        device compute wall time."""
        if not self.enabled:
            return
        real = max(0, int(real_rows))
        padded = max(real, int(padded_rows))
        b = int(bucket) if bucket else padded
        self._m_rows.labels(program=program).inc(real)
        self._m_padded.labels(program=program).inc(padded)
        self._m_calls.labels(program=program).inc()
        if padded > 0:
            self._m_fill.labels(program=program).observe(real / padded)
        if compute_s > 0:
            self._m_device_s.labels(program=program).inc(compute_s)
        if queue_s > 0:
            self._m_queue_s.labels(program=program).inc(queue_s)
        if oversized:
            self._m_oversized.labels(program=program).inc()
        now = time.monotonic()
        horizon = now - self.config.window_s
        with self._lock:
            dq = self._win.get((program, b))
            if dq is None:
                dq = self._win[(program, b)] = deque()
            dq.append((now, real, padded, compute_s))
            while dq and dq[0][0] < horizon:
                dq.popleft()
            rows = pad = comp = 0.0
            for key, other in self._win.items():
                if key[0] != program:
                    continue
                while other and other[0][0] < horizon:
                    other.popleft()
                for _, r, p, c in other:
                    rows += r
                    pad += p
                    comp += c
        self._m_goodput.labels(program=program).set(
            rows / comp if comp > 0 else 0.0)
        self._m_waste.labels(program=program).set(
            1.0 - rows / pad if pad > 0 else 0.0)

    def record_cached(self, program: str, rows: int) -> None:
        """Rows answered without touching the device (cache hits,
        coalesced waiters) — goodput the device never paid for."""
        if not self.enabled or rows <= 0:
            return
        self._m_cached.labels(program=program).inc(int(rows))

    # ── read side ─────────────────────────────────────────────────────

    def window_rates(self, program: str) -> Dict[int, Dict[str, float]]:
        """Live per-bucket window for one program:
        ``bucket → {rows, padded, compute_s, rate, fill}`` where
        ``rate`` is real rows per device-compute-second (None without
        compute time). This is what the watchdog compares against the
        pinned curve."""
        now = time.monotonic()
        horizon = now - self.config.window_s
        out: Dict[int, Dict[str, float]] = {}
        with self._lock:
            for (prog, b), dq in self._win.items():
                if prog != program:
                    continue
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                if not dq:
                    continue
                rows = sum(e[1] for e in dq)
                pad = sum(e[2] for e in dq)
                comp = sum(e[3] for e in dq)
                out[b] = {
                    "rows": rows, "padded": pad,
                    "compute_s": round(comp, 6),
                    "rate": round(rows / comp, 3) if comp > 0 else None,
                    "fill": round(rows / pad, 4) if pad > 0 else None,
                }
        return out

    def bind_device(self, device) -> None:
        """Name the device this process scores on (``cuda`` or ``cpu``);
        the identity is resolved again on next use."""
        with self._lock:
            self._device = device
            self._identity = None

    def identity(self) -> Dict[str, object]:
        with self._lock:
            if self._identity is None:
                self._identity = device_identity(self._device)
            return dict(self._identity)

    def snapshot(self) -> dict:
        """The ``/api/efficiency`` ledger section: cumulative totals +
        live windows per program."""
        programs = {}
        for prog in PROGRAMS:
            rows = self._value(self._m_rows, prog)
            padded = self._value(self._m_padded, prog)
            programs[prog] = {
                "rows": rows,
                "padded_rows": padded,
                "cached_rows": self._value(self._m_cached, prog),
                "calls": self._value(self._m_calls, prog),
                "oversized": self._value(self._m_oversized, prog),
                "device_s": round(self._value(self._m_device_s, prog), 6),
                "queue_s": round(self._value(self._m_queue_s, prog), 6),
                "waste_fraction": round(1.0 - rows / padded, 4)
                if padded > 0 else 0.0,
                "buckets": self.window_rates(prog),
            }
        return {"enabled": self.enabled,
                "window_s": self.config.window_s,
                "identity": self.identity(),
                "programs": programs}

    @staticmethod
    def _value(metric, program: str) -> float:
        for key, child in metric.items():
            if key == (program,):
                return child.value
        return 0.0


_ledger: Optional[GoodputLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> GoodputLedger:
    """The process-wide ledger every device-program call site records
    into (config read from env at first use)."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = GoodputLedger()
    return _ledger


# ── curve pinning ─────────────────────────────────────────────────────

def pin_expected_curve(config: EfficiencyConfig,
                       backend: Optional[str],
                       chips: int = 1,
                       device: Optional[str] = None) -> dict:
    """Pin the expected per-bucket throughput curve from the committed
    battery artifacts. Returns ``{"status": "pinned", "curve":
    {bucket: rows_per_s}, "chips_factor": f, ...}`` or a refusal
    (``no_artifact`` / ``unreadable`` / ``backend_mismatch`` /
    ``device_mismatch`` / ``empty``) the caller must surface loudly —
    the watchdog degrades to ledger-only on anything but ``pinned``.

    The expected rate per bucket is the MINIMUM of the artifact's
    measured execution paths (``kernel_mpreds_s`` / ``plain_mpreds_s``,
    the module docstring's record): a floor every healthy serving path
    clears, so the watchdog never pages because a slower-but-healthy
    path is serving. Foreign-backend records are refused (a CPU curve
    says nothing about the card's goodput, nor another runtime's).
    """
    path = config.kernel_artifact
    try:
        with open(path) as f:
            record = json.load(f)
    except FileNotFoundError:
        return {"status": "no_artifact", "kernel_artifact": path}
    except (OSError, ValueError) as e:
        _log.warning("efficiency_artifact_unreadable", path=path,
                     error=f"{type(e).__name__}: {e}")
        return {"status": "unreadable", "kernel_artifact": path}
    recorded = record.get("backend")
    if backend and recorded and recorded != backend:
        _log.info("efficiency_artifact_backend_mismatch", path=path,
                  recorded=recorded, runtime=backend)
        return {"status": "backend_mismatch", "kernel_artifact": path,
                "recorded_backend": recorded, "runtime_backend": backend}
    recorded_device = record.get("device")
    if device and recorded_device and recorded_device != device:
        _log.info("efficiency_artifact_device_mismatch", path=path,
                  recorded=recorded_device, runtime=device)
        return {"status": "device_mismatch", "kernel_artifact": path,
                "recorded_device": recorded_device, "runtime_device": device}
    curve: Dict[int, float] = {}
    for row in record.get("rows") or []:
        try:
            batch = int(row["batch"])
        except (KeyError, TypeError, ValueError):
            continue
        rates = []
        for k in ("kernel_mpreds_s", "plain_mpreds_s"):
            v = row.get(k)
            if isinstance(v, (int, float)) and v > 0:
                rates.append(float(v) * 1e6)
        if batch > 0 and rates:
            curve[batch] = min(rates)
    if not curve:
        return {"status": "empty", "kernel_artifact": path}
    factor, chips_note = _chips_factor(config, backend, chips)
    return {"status": "pinned", "kernel_artifact": path,
            "recorded_backend": recorded, "runtime_backend": backend,
            "curve": curve, "chips_factor": factor,
            "chips": chips, "chips_note": chips_note}


def _chips_factor(config: EfficiencyConfig, backend: Optional[str],
                  chips: int) -> Tuple[float, str]:
    """Per-replica scaling from the fleet-chips curve — the SAME
    platform-matched reader the placement planner scores with (the
    record's platform is placement's: ``gpu`` for ``cuda``). Absent or
    refused record → factor 1.0 (the 1-chip curve stands)."""
    if chips <= 1:
        return 1.0, "single_chip"
    from routest_tpu_torch.serve.fleet.placement import (_interp_rate,
                                                         measured_rates)

    platform = {"cuda": "gpu"}.get(backend, backend)
    rates = measured_rates(config.chips_artifact, platform=platform)
    if not rates or 1 not in rates:
        return 1.0, "chips_artifact_unmatched"
    return max(1.0, _interp_rate(chips, rates) / rates[1]), "scaled"


def expected_rate(pin: dict, bucket: int) -> Optional[float]:
    """Expected rows/s for a live bucket from the pinned curve: the
    nearest measured batch size (log distance — bucket ladders are
    geometric), scaled by the chips factor."""
    curve = pin.get("curve") or {}
    if not curve:
        return None
    nearest = min(curve, key=lambda b: abs(math.log(b) -
                                           math.log(max(1, bucket))))
    return curve[nearest] * float(pin.get("chips_factor") or 1.0)


# ── the watchdog ──────────────────────────────────────────────────────

CHECK_THROUGHPUT = "throughput"
CHECK_PADDING = "padding"


class EfficiencyWatchdog:
    """Continuous live-goodput vs pinned-curve comparison with
    debounced verdicts judged by a dedicated ``efficiency`` burn-rate
    engine. Armed only when a backend-matched curve pinned; anything
    else degrades to ledger-only, loudly."""

    def __init__(self, config: Optional[EfficiencyConfig] = None,
                 ledger: Optional[GoodputLedger] = None,
                 recorder=None,
                 registry: Optional[MetricsRegistry] = None,
                 replica: Optional[str] = None) -> None:
        self.config = config if config is not None \
            else load_efficiency_config()
        self.ledger = ledger if ledger is not None else get_ledger()
        self._recorder = recorder
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._m_checks = reg.counter(
            "rtpu_efficiency_checks_total",
            "Watchdog verdicts, by check (throughput / padding:<prog>) "
            "and verdict (pass / shortfall / waste).",
            ("check", "verdict"))
        self._m_armed = reg.gauge(
            "rtpu_efficiency_watchdog_armed",
            "1 when the watchdog pinned a backend-matched throughput "
            "curve and is comparing; 0 = ledger-only degradation.")
        self.replica = replica or replica_label()
        self.pin: dict = {"status": "unarmed"}
        self.slo = None
        self._bad: Dict[str, int] = {}
        self._verdicts: Dict[str, str] = {}
        self._offenders: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._ticks = 0
        self.pages = 0
        self.last_bundle: Optional[str] = None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # ── arming ────────────────────────────────────────────────────────

    def arm(self) -> bool:
        """Pin the expected curve and build the efficiency SLO engine.
        Returns True when armed; a refusal leaves the watchdog in
        ledger-only degradation with the reason in ``pin['status']``
        (surfaced by ``/api/health`` and ``/api/efficiency``)."""
        ident = self.ledger.identity()
        chips = max(1, int(ident.get("device_count") or 1))
        self.pin = pin_expected_curve(
            self.config, ident.get("backend"), chips, ident.get("device"))
        armed = self.pin.get("status") == "pinned"
        self._m_armed.set(1 if armed else 0)
        if not armed:
            _log.warning("efficiency_watchdog_degraded",
                         status=self.pin.get("status"),
                         kernel_artifact=self.config.kernel_artifact)
            return False
        from routest_tpu_torch.obs.slo import build_efficiency_engine

        self.slo = build_efficiency_engine(self.config,
                                           registry=self.registry)
        self.slo.on_page.append(self._on_efficiency_page)
        if self._recorder is None:
            from routest_tpu_torch.obs.recorder import get_recorder

            self._recorder = get_recorder()
        register = getattr(self._recorder, "register_slo_engine", None)
        if register is not None:
            register(self.slo)
        _log.info("efficiency_watchdog_armed", replica=self.replica,
                  buckets=sorted((self.pin.get("curve") or {})),
                  chips_factor=self.pin.get("chips_factor"))
        return True

    @property
    def armed(self) -> bool:
        return self.slo is not None \
            and self.pin.get("status") == "pinned"

    # ── lifecycle ─────────────────────────────────────────────────────

    def start(self) -> None:
        if not self.armed or self._thread is not None \
                or self.config.tick_s <= 0:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="efficiency-watchdog")
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self.tick()
            except Exception as e:  # loop must survive anything
                _log.error("efficiency_tick_failed",
                           error=f"{type(e).__name__}: {e}")

    # ── one comparison pass ───────────────────────────────────────────

    def tick(self) -> dict:
        """Compare live goodput vs the pinned curve + judge padding
        waste; emit debounced verdicts and tick the burn-rate engine.
        Exposed so tests and the bench drive it synchronously."""
        if not self.armed:
            return {"armed": False, "status": self.pin.get("status")}
        out: Dict[str, object] = {"armed": True}
        cfg = self.config
        # Throughput: the scoring program against the pinned kernel
        # curve (the artifact measures exactly that program).
        rates = self.ledger.window_rates("eta_score")
        evaluated = []
        for bucket, win in rates.items():
            if win["rows"] < cfg.min_rows or not win["rate"]:
                continue
            exp = expected_rate(self.pin, bucket)
            if not exp:
                continue
            evaluated.append({"bucket": bucket,
                              "measured_rows_per_s": win["rate"],
                              "expected_rows_per_s": round(exp, 3),
                              "ratio": round(win["rate"] / exp, 6),
                              "rows": win["rows"]})
        if evaluated:
            worst = min(evaluated, key=lambda e: e["ratio"])
            bad = worst["ratio"] < cfg.min_ratio
            verdict = self._debounce(
                CHECK_THROUGHPUT, bad, "shortfall",
                {"program": "eta_score", "bucket": worst["bucket"],
                 **worst})
            out[CHECK_THROUGHPUT] = {"verdict": verdict,
                                     "worst": worst,
                                     "evaluated": evaluated}
        # Padding waste: every program over its ledger window.
        for prog in PROGRAMS:
            win = self.ledger.window_rates(prog)
            pad = sum(w["padded"] for w in win.values())
            rows = sum(w["rows"] for w in win.values())
            if pad < cfg.min_rows:
                continue
            waste = 1.0 - rows / pad
            worst_b = max(win, key=lambda b: win[b]["padded"] -
                          win[b]["rows"])
            bad = waste > cfg.max_waste
            verdict = self._debounce(
                f"{CHECK_PADDING}:{prog}", bad, "waste",
                {"program": prog, "bucket": worst_b,
                 "waste_fraction": round(waste, 4),
                 "rows": rows, "padded": pad})
            out.setdefault(CHECK_PADDING, {})[prog] = {
                "verdict": verdict, "waste_fraction": round(waste, 4),
                "bucket": worst_b}
        with self._lock:
            self._ticks += 1
        if self.slo is not None:
            self.slo.tick()
        return out

    def _debounce(self, check: str, bad: bool, bad_verdict: str,
                  evidence: dict) -> str:
        """The prober's convention: ``after`` consecutive bad ticks before a
        bad verdict lands (transients — a cold start, one slow GC pass
        — are not incidents)."""
        with self._lock:
            if bad:
                self._bad[check] = self._bad.get(check, 0) + 1
            else:
                self._bad[check] = 0
            fired = self._bad[check] >= max(1, self.config.after)
            verdict = bad_verdict if fired else "pass"
            self._verdicts[check] = verdict
            if fired:
                self._offenders[check] = dict(
                    evidence, replica=self.replica,
                    consecutive_bad=self._bad[check])
        self._m_checks.labels(check=check, verdict=verdict).inc()
        if fired:
            _log.warning("efficiency_verdict", check=check,
                         verdict=verdict, **{
                             k: v for k, v in evidence.items()
                             if isinstance(v, (str, int, float))})
        return verdict

    # ── page → evidence bundle ────────────────────────────────────────

    def _on_efficiency_page(self, slo_name: str, detail: dict) -> None:
        prefix = detail.get("check") or ""
        with self._lock:
            offender = None
            for check, ev in self._offenders.items():
                if check == prefix or check.startswith(prefix + ":"):
                    offender = dict(ev, check=check)
                    break
        offender = offender or {"check": prefix, "replica": self.replica}
        live_rates = self.ledger.window_rates("eta_score")
        curve = []
        for bucket in sorted(self.pin.get("curve") or {}):
            live = live_rates.get(bucket)
            curve.append({
                "bucket": bucket,
                "expected_rows_per_s": round(
                    expected_rate(self.pin, bucket) or 0.0, 3),
                "measured_rows_per_s":
                    live["rate"] if live else None,
            })
        evidence = {
            "slo": slo_name,
            "check": offender.get("check"),
            "program": offender.get("program"),
            "replica": self.replica,
            "bucket": offender.get("bucket"),
            "offender": offender,
            "min_ratio": self.config.min_ratio,
            "max_waste": self.config.max_waste,
            "window_s": self.config.window_s,
            "expected_vs_measured": curve,
            "pin": {k: v for k, v in self.pin.items() if k != "curve"},
            "identity": self.ledger.identity(),
        }
        bundle_detail = {"slo": slo_name, "replica": self.replica,
                         "program": offender.get("program"),
                         "bucket": offender.get("bucket"), **detail}
        path = self._recorder.trigger(
            "efficiency_page", bundle_detail, force=True,
            extra_files={"efficiency_evidence.json": json.dumps(
                evidence, indent=2, default=str)})
        with self._lock:
            self.pages += 1
            self.last_bundle = path
        _log.error("efficiency_page", slo=slo_name,
                   program=offender.get("program"),
                   replica=self.replica,
                   bucket=offender.get("bucket"), bundle=path)

    # ── introspection ─────────────────────────────────────────────────

    def snapshot(self) -> dict:
        with self._lock:
            verdicts = dict(self._verdicts)
            offenders = {k: dict(v) for k, v in self._offenders.items()}
            ticks = self._ticks
            pages = self.pages
            bundle = self.last_bundle
        out = {
            "armed": self.armed,
            "status": self.pin.get("status"),
            "replica": self.replica,
            "running": self._thread is not None,
            "tick_s": self.config.tick_s,
            "min_ratio": self.config.min_ratio,
            "max_waste": self.config.max_waste,
            "after": self.config.after,
            "ticks": ticks,
            "pages": pages,
            "last_bundle": bundle,
            "verdicts": verdicts,
            "offenders": offenders,
            "pin": {k: ({str(b): r for b, r in v.items()}
                        if k == "curve" else v)
                    for k, v in self.pin.items()},
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out

    def health(self) -> dict:
        """The loud degradation surface for ``/api/health``: armed or
        WHY not."""
        return {"ledger": self.ledger.enabled,
                "watchdog": "armed" if self.armed else "degraded",
                "status": self.pin.get("status"),
                "pages": self.pages}
