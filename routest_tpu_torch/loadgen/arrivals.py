"""Arrival processes: when an open-loop generator fires each request.

The defining property of an open-loop generator is that send times are
decided by an *arrival schedule*, never by the system under test — a
slow server does not slow the offered load down, it builds a backlog
(exactly what real users do). This module produces those schedules as
plain arrays of second offsets, fully determined by ``(curve, duration,
seed)``: the same inputs reproduce the same schedule bit-for-bit, which
is what lets a bench claim "the same offered load, system A vs B".

Two generators over one rate-curve abstraction:

- :func:`poisson_schedule` — an inhomogeneous Poisson process via
  Lewis–Shedler thinning (exponential gaps at the curve's peak rate,
  accepted with probability ``rate(t) / peak``). Memoryless arrivals
  are the standard open-loop model (MLPerf Inference's LoadGen server
  scenario) because independent users genuinely are memoryless.
- :func:`paced_schedule` — deterministic arrivals at the instantaneous
  rate (next gap = ``1 / rate(t)``): no sampling noise, useful when a
  test wants the rate curve itself to be the only variable.

Rate curves are closed over plain floats so a schedule for a 2-hour
diurnal cycle costs an array, not a simulation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RateCurve:
    """Offered load as a function of time: ``rate(t)`` in requests/s
    for ``t`` seconds after the run starts, with ``peak`` an upper
    bound used by the thinning sampler. Build via the constructors
    below; ``spec`` round-trips into reports so an artifact records
    exactly what was offered."""

    rate: Callable[[float], float]
    peak: float
    spec: dict

    def mean_rate(self, duration_s: float, samples: int = 1000) -> float:
        ts = np.linspace(0.0, duration_s, samples, endpoint=False)
        return float(np.mean([self.rate(float(t)) for t in ts]))

    # ── constructors ──────────────────────────────────────────────────

    @staticmethod
    def constant(rate: float) -> "RateCurve":
        if rate <= 0:
            raise ValueError("rate must be positive")
        return RateCurve(lambda t: rate, rate,
                         {"kind": "constant", "rate": rate})

    @staticmethod
    def diurnal(base: float, peak: float, period_s: float,
                phase_s: float = 0.0) -> "RateCurve":
        """A day compressed into ``period_s``: sinusoid from ``base``
        (trough) to ``peak``, trough at ``t = phase_s``. The shape every
        consumer-facing serving stack sees, squeezed so a bench can
        replay "a day" in a minute."""
        if not (0 < base <= peak):
            raise ValueError("need 0 < base <= peak")
        amp = (peak - base) / 2.0
        mid = base + amp

        def rate(t: float) -> float:
            return mid - amp * math.cos(2 * math.pi * (t - phase_s)
                                        / period_s)

        return RateCurve(rate, peak, {"kind": "diurnal", "base": base,
                                      "peak": peak, "period_s": period_s,
                                      "phase_s": phase_s})

    @staticmethod
    def flash_crowd(base: float, multiplier: float, at_s: float,
                    duration_s: float) -> "RateCurve":
        """Step function: ``base`` rps, then ``base * multiplier`` for
        ``[at_s, at_s + duration_s)``, then ``base`` again — the 10×
        spike scenario."""
        if base <= 0 or multiplier < 1:
            raise ValueError("need base > 0 and multiplier >= 1")
        spike = base * multiplier

        def rate(t: float) -> float:
            return spike if at_s <= t < at_s + duration_s else base

        return RateCurve(rate, spike, {
            "kind": "flash_crowd", "base": base, "multiplier": multiplier,
            "at_s": at_s, "duration_s": duration_s})

    @staticmethod
    def steps(points: Sequence[Tuple[float, float]]) -> "RateCurve":
        """Piecewise-constant: ``[(t_from, rate), …]`` sorted by time;
        the first entry must start at 0."""
        pts = sorted((float(t), float(r)) for t, r in points)
        if not pts or pts[0][0] != 0.0:
            raise ValueError("steps must start at t=0")
        if any(r <= 0 for _, r in pts):
            raise ValueError("rates must be positive")
        times = [t for t, _ in pts]
        rates = [r for _, r in pts]

        def rate(t: float) -> float:
            i = 0
            for j, t0 in enumerate(times):
                if t >= t0:
                    i = j
            return rates[i]

        return RateCurve(rate, max(rates),
                         {"kind": "steps", "points": pts})


def poisson_schedule(curve: RateCurve, duration_s: float,
                     seed: int) -> np.ndarray:
    """Inhomogeneous Poisson arrival offsets in ``[0, duration_s)`` via
    thinning. Deterministic in ``(curve, duration_s, seed)``."""
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    peak = curve.peak
    while True:
        # Exponential gap at the peak rate; thin to the local rate.
        t += float(rng.exponential(1.0 / peak))
        if t >= duration_s:
            break
        if rng.random() <= curve.rate(t) / peak:
            out.append(t)
    return np.asarray(out, dtype=np.float64)


def paced_schedule(curve: RateCurve, duration_s: float) -> np.ndarray:
    """Deterministic arrivals: each gap is ``1 / rate(t)`` at the
    current instant. No RNG at all — the curve IS the schedule."""
    out: List[float] = []
    t = 0.0
    # The epsilon keeps accumulated float error from minting one extra
    # arrival at t ≈ duration (50 arrivals for 10 rps × 5 s, exactly).
    while t < duration_s - 1e-9:
        out.append(t)
        t += 1.0 / curve.rate(t)
    return np.asarray(out, dtype=np.float64)


def with_burst(offsets: np.ndarray, at_s: float, n: int) -> np.ndarray:
    """Thundering herd: ``n`` extra arrivals at exactly ``at_s`` (cache
    expiry, push notification, synchronized retry storm). The base
    schedule stays untouched; the burst is inserted in time order."""
    if n <= 0:
        return offsets
    merged = np.concatenate([offsets, np.full(n, float(at_s))])
    merged.sort(kind="stable")
    return merged
