"""Deterministic fault injection at named IO boundaries.

Chaos-engineering practice (Basiri et al., IEEE Software 2016) says
resilience untested by fault injection is resilience assumed, not had.
This package is the test rig: every IO boundary in the serving stack
calls ``inject("<point>")`` at its entry — a no-op in production, a
seeded fault generator when ``RTPU_CHAOS_SPEC`` names that point.

Registered fault points (see docs/ROBUSTNESS.md for the full table):

- ``store.http``       — every store backend call (inside the retry loop,
  so each attempt can fail independently)
- ``netbus.publish`` / ``netbus.subscribe`` — broker socket operations
- ``device.compute``   — the batcher's device scoring call
- ``gateway.forward`` and ``gateway.forward.<replica-id>`` — each
  proxied upstream exchange (per-replica points let a spec slow or kill
  exactly one replica's hops)
- ``replica.kill``     — actuated manually via
  ``ReplicaSupervisor.kill_replica`` (a process kill cannot be a
  probability draw inside the victim); recorded here for one unified
  injection ledger
- ``replica.boot`` and ``replica.boot.<version>`` — supervisor spawn:
  an ``error``/``drop`` substitutes an argv that exits immediately (the
  bad-deploy crash loop, deterministic), ``latency`` delays the spawn
  (slow boot); the per-version point lets a spec doom exactly one
  rollout's spawns
- ``model.load``       — serving-artifact load (startup AND hot-swap
  replacement builds): an injected fault degrades exactly like a
  corrupt file — load_error set, the old model keeps serving

Four fault kinds per point, each with its own probability:

- ``latency`` — sleep ``arg`` milliseconds, then continue (the call
  still happens; stacks with error/drop)
- ``error``   — raise :class:`ChaosError` (application-level failure:
  an HTTP 5xx, a dead device)
- ``drop``    — raise :class:`ChaosConnectionDrop` (a
  ``ConnectionError`` subclass, so existing transport-failure handling
  — gateway retry, breaker charging, store journaling — takes over)
- ``skew``    — return ``arg`` as a perturbation magnitude the CALL
  SITE applies to its own result (``inject`` returns the summed fired
  magnitudes; sites that ignore the return are unaffected). This is
  the silent-wrongness fault: at ``device.compute`` the batcher adds
  the magnitude (output minutes) to every scored row, so the replica
  keeps answering 200s — confidently, and wrong. Nothing inside the
  serving path can see it; only the blackbox prober's oracle
  comparison (docs/OBSERVABILITY.md "Synthetic probing") does.

Spec grammar (``RTPU_CHAOS_SPEC``)::

    spec   ::= point ( ";" point )*
    point  ::= name ":" fault ( "," fault )*
    fault  ::= kind "=" prob [ "/" arg_ms ] [ "@" limit ]

    e.g.  store.http:error=1.0@40
          device.compute:latency=0.3/250,error=0.05
          gateway.forward.r1:latency=1.0/300

``@limit`` bounds how many times a rule fires — the deterministic way
to model an outage that ENDS (first N calls fail, then the backend is
healthy again). Draws come from one ``random.Random`` per point, seeded
by ``RTPU_CHAOS_SEED`` xor the point name, so a given (spec, seed)
replays the exact same failure sequence every run — the property the
regression tests pin.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import zlib
from typing import Dict, List, Mapping, Optional

from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.chaos")

KINDS = ("latency", "error", "drop", "skew")


class ChaosError(RuntimeError):
    """Injected application-level failure (a 5xx, a dead device)."""


class ChaosConnectionDrop(ChaosError, ConnectionError):
    """Injected transport-level drop. Subclasses ``ConnectionError``
    (hence ``OSError``) so every existing transport-failure path —
    gateway retry/breaker, store journaling, netbus buffering — handles
    it exactly like a real dead socket."""


@dataclasses.dataclass
class FaultRule:
    """One (kind, probability) rule at a point. ``arg_ms`` is the
    latency to add (latency kind only); ``limit`` caps total fires
    (None = unbounded)."""

    kind: str
    prob: float
    arg_ms: float = 100.0
    limit: Optional[int] = None
    fired: int = 0

    def exhausted(self) -> bool:
        return self.limit is not None and self.fired >= self.limit


def parse_spec(spec: str) -> Dict[str, List[FaultRule]]:
    """Spec string → {point: [rules]}. Malformed tokens are skipped
    with a logged warning — a typo in an ops knob must degrade to
    "that fault doesn't fire", never crash the server it configures."""
    points: Dict[str, List[FaultRule]] = {}
    for point_tok in (spec or "").split(";"):
        point_tok = point_tok.strip()
        if not point_tok:
            continue
        name, sep, faults = point_tok.partition(":")
        name = name.strip()
        if not sep or not name:
            _log.warning("chaos_spec_malformed", token=point_tok)
            continue
        rules: List[FaultRule] = []
        for fault_tok in faults.split(","):
            fault_tok = fault_tok.strip()
            if not fault_tok:
                continue
            rule = _parse_fault(fault_tok)
            if rule is None:
                _log.warning("chaos_spec_malformed", point=name,
                             token=fault_tok)
                continue
            rules.append(rule)
        if rules:
            points.setdefault(name, []).extend(rules)
    return points


def _parse_fault(tok: str) -> Optional[FaultRule]:
    kind, sep, rest = tok.partition("=")
    kind = kind.strip()
    if not sep or kind not in KINDS:
        return None
    limit: Optional[int] = None
    if "@" in rest:
        rest, _, limit_s = rest.partition("@")
        try:
            limit = int(limit_s)
        except ValueError:
            return None
        if limit < 0:
            return None
    arg_ms = 100.0
    if "/" in rest:
        rest, _, arg_s = rest.partition("/")
        try:
            arg_ms = float(arg_s)
        except ValueError:
            return None
        if not (arg_ms >= 0):  # NaN-proof
            return None
    try:
        prob = float(rest)
    except ValueError:
        return None
    if not (0.0 <= prob <= 1.0):  # NaN-proof
        return None
    return FaultRule(kind=kind, prob=prob, arg_ms=arg_ms, limit=limit)


class FaultPoint:
    """One named injection site: its rules plus a dedicated seeded RNG.

    The RNG is per-point (seed xor crc32(name)) so adding a point to a
    spec never perturbs another point's failure sequence — each point's
    outcome stream depends only on (seed, name, call index)."""

    def __init__(self, name: str, rules: List[FaultRule], seed: int) -> None:
        self.name = name
        self.rules = rules
        self.calls = 0
        self._rng = random.Random((seed << 32) ^ zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def fire(self) -> float:
        """One injection decision: may sleep, may raise; returns the
        summed ``skew`` magnitudes that fired (0.0 normally) for the
        call site to apply to its own result. Decisions are made under
        the lock (one RNG draw per rule per call, in rule order) so
        the outcome SEQUENCE is deterministic; the sleep and raise
        happen outside it."""
        delay_ms = 0.0
        skew = 0.0
        exc: Optional[ChaosError] = None
        fired = []
        first_fired = []
        with self._lock:
            self.calls += 1
            for rule in self.rules:
                if rule.exhausted():
                    continue
                if self._rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                fired.append(rule.kind)
                if rule.fired == 1:
                    first_fired.append(rule.kind)
                if rule.kind == "latency":
                    delay_ms += rule.arg_ms
                elif rule.kind == "skew":
                    skew += rule.arg_ms
                elif exc is None:
                    exc = (ChaosError(f"injected error at {self.name}")
                           if rule.kind == "error" else
                           ChaosConnectionDrop(
                               f"injected connection drop at {self.name}"))
        for kind in fired:
            _INJECTIONS.labels(point=self.name, kind=kind).inc()
        # The change ledger records only each rule's FIRST fire: a
        # hot-path point at prob 1.0 is one state change (the fault
        # became live), not thousands of ledger entries.
        for kind in first_fired:
            from routest_tpu_torch.obs.ledger import record_change

            record_change("chaos.fire",
                          detail={"point": self.name, "kind": kind})
        if delay_ms:
            time.sleep(delay_ms / 1000.0)
        if exc is not None:
            raise exc
        return skew


_INJECTIONS = get_registry().counter(
    "rtpu_chaos_injections_total",
    "Faults injected, by point and kind.", ("point", "kind"))


class ChaosEngine:
    """All fault points for one (spec, seed). ``inject`` is the hot-path
    entry: a dict miss + enabled check when the point isn't configured,
    so production cost is negligible."""

    def __init__(self, spec: str = "", seed: int = 0,
                 enabled: bool = True) -> None:
        self.spec = spec or ""
        self.seed = seed
        self.enabled = enabled and bool(self.spec.strip())
        self._points = {name: FaultPoint(name, rules, seed)
                        for name, rules in parse_spec(self.spec).items()}
        if self.enabled:
            from routest_tpu_torch.obs.ledger import record_change

            record_change("chaos.arm",
                          detail={"spec": self.spec, "seed": seed,
                                  "points": sorted(self._points)})
            _log.warning("chaos_enabled", seed=seed,
                         points=sorted(self._points))

    def inject(self, name: str) -> float:
        """→ the summed ``skew`` magnitudes that fired (0.0 when the
        point is unconfigured or nothing fired); may sleep or raise
        for the other kinds. Call sites that ignore the return keep
        their historical latency/error/drop semantics untouched."""
        if not self.enabled:
            return 0.0
        point = self._points.get(name)
        if point is None:
            return 0.0
        return point.fire()

    def record(self, name: str, kind: str) -> None:
        """Ledger entry for a fault actuated OUTSIDE the engine (e.g.
        ``replica.kill`` — the supervisor kills the process; the engine
        only counts it). Externally-actuated faults are rare and each
        IS a state change, so every one lands in the change ledger."""
        _INJECTIONS.labels(point=name, kind=kind).inc()
        from routest_tpu_torch.obs.ledger import record_change

        record_change("chaos.fire",
                      detail={"point": name, "kind": kind,
                              "actuated": "external"})

    def snapshot(self) -> dict:
        """Per-point injection counts (for /api/metrics debugging and
        the chaos bench artifact)."""
        return {
            name: {
                "calls": p.calls,
                "rules": [{"kind": r.kind, "prob": r.prob,
                           "arg_ms": r.arg_ms, "limit": r.limit,
                           "fired": r.fired} for r in p.rules],
            }
            for name, p in sorted(self._points.items())
        }


_engine: Optional[ChaosEngine] = None
_engine_lock = threading.Lock()


def get_chaos() -> ChaosEngine:
    """The process-wide engine, built lazily from ``RTPU_CHAOS_*`` env
    (disabled when no spec is set)."""
    global _engine
    if _engine is None:
        with _engine_lock:
            if _engine is None:
                from routest_tpu_torch.core.config import load_chaos_config

                cfg = load_chaos_config()
                _engine = ChaosEngine(spec=cfg.spec, seed=cfg.seed,
                                      enabled=cfg.enabled)
    return _engine


def configure(engine: Optional[ChaosEngine]) -> None:
    """Install an engine explicitly (tests, the chaos bench); ``None``
    resets to lazy env-driven construction."""
    global _engine
    with _engine_lock:
        _engine = engine


def inject(name: str) -> float:
    """Module-level convenience: ``chaos.inject("store.http")``.
    Returns the fired ``skew`` magnitude (0.0 normally) — only sites
    that can meaningfully perturb their result read it."""
    return get_chaos().inject(name)


def current_engine() -> Optional[ChaosEngine]:
    """The installed engine when injection is LIVE, else None — without
    building one from env (readers like the flight recorder stamp chaos
    state onto every request record and must not pay a config parse
    when chaos was never configured)."""
    engine = _engine
    return engine if engine is not None and engine.enabled else None
