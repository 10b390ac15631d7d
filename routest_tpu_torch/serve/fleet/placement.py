"""Topology-aware fleet placement: device inventory → replica slices.

The counterpart of ``routest_tpu/serve/fleet/placement.py``: the same
layouts, specs, measured-record reader and plans, over the port's
devices and knobs. It maps "what does this host have" to "what do we
boot":

- :func:`detect_inventory` — how many devices, on what platform. The
  operator override (``RTPU_FLEET_CHIPS``, with ``RTPU_FLEET_PLATFORM``)
  wins; ``ROUTEST_DEVICE=cpu`` plans one CPU host next; otherwise the
  CUDA devices are counted (``torch.cuda.device_count``, which creates
  no CUDA context in the fleet parent). A host with no card where the
  CPU was not asked for raises: the fleet never plans CPU replicas
  quietly.
- :func:`candidate_layouts` — the ways ``chips`` devices can be carved
  into replica slices (8 → 8×1, 4×2, 2×4, 1×8; odd counts get a mixed
  remainder slice: 6 → …, 4+2; every device is owned by exactly one
  slice).
- :func:`plan_placement` — pick one. ``RTPU_FLEET_PLACEMENT`` forces
  (``replica`` = all 1-chip, ``mesh`` = one big slice, ``NxK`` or a
  ``4,2,1`` list = exactly that); ``auto`` compares candidate layouts
  by predicted throughput — from the *measured* per-chip curve in the
  port's record (``artifacts/fleet_chips_cuda.json``, refused when it
  was measured on another platform) when one exists, else from a simple
  mesh-efficiency model (``RTPU_FLEET_PLACEMENT_EFF`` per added chip).
  On a CPU host auto never multiplies devices: plain 1-chip replicas.

Each slice carries the per-replica env overlay that pins its devices
(``CUDA_VISIBLE_DEVICES`` on a card, ``ROUTEST_DEVICE=cpu`` on the CPU),
so a monitor respawn or a rolling restart reuses the SAME overlay and a
replica never wanders onto another replica's device. A slice of more
than one device sets ``ROUTEST_MESH=1``: the replica splits its
batches over the slice's cards (``serve/__main__.py``). Capacity
units (predicted throughput normalized to one chip) ride along to the
gateway's weighted router and the autoscaler's pressure signals.

On one card, ``auto`` plans one replica whatever
``RTPU_FLEET_REPLICAS`` says; more replicas on the same card come from
growth (:meth:`PlacementPlan.growth_slice`, round-robin over the
inventory).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from routest_tpu_torch.core.config import FLEET_CHIPS_RECORD
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest_tpu_torch.fleet.placement")

# The env key every slice stamps: replicas surface it in
# ``/api/health`` ``checks.engine.mesh.placement`` so an operator can
# see which slice a process believes it owns.
PLACEMENT_LABEL_ENV = "RTPU_FLEET_PLACEMENT_LABEL"

# The platforms the port places replicas on.
PLATFORMS = ("gpu", "cpu")


@dataclasses.dataclass(frozen=True)
class DeviceInventory:
    """What the host has: ``chips`` devices on ``platform`` (``gpu`` |
    ``cpu``), and where the answer came from (``env`` | ``default`` |
    ``cuda``)."""

    platform: str
    chips: int
    source: str


def detect_inventory(
        env: Optional[Mapping[str, str]] = None) -> DeviceInventory:
    """Enumerate local devices. ``RTPU_FLEET_CHIPS`` answers first
    (platform ``RTPU_FLEET_PLATFORM``, else ``cpu`` under
    ``ROUTEST_DEVICE=cpu`` and ``gpu`` otherwise); ``ROUTEST_DEVICE=cpu``
    next (one CPU host); then the CUDA device count. No card and no CPU
    asked for raises — the fleet never falls back to CPU replicas."""
    env = env if env is not None else os.environ
    cpu_asked = env.get("ROUTEST_DEVICE") == "cpu"
    raw = env.get("RTPU_FLEET_CHIPS")
    if raw:
        try:
            chips = int(raw)
        except ValueError:
            chips = 0
            _log.warning("bad_chips_override", value=raw)
        if chips > 0:
            platform = env.get("RTPU_FLEET_PLATFORM") or (
                "cpu" if cpu_asked else "gpu")
            if platform not in PLATFORMS:
                raise ValueError(
                    f"RTPU_FLEET_PLATFORM={platform!r}: the port places "
                    f"replicas on {' or '.join(PLATFORMS)}")
            return DeviceInventory(platform, chips, "env")
    if cpu_asked:
        return DeviceInventory("cpu", 1, "default")
    import torch

    chips = torch.cuda.device_count()
    if chips < 1:
        raise RuntimeError(
            "fleet placement: no CUDA device and no CPU asked for "
            "(set ROUTEST_DEVICE=cpu to run the fleet on the CPU)")
    return DeviceInventory("gpu", chips, "cuda")


@dataclasses.dataclass(frozen=True)
class ReplicaSlice:
    """One replica's share of the host: ``chips`` devices (by id), the
    env overlay that pins them, and the capacity units (predicted
    preds/s normalized to a 1-chip replica) the gateway weights by."""

    chips: int
    device_ids: Tuple[int, ...]
    label: str
    env: Mapping[str, str]
    capacity: float

    def as_dict(self) -> dict:
        return {"chips": self.chips, "device_ids": list(self.device_ids),
                "label": self.label, "capacity": round(self.capacity, 3),
                "env": dict(self.env)}


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    platform: str
    total_chips: int
    layout: str                       # "8x1" | "2x4" | "4+2" | "host"
    slices: Tuple[ReplicaSlice, ...]
    source: str                       # forced | auto_measured | auto_model…
    predicted_rate: float             # capacity units summed

    @property
    def capacity_units(self) -> float:
        return sum(s.capacity for s in self.slices)

    def growth_slice(self, index: int) -> ReplicaSlice:
        """The slice an autoscaler scale-up should spawn: the plan's
        repeating unit (modal chip count), pinned round-robin over the
        inventory — growth past the physical chip count oversubscribes
        devices rather than reverting to an unpinned 1-chip replica."""
        counts = [s.chips for s in self.slices] or [1]
        k = max(set(counts), key=counts.count)
        start = (index * k) % max(1, self.total_chips)
        ids = tuple((start + j) % max(1, self.total_chips)
                    for j in range(k))
        label = f"g{index}:{k}chip"
        cap = next((s.capacity for s in self.slices if s.chips == k),
                   float(k))
        return ReplicaSlice(k, ids, label,
                            slice_env(self.platform, k, ids, label), cap)

    def as_dict(self) -> dict:
        return {"platform": self.platform, "total_chips": self.total_chips,
                "layout": self.layout, "source": self.source,
                "predicted_rate": round(self.predicted_rate, 3),
                "capacity_units": round(self.capacity_units, 3),
                "slices": [s.as_dict() for s in self.slices]}


def candidate_layouts(chips: int) -> List[Tuple[int, ...]]:
    """Every way to carve ``chips`` devices into slices of one uniform
    size (plus a remainder slice when the size does not divide): each
    layout is a tuple of per-slice chip counts covering every chip
    exactly once. 8 → (1,)*8, (2,2,2,2), (4,4), (8,); 6 includes
    (4, 2); 3 → (1,1,1), (2,1), (3,)."""
    chips = max(1, int(chips))
    seen = set()
    out: List[Tuple[int, ...]] = []
    for per in range(1, chips + 1):
        n, rem = divmod(chips, per)
        layout = tuple([per] * n + ([rem] if rem else []))
        if layout not in seen:
            seen.add(layout)
            out.append(layout)
    return out


def slice_env(platform: str, chips: int, device_ids: Sequence[int],
              label: str) -> Dict[str, str]:
    """The per-replica env overlay that makes a worker own exactly its
    slice: GPU slices mask with ``CUDA_VISIBLE_DEVICES``, CPU slices
    serve with ``ROUTEST_DEVICE=cpu``. Multi-device slices set
    ``ROUTEST_MESH=1`` with ``RTPU_MESH_DATA`` = the slice width, as the
    JAX planner does: the replica serves a mesh over its slice."""
    if platform not in PLATFORMS:
        raise ValueError(f"unknown placement platform {platform!r}")
    env: Dict[str, str] = {PLACEMENT_LABEL_ENV: label,
                           "RTPU_FLEET_SLICE_CHIPS": str(chips)}
    if platform == "cpu":
        env["ROUTEST_DEVICE"] = "cpu"
    else:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in device_ids)
    env["RTPU_MESH_DATA"] = str(chips)
    env["ROUTEST_MESH"] = "1" if chips > 1 else "0"
    return env


# ── throughput models (what the auto comparison scores with) ─────────

def model_rate(chips: int, mesh_eff: float) -> float:
    """Predicted per-replica rate in 1-chip units under the built-in
    model: each chip added to a mesh keeps ``mesh_eff`` of its ideal
    contribution (ICI collectives + pad waste grow with the slice), so
    a k-chip replica delivers ``k·mesh_eff^(k-1)`` units. With eff < 1
    more 1-chip replicas always win on modeled throughput — a bigger
    slice must EARN its place through the measured curve (or an
    explicit ``RTPU_FLEET_PLACEMENT`` override)."""
    return chips * (mesh_eff ** max(0, chips - 1))


def measured_rates(record_path: str,
                   platform: Optional[str] = None
                   ) -> Optional[Dict[int, float]]:
    """chips → preds/s from a recorded fleet-chips curve (``host.backend``
    names the platform it was measured on, ``curve`` its rows), or None
    when absent/unreadable (LOUDLY: a corrupt record must not silently
    change placement). With ``platform``, a record measured on a
    DIFFERENT platform is refused — the JAX package's CPU-virtual curve
    says nothing about scaling on the card, so placement falls back to
    the model until a record is measured there."""
    try:
        with open(record_path) as f:
            record = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        _log.warning("placement_record_unreadable", path=record_path,
                     error=f"{type(e).__name__}: {e}")
        return None
    recorded_backend = (record.get("host") or {}).get("backend")
    if platform and recorded_backend and recorded_backend != platform:
        _log.info("placement_record_backend_mismatch",
                  path=record_path, recorded=recorded_backend,
                  platform=platform)
        return None
    rates: Dict[int, float] = {}
    for row in record.get("curve") or []:
        try:
            chips, rate = int(row["chips"]), float(row["preds_per_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if chips > 0 and rate > 0:
            rates[chips] = rate
    return rates or None


def _interp_rate(chips: int, rates: Dict[int, float]) -> float:
    """Rate for a slice width the record didn't measure: linear in
    chips between the nearest measured widths (flat past the ends)."""
    if chips in rates:
        return rates[chips]
    ks = sorted(rates)
    lo = max((k for k in ks if k < chips), default=None)
    hi = min((k for k in ks if k > chips), default=None)
    if lo is None:
        return rates[hi] * chips / hi
    if hi is None:
        return rates[lo] * chips / lo
    frac = (chips - lo) / (hi - lo)
    return rates[lo] + frac * (rates[hi] - rates[lo])


def parse_layout_spec(spec: str, chips: int) -> Optional[Tuple[int, ...]]:
    """``"2x4"`` → (4, 4); ``"4,2,1"`` → (4, 2, 1). None when the spec
    is not a layout (``auto``/``replica``/``mesh`` handled upstream).
    A spec that names more chips than the inventory is refused loudly —
    an operator typo must not oversubscribe silently."""
    spec = spec.strip().lower()
    m = re.fullmatch(r"(\d+)x(\d+)", spec)
    if m:
        n, per = int(m.group(1)), int(m.group(2))
        layout: Tuple[int, ...] = tuple([per] * n)
    elif re.fullmatch(r"\d+(,\d+)*", spec):
        layout = tuple(int(v) for v in spec.split(","))
    else:
        return None
    if not layout or any(v <= 0 for v in layout):
        return None
    if sum(layout) > chips:
        raise ValueError(
            f"placement spec {spec!r} names {sum(layout)} chips; "
            f"host has {chips}")
    return layout


def plan_placement(inventory: DeviceInventory, *,
                   replicas: Optional[int] = None,
                   spec: str = "auto",
                   mesh_eff: float = 0.92,
                   record_path: str = FLEET_CHIPS_RECORD,
                   ) -> PlacementPlan:
    """Turn an inventory into a placement plan.

    ``replicas`` caps the slice count for forced-``replica``/CPU-auto
    plans (the ``RTPU_FLEET_REPLICAS`` contract: an operator who asked
    for 2 replicas gets 2). ``spec`` is ``RTPU_FLEET_PLACEMENT``:
    ``auto`` (compare layouts), ``replica``, ``mesh``, ``NxK``, or an
    explicit comma list. ``mesh_eff``/``record_path`` feed the auto
    comparison (measured beats modeled)."""
    chips = max(1, inventory.chips)
    platform = inventory.platform
    spec = (spec or "auto").strip().lower()

    def build(layout: Tuple[int, ...], source: str,
              rate_fn) -> PlacementPlan:
        slices: List[ReplicaSlice] = []
        next_id = 0
        base_rate = rate_fn(1)
        for i, k in enumerate(layout):
            ids = tuple(range(next_id, next_id + k))
            next_id += k
            label = f"s{i}:{k}chip"
            cap = rate_fn(k) / base_rate if base_rate > 0 else float(k)
            slices.append(ReplicaSlice(
                k, ids, label, slice_env(platform, k, ids, label), cap))
        if len(set(layout)) == 1:
            name = f"{len(layout)}x{layout[0]}"
        else:
            name = "+".join(str(k) for k in layout)
        return PlacementPlan(platform, chips, name, tuple(slices),
                             source, sum(s.capacity for s in slices))

    rates = measured_rates(record_path, platform) if record_path else None

    def rate_fn(k: int) -> float:
        if rates:
            return _interp_rate(k, rates)
        return model_rate(k, mesh_eff)

    explicit = parse_layout_spec(spec, chips) if spec not in (
        "auto", "replica", "mesh") else None
    if explicit is not None:
        return build(explicit, "spec", rate_fn)
    if spec == "replica":
        n = replicas if replicas else chips
        return build(tuple([1] * max(1, n)), "replica", rate_fn)
    if spec == "mesh":
        return build((chips,), "mesh", rate_fn)
    if spec != "auto":
        raise ValueError(f"unknown RTPU_FLEET_PLACEMENT {spec!r} "
                         "(auto | replica | mesh | NxK | k,k,…)")

    # auto. CPU replicas time-share one host: never multiply devices —
    # plain 1-chip replicas whose overlay only pins the CPU.
    if platform == "cpu":
        n = max(1, replicas if replicas else 1)
        slices = tuple(
            ReplicaSlice(1, (), f"s{i}:host",
                         {PLACEMENT_LABEL_ENV: f"s{i}:host",
                          "ROUTEST_DEVICE": "cpu"}, 1.0)
            for i in range(n))
        return PlacementPlan(platform, chips, "host", slices,
                             "auto_host", float(n))
    # ``replicas`` caps the slice count (the RTPU_FLEET_REPLICAS
    # contract: an operator who asked for N processes gets at most N —
    # the planner then spends the chips WITHIN that, e.g. 8 chips at
    # replicas=2 compares 2×4 against 1×8, not 8×1).
    layouts = [lo for lo in candidate_layouts(chips)
               if not replicas or len(lo) <= replicas]
    if not layouts:
        layouts = [tuple([chips])]
    best = None
    for layout in layouts:
        plan = build(layout,
                     "auto_measured" if rates else "auto_model", rate_fn)
        # Higher predicted rate wins; ties prefer MORE replicas
        # (process isolation: one crash takes out one batcher).
        key = (plan.predicted_rate, len(plan.slices))
        if best is None or key > best[0]:
            best = (key, plan)
    plan = best[1]
    _log.info("placement_planned", platform=platform, chips=chips,
              layout=plan.layout, source=plan.source,
              predicted_rate=round(plan.predicted_rate, 2))
    return plan


def plan_from_env(env: Optional[Mapping[str, str]] = None,
                  replicas: Optional[int] = None) -> PlacementPlan:
    """The fleet entry point's one-call path: detect + plan from the
    ``RTPU_FLEET_PLACEMENT*`` env knobs."""
    env = env if env is not None else os.environ

    def _num(name: str, default: float) -> float:
        raw = env.get(name)
        if not raw:
            return default
        try:
            return float(raw)
        except ValueError:
            _log.warning("bad_placement_knob", name=name, value=raw)
            return default

    inventory = detect_inventory(env)
    return plan_placement(
        inventory,
        replicas=replicas,
        spec=env.get("RTPU_FLEET_PLACEMENT", "auto"),
        mesh_eff=_num("RTPU_FLEET_PLACEMENT_EFF", 0.92),
        record_path=env.get("RTPU_FLEET_PLACEMENT_RECORD",
                            FLEET_CHIPS_RECORD))
