"""Road-graph shortest-path routing on the device.

The counterpart of ``routest_tpu/optimize/road_router.py``'s flat
router: legs are true shortest paths over a street network, with
geometry that follows the streets and durations from per-edge travel
times (free-flow physics, or the road GNN when its artifact was trained
on this graph, re-priced in route context by the route transformer).

- **Solve** (device): below ``hier_min_nodes()`` nodes a batched
  multi-source Bellman-Ford over the receiver-sorted edges
  (``optimize/hierarchy.py``), ``_K_SWEEPS`` sweeps per host check,
  bounded by ``4√N + 8`` sweeps and re-run with the exact ``N`` bound if
  that is exhausted, then tight-edge predecessor recovery; at or above
  it the partition overlay (``HierarchicalIndex``, loaded from its cache
  file or built at construction) and its fused solve. Distances and
  predecessors equal the JAX package's bit for bit on either path.
- **Duration table** (device): pointer doubling over the predecessor
  trees (``_time_table``), for matrix responses; the same machinery
  recovers leg meters along time-shortest trees (``_meters_along``).
- **Live traffic**: ``install_live_metric`` floors and uploads a blended
  per-edge travel-time metric, re-prices the overlay against it
  (``HierarchicalIndex.customize``) on the router's device, and flips
  ``_live`` in one assignment. Requests snapshot ``_live`` once per
  batch: with the route metric armed they solve over travel time (the
  customized overlay, or the flat sweep on the time weights) and price
  legs ``live+<model>``.
- **Host**: component bridging (union-find), snapping (a haversine
  table), predecessor walks and polylines stay in numpy, as in the JAX
  package.

Every tensor lives on the router's ``device`` (``cuda`` unless the
caller asks for the CPU; asking for the card without one raises).
Learned pricers hot-reload: each request batch stats their artifact
files, and a changed road-GNN file goes live only after it prices every
edge finitely and, when a GNN already serves, within
``RTPU_ROAD_SWAP_MAX_DIV`` edge-seconds (median) of it; a deleted file
stops GNN pricing. Each swap bumps the model generation that keys the
route cache. Not ported yet: the AOT solve buckets (for the distance
and the live overlay alike), the overlay gauges, the trace spans and
the efficiency ledger.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from routest_tpu_torch.core.config import resolve_device
from routest_tpu_torch.core.dtypes import backend_compute_policy
from routest_tpu_torch.data.road_graph import (_CLASS_SPEED_MPS,
                                               generate_road_graph,
                                               haversine_np)
from routest_tpu_torch.live import set_metric_epoch
from routest_tpu_torch.obs import get_registry
from routest_tpu_torch.obs.efficiency import get_ledger
from routest_tpu_torch.obs.ledger import record_change
from routest_tpu_torch.obs.trace import trace_span
from routest_tpu_torch.models.gnn import edge_feature_array
from routest_tpu_torch.optimize.hierarchy import (_CACHE_VERSION, _INF,
                                                  HierarchicalIndex,
                                                  hier_cache_path,
                                                  hier_min_nodes, relax_from,
                                                  tight_pred)
from routest_tpu_torch.optimize.route_cache import (RouteCache,
                                                    route_cache_config)
from routest_tpu_torch.serve.deadline import current_deadline
from routest_tpu_torch.train.checkpoint import (default_gnn_path,
                                                default_transformer_path,
                                                graph_fingerprint, load_gnn,
                                                load_transformer)
from routest_tpu_torch.utils.logging import get_logger

_log = get_logger("routest.road")

_m_road_swaps = get_registry().counter(
    "rtpu_road_model_swaps_total",
    "Road-GNN hot-swap attempts, by result "
    "(accepted / rejected / removed).", ("result",))
_m_road_gen = get_registry().gauge(
    "rtpu_road_model_generation",
    "Generation id of the live road-GNN leg pricer (bumped per swap).")
_m_overlay_info = get_registry().gauge(
    "rtpu_router_overlay_info",
    "Overlay build stats by level and stat.", ("level", "stat"))
_m_overlay_build = get_registry().gauge(
    "rtpu_router_overlay_build_seconds",
    "Overlay precompute seconds by level.", ("level",))


def _road_swap_divergence() -> float:
    """Verified road-GNN hot-swap bound (median absolute edge-seconds
    divergence from the live pricer; 0 disables the compare — the
    finiteness gate always holds)."""
    try:
        return float(os.environ.get("RTPU_ROAD_SWAP_MAX_DIV", "600"))
    except ValueError:
        return 600.0


def _time_table(senders: torch.Tensor, pred: torch.Tensor,
                time_e: torch.Tensor, dist: torch.Tensor, *,
                n_rounds: int) -> torch.Tensor:
    """(S, N) travel seconds along every shortest-path tree: pointer
    doubling, each round every node's accumulated time and parent jump
    twice as far up its tree, in the JAX ``_time_table``'s order of
    adds. Runs all ``n_rounds`` rounds with no host check: once a chain
    reaches its root, a round adds the root's 0.0 and keeps its parent,
    so the extra rounds change nothing and the table is the JAX one.
    Unreachable nodes and nodes in (or chaining into) a predecessor
    cycle come back inf."""
    n = pred.shape[1]
    has_pred = pred >= 0
    safe = torch.clamp(pred, min=0)
    parent = torch.where(has_pred, senders[safe],
                         torch.arange(n, device=pred.device)[None, :])
    acc = torch.where(has_pred, time_e[safe], 0.0)
    for _ in range(n_rounds):
        acc = acc + torch.gather(acc, 1, parent)
        parent = torch.gather(parent, 1, parent)
    # A finished chain ends at a TRUE root (a node with no predecessor);
    # anything whose final parent still has one sits in a cycle.
    bad_root = torch.gather(has_pred, 1, parent)
    return torch.where((dist < 1e37) & ~bad_root, acc,
                       torch.full_like(acc, float("inf")))


def _bellman_ford(senders: torch.Tensor, receivers: torch.Tensor,
                  w: torch.Tensor, sources: torch.Tensor, *, n_nodes: int,
                  max_iters: int) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(S,) source nodes → (S, N) distances, (S, N) predecessor edge ids
    in the SORTED edge order, and converged (False: ``max_iters`` was
    exhausted, the distances are not to be trusted)."""
    n_src = sources.shape[0]
    dist0 = torch.full((n_src, n_nodes), _INF, dtype=torch.float32,
                       device=w.device)
    dist0[torch.arange(n_src, device=w.device), sources] = 0.0
    dist, converged = relax_from(senders, receivers, w, dist0,
                                 max_iters=max_iters)
    pred = tight_pred(senders, receivers, w, dist, sources)
    return dist, pred, converged


def _polish_sweeps() -> int:
    """Flat-relaxation sweeps the overlay solve runs over its distances
    before predecessor recovery (``ROUTEST_POLISH_SWEEPS``, default 1):
    the values are already exact, so one sweep re-anchors every node's
    assignment to a ``dist[s] + w`` proposal."""
    try:
        return max(1, int(os.environ.get("ROUTEST_POLISH_SWEEPS", "1")))
    except ValueError:
        return 1


def _batcher_config() -> Tuple[bool, int, float]:
    """(enabled, max merged rows, window seconds) for the solve
    batcher (``ROUTEST_ROUTER_BATCH`` on/off,
    ``ROUTEST_ROUTER_BATCH_MAX``, ``ROUTEST_ROUTER_BATCH_WINDOW_MS``)."""
    raw = os.environ.get("ROUTEST_ROUTER_BATCH", "1").strip().lower()
    enabled = raw not in ("0", "off", "false", "no")
    try:
        max_rows = max(1, int(os.environ.get(
            "ROUTEST_ROUTER_BATCH_MAX", "32")))
    except ValueError:
        max_rows = 32
    try:
        window_ms = float(os.environ.get(
            "ROUTEST_ROUTER_BATCH_WINDOW_MS", "0"))
    except ValueError:
        window_ms = 0.0
    return enabled, max_rows, max(0.0, window_ms) / 1000.0


class _LiveMetric:
    """One immutable live-traffic metric generation: the blended
    per-edge travel seconds, their receiver-sorted copy on the device,
    the customized overlay (when the router has one) and its solve.
    Built off-path by ``install_live_metric`` and installed with a single
    reference flip — requests snapshot ``router._live`` once, so a flip
    can never tear a solve."""

    __slots__ = ("epoch", "gen", "time_s", "d_time_bf", "hier", "solve",
                 "route", "installed_unix", "timings")

    def __init__(self, epoch: int, time_s: np.ndarray, d_time_bf,
                 hier, solve, route: bool, timings: Dict,
                 gen: int = 0) -> None:
        self.epoch = int(epoch)
        # Router-internal monotonic install counter: the route fast lane
        # keys on (epoch, gen), so two installs that reuse an epoch
        # number can never alias onto one cache key.
        self.gen = int(gen)
        self.time_s = time_s
        self.d_time_bf = d_time_bf
        self.hier = hier
        self.solve = solve
        self.route = route
        self.installed_unix = time.time()
        self.timings = timings


class _BatchEntry:
    __slots__ = ("sources", "live", "event", "dist", "pred", "error",
                 "dispatch_rows", "dispatch_requests", "t_q")

    def __init__(self, sources: np.ndarray, live) -> None:
        self.sources = sources
        self.live = live
        self.event = threading.Event()
        self.dist = self.pred = None
        self.error: Optional[BaseException] = None
        # Stamped by _dispatch: how big the merged device solve that
        # carried this entry was (trace provenance).
        self.dispatch_rows = 0
        self.dispatch_requests = 0
        # Enqueue stamp for the goodput ledger's queue/compute split.
        self.t_q = time.monotonic()


class _SolveBatcher:
    """Cross-request solve coalescing: concurrent :meth:`RoadRouter.
    shortest` callers merge into ONE device solve. The source axis is
    batched by design, so merged rows are bitwise what lone solves
    return; the merge only amortizes launches and the fetch.

    With the default 0 ms window a lone request dispatches at once;
    arrivals during an in-flight solve queue and drain as the NEXT
    merged batch. ``window_s > 0`` adds a fixed wait before each drain.

    Requests under different route-metric generations never share a
    dispatch (their edge weights differ): the key is the live generation
    itself (None for the distance metric), so the leader drains one
    generation per round, in arrival order around a flip.
    """

    def __init__(self, router: "RoadRouter", max_rows: int,
                 window_s: float) -> None:
        self._router = router
        self.max_rows = int(max_rows)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._queue: List[_BatchEntry] = []
        self._busy = False
        self._dispatches = 0
        self._rows = 0
        self._requests = 0
        self._merged_requests = 0
        self._max_occupancy = 0

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
                    "mean_rows_per_dispatch": round(self._rows / d, 3)}

    def solve(self, sources: np.ndarray, live=None):
        """One caller's solve through the merge queue, traced: the span
        records how many rows rode the merged solve that carried it."""
        with trace_span("router.batch_solve", rows=len(sources)) as span:
            entry = self._solve_entry(sources, live)
            span.set_attr("dispatch_rows", entry.dispatch_rows)
            span.set_attr("merged_requests", entry.dispatch_requests)
            return entry.dist, entry.pred

    def _solve_entry(self, sources: np.ndarray, live) -> _BatchEntry:
        entry = _BatchEntry(sources,
                            live if live is not None and live.route
                            else None)
        with self._lock:
            self._queue.append(entry)
            self._requests += 1
            leader = not self._busy
            if leader:
                self._busy = True
        if not leader:
            if not entry.event.wait(120.0):
                raise TimeoutError("router solve batcher wedged")
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
                        # queue must be ONE atomic step: an arrival in
                        # between would wait on a leader that left.
                        self._busy = False
                        break
                    k0 = self._queue[0].live
                    batch: List[_BatchEntry] = []
                    rest: List[_BatchEntry] = []
                    rows = 0
                    for it in self._queue:
                        if (it.live is k0
                                and rows + len(it.sources) <= self.max_rows):
                            batch.append(it)
                            rows += len(it.sources)
                        else:
                            rest.append(it)
                    self._queue = rest
                    self._dispatches += 1
                    self._rows += rows
                    self._max_occupancy = max(self._max_occupancy, rows)
                    if len(batch) > 1:
                        self._merged_requests += len(batch)
                self._dispatch(batch)
        except BaseException as e:  # drain-loop bug: fail loudly, not hung
            drain_error = e
            raise
        finally:
            if drain_error:
                with self._lock:
                    leftovers = list(self._queue)
                    self._queue = []
                    self._busy = False
                for it in leftovers:
                    if not it.event.is_set():
                        it.error = drain_error
                        it.event.set()
        if entry.error is not None:
            raise entry.error
        return entry

    def _dispatch(self, batch: List[_BatchEntry]) -> None:
        merged = (batch[0].sources if len(batch) == 1
                  else np.concatenate([it.sources for it in batch]))
        queue_s = max(0.0, time.monotonic() - min(it.t_q for it in batch))
        t0 = time.perf_counter()
        try:
            dist, pred = self._router._solve_rows(merged, batch[0].live)
        except BaseException as e:  # propagate to every merged caller
            for it in batch:
                it.error = e
                it.event.set()
            return
        # _solve_rows pads the source axis to the next power of two —
        # that IS the launched batch the goodput ledger accounts.
        n = len(merged)
        bucket = 1 << max(0, n - 1).bit_length()
        get_ledger().record(
            "route_solve", real_rows=n, padded_rows=bucket, bucket=bucket,
            queue_s=queue_s, compute_s=time.perf_counter() - t0)
        pos = 0
        for it in batch:
            m = len(it.sources)
            it.dist = dist[pos:pos + m]
            it.pred = pred[pos:pos + m]
            it.dispatch_rows = len(merged)
            it.dispatch_requests = len(batch)
            pos += m
            it.event.set()


class RoadRouter:
    """Routable road network: snap → batched shortest paths → polylines."""

    def __init__(self, graph: Optional[Dict[str, np.ndarray]] = None,
                 n_nodes: int = 2048, seed: int = 0,
                 use_gnn: bool = True,
                 gnn_path: Optional[str] = None,
                 use_transformer: bool = True,
                 transformer_path: Optional[str] = None,
                 device=None) -> None:
        self.device = resolve_device(device, "RoadRouter")
        g = graph if graph is not None else generate_road_graph(
            n_nodes=n_nodes, seed=seed)
        self.coords = np.asarray(g["node_coords"], np.float32)   # (N, 2)
        senders = np.asarray(g["senders"], np.int32)
        receivers = np.asarray(g["receivers"], np.int32)
        length = np.asarray(g["length_m"], np.float32)
        road_class = np.asarray(g["road_class"], np.int32)
        speed_limit = np.asarray(
            g.get("speed_limit", _CLASS_SPEED_MPS[road_class]), np.float32)
        senders, receivers, length, road_class, speed_limit = \
            self._bridge_components(senders, receivers, length, road_class,
                                    speed_limit)
        # Learned pricers are bound to the POST-bridge graph (the edge
        # set their messages aggregate over).
        self._fingerprint = graph_fingerprint(
            self.coords, senders, receivers, length)
        self.senders, self.receivers = senders, receivers
        self.length_m = length
        self.road_class = road_class
        self.speed_limit = speed_limit
        # Fallback leg pricing: free-flow physics (length / speed limit +
        # intersection overhead).
        self.freeflow_time_s = (
            length / np.maximum(self.speed_limit, 0.1) + 4.0
        ).astype(np.float32)
        self.n_nodes = len(self.coords)
        # A kNN street grid's hop diameter is O(√N): 4√N + 8 sweeps is a
        # comfortable first bound; an exhausted run re-runs with N.
        self.max_iters = int(4 * np.sqrt(self.n_nodes)) + 8

        def on_device(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(self.device)

        # Original edge order (the GNN's feature order) ...
        self._d_coords = on_device(self.coords, np.float32)
        self._d_senders = on_device(self.senders, np.int64)
        self._d_receivers = on_device(self.receivers, np.int64)
        self._d_length = on_device(self.length_m, np.float32)
        self._d_speed = on_device(self.speed_limit, np.float32)
        # ... and receiver-sorted copies for the sweep; predecessor ids
        # come back in this order and map through _bf_perm.
        self._bf_perm = np.argsort(self.receivers, kind="stable").astype(
            np.int32)
        self._bf_senders = on_device(self.senders[self._bf_perm], np.int64)
        self._bf_receivers = on_device(self.receivers[self._bf_perm],
                                       np.int64)
        self._bf_length = on_device(self.length_m[self._bf_perm], np.float32)
        # Metro-scale graphs route through the partition overlay: the
        # flat sweep count is the graph's hop diameter, O(√N). The
        # overlay's cache file is the JAX package's format and name, so
        # either package loads what the other built.
        self._hier: Optional[HierarchicalIndex] = None
        self._overlay_solve = None
        hmin = hier_min_nodes()
        if hmin and self.n_nodes >= hmin:
            cache = hier_cache_path(self._fingerprint)
            if cache and os.path.exists(cache):
                self._hier = HierarchicalIndex.load(
                    cache, fingerprint=self._fingerprint, device=self.device)
            if self._hier is None:
                self._hier = HierarchicalIndex.build(
                    self.coords, self.senders, self.receivers,
                    self.length_m, cache_path=cache,
                    fingerprint=self._fingerprint, device=self.device)
        if self._hier is not None:
            self._overlay_solve = self._make_overlay_solve(self._hier)
            self._publish_overlay_metrics()

        enabled, max_rows, window_s = _batcher_config()
        self._solve_batcher: Optional[_SolveBatcher] = (
            _SolveBatcher(self, max_rows, window_s) if enabled else None)
        rc_on, rc_bytes, rc_ttl = route_cache_config()
        self._route_cache: Optional[RouteCache] = (
            RouteCache(rc_bytes, rc_ttl) if rc_on else None)
        self._hour_times: Dict[int, np.ndarray] = {}
        self._model_lock = threading.Lock()
        # Learned leg models hot-reload: each request batch stats the
        # artifacts and re-runs the fingerprint-gated loader when a file
        # changed. Mtimes are recorded even for rejected artifacts so a
        # bad file is not re-parsed on every request.
        self._gnn_path = (gnn_path or default_gnn_path()) if use_gnn else None
        self._transformer_path = (
            (transformer_path or default_transformer_path())
            if use_transformer else None)
        self._gnn_mtime_ns: Optional[int] = None
        self._transformer_mtime_ns: Optional[int] = None
        self._gnn = None
        self._transformer = None  # (module, trained seq_len)
        # Serializes reloads only: loading happens outside _model_lock,
        # so a retrain never stalls concurrent requests.
        self._reload_lock = threading.Lock()
        self._model_gen = 0  # bumped per swap: stale cache writes discard
        self._maybe_reload_models()
        # Live-traffic metric: installed by the customizer, snapshotted
        # once per request batch. None = frozen world (free-flow / GNN
        # pricing, distance-metric routing).
        self._live: Optional[_LiveMetric] = None
        self._live_installs = 0  # monotonic; part of the route-cache key
        self._live_lock = threading.Lock()  # serializes installs only

    @property
    def leg_cost_model(self) -> str:
        """"gnn" when learned per-edge times serve requests, else
        "freeflow"."""
        return "gnn" if self._gnn is not None else "freeflow"

    @property
    def has_transformer(self) -> bool:
        return self._transformer is not None

    @property
    def solver_info(self) -> Dict:
        """Health's view of the solver: the overlay with its build stats
        and provenance, or the flat sweep with its bound; then the
        batcher's merge stats and the route cache's counters. The keys
        are the JAX router's (``aot_buckets`` is always empty here)."""
        if self._hier is not None:
            info = {"solver": "hierarchy",
                    "overlay": dict(self._hier.stats)}
            info["overlay"].setdefault("loaded_from_cache", False)
            info["overlay"]["cache_version"] = _CACHE_VERSION
            info["hub_labels"] = self._hier._labels is not None
            info["aot_buckets"] = []
        else:
            info = {"solver": "flat_bf", "max_iters_bound": self.max_iters}
        if self._solve_batcher is not None:
            info["batch"] = self._solve_batcher.stats()
        if self._route_cache is not None:
            info["route_cache"] = self._route_cache.stats()
        if self._live is not None:
            info["live"] = self.live_info
        return info

    # ── live traffic: metric install / flip ───────────────────────────

    @property
    def live_epoch(self) -> int:
        """Metric generation currently serving (0 = no live metric)."""
        live = self._live
        return live.epoch if live is not None else 0

    @property
    def live_info(self) -> Optional[Dict]:
        """Health's and ``/api/live``'s view of the installed metric."""
        live = self._live
        if live is None:
            return None
        return {"epoch": live.epoch, "route_metric": live.route,
                "installed_unix": round(live.installed_unix, 3),
                **live.timings}

    def live_metric_export(self) -> Optional[np.ndarray]:
        """The (E,) blended edge seconds the live generation serves."""
        live = self._live
        return None if live is None else live.time_s

    def install_live_metric(self, time_s: np.ndarray, epoch: int, *,
                            route: bool = True) -> Dict:
        """Build and atomically flip to a new live metric generation.

        ``time_s`` is the blended per-edge travel seconds (original edge
        order). Bad entries (non-finite, non-positive) become free-flow
        time, and every edge is floored at free-flow at an arterial
        ceiling (``length_m / 16.7``). The receiver-sorted time weights
        upload to the router's device and, on an overlay router with
        ``route``, the overlay is customized against the metric there —
        all before the flip, on the caller's (customizer) thread, so
        requests keep solving the previous generation and the flip
        itself is one reference assignment. ``route=False`` installs the
        metric for leg PRICING only. Raises on a bad metric or a failed
        customization; the previous generation keeps serving."""
        time_s = np.array(time_s, np.float32, copy=True)
        if time_s.shape != self.length_m.shape:
            raise ValueError(
                f"live metric has {time_s.shape} entries, graph has "
                f"{self.length_m.shape}")
        bad = ~np.isfinite(time_s) | (time_s <= 0)
        if bad.any():
            time_s[bad] = self.freeflow_time_s[bad]
        np.maximum(time_s, self.length_m / 16.7, out=time_s)
        timings: Dict = {}
        hier_live = solve = None
        d_time_bf = torch.from_numpy(time_s[self._bf_perm]).to(self.device)
        if self._hier is not None and route:
            t0 = time.perf_counter()
            hier_live = self._hier.customize(time_s)
            timings["customize_s"] = round(time.perf_counter() - t0, 3)
            timings["full_build_s"] = self._hier.stats.get("build_s", 0.0)
            solve = self._make_overlay_solve(hier_live)
        with self._live_lock:
            self._live_installs += 1
            live = _LiveMetric(epoch, time_s, d_time_bf, hier_live, solve,
                               route, timings, gen=self._live_installs)
            self._live = live
        set_metric_epoch(live.epoch)
        _log.info("live_metric_installed", epoch=live.epoch, route=route,
                  **timings)
        return dict(timings, epoch=live.epoch)

    @staticmethod
    def _make_overlay_solve(hier: HierarchicalIndex):
        """The overlay query + contracted-graph polish and predecessor
        recovery + exact chain synthesis
        (``HierarchicalIndex.full_solve_fn``)."""
        return hier.full_solve_fn(_polish_sweeps())

    def graph_dict(self) -> Dict[str, np.ndarray]:
        """The (post-bridge) routable graph: the exact arrays serving
        aggregates over, and so the arrays a leg model must train on."""
        return {
            "node_coords": self.coords,
            "senders": self.senders,
            "receivers": self.receivers,
            "length_m": self.length_m,
            "road_class": self.road_class,
            "speed_limit": self.speed_limit,
        }

    def _load_leg_model(self, loader, resolved: str, tag: str):
        """Load a learned leg-cost artifact behind its fingerprint gate →
        (module on this router's device, meta) or None. The artifact is
        optional by design: any failure degrades to the next pricer
        down, never an error. On the CPU a bf16 model computes in f32
        (``backend_compute_policy``); on the card its policy stands."""
        try:
            model, _params, meta = loader(resolved)
        except FileNotFoundError:
            return None
        except Exception as e:  # corrupt/foreign artifact: degrade, log
            _log.warning(f"{tag}_artifact_unusable", path=resolved,
                         error=f"{type(e).__name__}: {e}")
            return None
        fp = meta.get("graph", meta) if isinstance(meta, dict) else meta
        if fp != self._fingerprint:
            # Expected whenever a custom/test graph is routed.
            _log.debug(f"{tag}_graph_mismatch", path=resolved,
                       artifact=fp, router=self._fingerprint)
            return None
        if hasattr(model, "policy"):
            model.policy = backend_compute_policy(model.policy, self.device)
        return model.to(self.device), meta

    @staticmethod
    def _mtime_ns(path: Optional[str]) -> Optional[int]:
        if not path:
            return None
        try:
            return os.stat(path).st_mtime_ns
        except OSError:
            return None

    def _maybe_reload_models(self) -> None:
        """Reload the GNN / transformer when their artifact files changed
        (two stats per call — cheap enough to run per request batch).
        Same degradation contract as a fresh process: a rejected
        replacement is not served; a DELETED artifact stops serving
        (pricing falls down the stack). Loading runs outside
        ``_model_lock`` — only the reference swap and the generation
        bump hold it; a second thread arriving mid-reload serves the
        current models."""
        if not (self._gnn_path or self._transformer_path):
            return
        if not self._reload_lock.acquire(blocking=False):
            return  # another request is already reloading
        try:
            m = self._mtime_ns(self._gnn_path)
            if self._gnn_path and m != self._gnn_mtime_ns:
                loaded = (self._load_leg_model(load_gnn, self._gnn_path,
                                               "road_gnn")
                          if m is not None else None)
                new_gnn = None if loaded is None else loaded[0]
                # Verified hot-swap: a replacement must price the graph
                # finitely (and, over a live GNN, within the divergence
                # bound) before the generation flips; a deleted artifact
                # stops serving; the first install needs finiteness.
                accept, verdict = self._verify_gnn_swap(new_gnn, m)
                if accept:
                    with self._model_lock:
                        self._gnn = new_gnn
                        self._gnn_mtime_ns = m
                        self._model_gen += 1
                        self._hour_times.clear()
                        gen = self._model_gen
                    _m_road_swaps.labels(
                        result=verdict.pop("result", "accepted")).inc()
                    _m_road_gen.set(gen)
                    record_change("model.road_swap",
                                  detail={"generation": gen,
                                          "path": self._gnn_path})
                    _log.info("road_model_swapped", generation=gen,
                              path=self._gnn_path, **verdict)
                else:
                    with self._model_lock:
                        # Remember the bad mtime so the artifact is not
                        # re-verified on every request until it changes.
                        self._gnn_mtime_ns = m
                    _m_road_swaps.labels(result="rejected").inc()
                    _log.warning("road_model_swap_rejected",
                                 path=self._gnn_path, **verdict)
            m = self._mtime_ns(self._transformer_path)
            if self._transformer_path and m != self._transformer_mtime_ns:
                loaded = (self._load_leg_model(
                    load_transformer, self._transformer_path,
                    "route_transformer") if m is not None else None)
                new_tf = (None if loaded is None else
                          (loaded[0], int(loaded[1].get("seq_len", 24))))
                with self._model_lock:
                    self._transformer = new_tf
                    self._transformer_mtime_ns = m
        finally:
            self._reload_lock.release()

    def _verify_gnn_swap(self, new_gnn, mtime_ns) -> Tuple[bool, Dict]:
        """Golden-graph gate for a road-GNN replacement → ``(accept,
        verdict)``. ``new_gnn`` None accepts as a removal (file deleted)
        unless a model is live and the file still EXISTS (an unloadable
        overwrite must not take down a working pricer). A loadable
        replacement prices the whole edge set at the current hour: any
        non-finite output rejects, and — over a live GNN — a median
        absolute divergence beyond ``RTPU_ROAD_SWAP_MAX_DIV``
        edge-seconds rejects too."""
        with self._model_lock:
            cur = self._gnn
        if new_gnn is None:
            if cur is not None and mtime_ns is not None:
                return False, {"reason": "replacement failed to load"}
            return True, {"result": "removed" if mtime_ns is None
                          else "accepted"}
        import datetime as _dt

        hour = _dt.datetime.now().hour
        try:
            pred = self._gnn_forward(new_gnn, hour)
        except Exception as exc:
            return False, {"reason": "verification forward failed: "
                                     f"{type(exc).__name__}: {exc}"}
        if not np.isfinite(pred).all():
            return False, {"reason": "non-finite edge predictions",
                           "bad_edges": int((~np.isfinite(pred)).sum())}
        bound = _road_swap_divergence()
        if cur is not None and bound > 0:
            pred_f = np.maximum(pred, self.length_m / 16.7)
            cur_f = self.edge_time_s(hour)  # live pricer, same floor
            div = float(np.median(np.abs(pred_f - cur_f)))
            if div > bound:
                return False, {"reason": "divergence beyond bound",
                               "divergence_s": round(div, 2),
                               "bound_s": bound}
            return True, {"divergence_s": round(div, 3), "bound_s": bound}
        return True, {}

    def _gnn_forward(self, gnn, hour: int) -> np.ndarray:
        """(E,) raw GNN edge seconds over the whole graph at ``hour``."""
        feats = torch.from_numpy(edge_feature_array(
            self.length_m, self.speed_limit, self.road_class, hour)).to(
                self.device)
        return gnn(self._d_coords, self._d_senders, self._d_receivers,
                   feats, self._d_length, self._d_speed
                   ).float().cpu().numpy()

    def edge_time_s(self, hour: int) -> np.ndarray:
        """(E,) per-edge car travel seconds at the given hour-of-day:
        GNN-predicted when its artifact matches this graph (cached per
        hour), free-flow physics otherwise. Floored at free-flow at an
        arterial ceiling (length / 16.7 m/s)."""
        h = int(hour) % 24
        # ONE consistent snapshot of (model, cache, generation): a
        # concurrent hot-reload's cache clear must invalidate THIS
        # call's eventual write.
        with self._model_lock:
            gnn = self._gnn
            gen = self._model_gen
            cached = self._hour_times.get(h)
        if gnn is None:
            return self.freeflow_time_s
        if cached is not None:
            return cached
        try:
            pred = self._gnn_forward(gnn, h)
        except Exception as e:
            # A loaded-but-unusable artifact degrades to physics, not a
            # failed request; drop it so the cost is paid once.
            _log.error("road_gnn_apply_failed",
                       error=f"{type(e).__name__}: {e}")
            with self._model_lock:
                if self._model_gen == gen:
                    self._gnn = None
                    self._model_gen += 1
                    self._hour_times.clear()
            return self.freeflow_time_s
        pred = np.maximum(pred, self.length_m / 16.7)  # 60 km/h cap
        with self._model_lock:
            if self._model_gen == gen:  # don't poison a reloaded cache
                self._hour_times[h] = pred
        return pred

    def _bridge_components(self, senders, receivers, length, road_class,
                           speed_limit):
        """kNN graphs can come out disconnected; bridge every component to
        the largest with an edge between their closest node pair so every
        snap target is reachable. Pure numpy union-find."""
        n = len(self.coords)
        parent = np.arange(n)

        def find(a: int) -> int:
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:  # path compression
                parent[a], a = root, parent[a]
            return root

        for s, r in zip(senders, receivers):
            ra, rb = find(int(s)), find(int(r))
            if ra != rb:
                parent[rb] = ra
        labels_raw = np.fromiter((find(i) for i in range(n)), np.int64, n)
        _, labels = np.unique(labels_raw, return_inverse=True)
        n_comp = int(labels.max()) + 1
        if n_comp <= 1:
            return senders, receivers, length, road_class, speed_limit
        sizes = np.bincount(labels)
        main = int(np.argmax(sizes))
        add_s, add_r = [], []
        main_nodes = np.flatnonzero(labels == main)
        for comp in range(n_comp):
            if comp == main:
                continue
            nodes = np.flatnonzero(labels == comp)
            d = haversine_np(
                self.coords[nodes, 0][:, None], self.coords[nodes, 1][:, None],
                self.coords[main_nodes, 0][None, :],
                self.coords[main_nodes, 1][None, :])
            i, j = np.unravel_index(np.argmin(d), d.shape)
            add_s.append(nodes[i])
            add_r.append(main_nodes[j])
        add_s = np.asarray(add_s, np.int32)
        add_r = np.asarray(add_r, np.int32)
        bridge_len = (haversine_np(
            self.coords[add_s, 0], self.coords[add_s, 1],
            self.coords[add_r, 0], self.coords[add_r, 1]) * 1.2).astype(np.float32)
        bridge_class = np.full(len(add_s), 1, np.int32)  # collector
        bridge_speed = np.full(len(add_s), _CLASS_SPEED_MPS[1], np.float32)
        return (np.concatenate([senders, add_s, add_r]),
                np.concatenate([receivers, add_r, add_s]),
                np.concatenate([length, bridge_len, bridge_len]),
                np.concatenate([road_class, bridge_class, bridge_class]),
                np.concatenate([speed_limit, bridge_speed, bridge_speed]))

    def snap(self, latlon: np.ndarray) -> np.ndarray:
        """(M, 2) lat/lon → (M,) nearest graph node ids (host numpy)."""
        latlon = np.asarray(latlon, np.float32)
        d = haversine_np(latlon[:, 0][:, None], latlon[:, 1][:, None],
                         self.coords[None, :, 0], self.coords[None, :, 1])
        return np.argmin(d, axis=1).astype(np.int32)

    def shortest(self, source_nodes: np.ndarray, live=None):
        """(S,) nodes → ((S, N) distances, (S, N) predecessor edge ids
        in the original edge order), host numpy.

        Concurrent callers under the same metric merge into one device
        solve through the solve batcher; requests above its row limit
        solve directly. With ``live`` (a snapshot of ``self._live``
        taken ONCE by the caller, so one request batch never straddles a
        flip) and its route metric armed, the solve runs over the live
        travel-time metric: distances come back in seconds, and the
        trees are time-shortest (``_meters_along`` recovers meters)."""
        source_nodes = np.asarray(source_nodes, np.int32)
        batcher = self._solve_batcher
        if batcher is not None and 0 < len(source_nodes) <= batcher.max_rows:
            return batcher.solve(source_nodes, live)
        # Direct path (batcher off, or oversized request): still a
        # padded device solve the goodput ledger must see.
        n = len(source_nodes)
        t0 = time.perf_counter()
        out = self._solve_rows(source_nodes, live)
        if n > 0:
            bucket = 1 << max(0, n - 1).bit_length()
            get_ledger().record(
                "route_solve", real_rows=n, padded_rows=bucket,
                bucket=bucket, compute_s=time.perf_counter() - t0,
                oversized=batcher is not None and n > batcher.max_rows)
        return out

    def _publish_overlay_metrics(self) -> None:
        """Overlay build stats → the process registry: per-level
        ``rtpu_router_overlay_info{level, stat}`` gauges plus
        ``rtpu_router_overlay_build_seconds{level}``."""
        if self._hier is None:
            return
        for lvl in self._hier.stats.get("levels", []):
            level = str(lvl.get("level", 1))
            for stat in ("n_cells", "c_max", "b_max", "n_overlay_nodes",
                         "n_overlay_edges", "clique_edges_kept",
                         "clique_edges_pruned"):
                if stat in lvl:
                    _m_overlay_info.labels(level=level, stat=stat).set(
                        lvl[stat])
            _m_overlay_build.labels(level=level).set(lvl.get("build_s", 0.0))
        _m_overlay_info.labels(level="top", stat="n_overlay_nodes").set(
            self._hier.stats.get("top_nodes", 0))
        _m_overlay_info.labels(level="top", stat="n_overlay_edges").set(
            self._hier.stats.get("top_edges", 0))

    def _solve_rows(self, source_nodes: np.ndarray, live=None):
        """One device solve (the batcher calls this with merged rows).
        The source axis pads to a power of two by repeating source 0, as
        the JAX package pads to reuse a compiled program; the padding
        rows are dropped. One host fetch per solve besides the relax
        loops' checks. Under a live route metric the overlay is the
        customized one and the flat sweep's weights are the time
        metric's (the same code, other tensors: a flip recompiles
        nothing)."""
        source_nodes = np.asarray(source_nodes, np.int32)
        n_src = len(source_nodes)
        bucket = 1 << max(0, (n_src - 1)).bit_length()
        padded = np.full(bucket, source_nodes[0] if n_src else 0, np.int64)
        padded[:n_src] = source_nodes
        sources = torch.from_numpy(padded).to(self.device)
        if live is not None and live.route:
            hier, solve, w = live.hier, live.solve, live.d_time_bf
        else:
            hier, solve, w = self._hier, self._overlay_solve, self._bf_length
        if hier is not None:
            # Overlay path: exact by construction (no exhaustion re-run),
            # and full_solve_fn already returns ORIGINAL edge ids.
            dist, pred = solve(*hier.prep_sources(padded), sources)
            return self._fetch(dist[:n_src], pred[:n_src])
        dist, pred, converged = _bellman_ford(
            self._bf_senders, self._bf_receivers, w, sources,
            n_nodes=self.n_nodes, max_iters=self.max_iters)
        if not converged:
            # The O(√N) heuristic was exhausted while distances were
            # still improving (long chains): re-run with the exact bound.
            _log.warning("bellman_ford_bound_exhausted",
                         heuristic=self.max_iters, exact=self.n_nodes,
                         n_sources=n_src)
            dist, pred, _ = _bellman_ford(
                self._bf_senders, self._bf_receivers, w,
                sources, n_nodes=self.n_nodes, max_iters=self.n_nodes)
        dist, pred = self._fetch(dist[:n_src], pred[:n_src])
        # sorted-edge ids → original edge ids
        pred = np.where(pred >= 0, self._bf_perm[np.maximum(pred, 0)], -1)
        return dist, pred

    @staticmethod
    def _fetch(dist: torch.Tensor, pred: torch.Tensor):
        """ONE device→host copy of a solve: the distances ride along with
        the predecessor ids as int32 bit patterns."""
        n = dist.shape[0]
        both = torch.cat([dist.view(torch.int32),
                          pred.to(torch.int32)]).cpu().numpy()
        return both[:n].view(np.float32), both[n:]

    def _tree_table(self, pred: np.ndarray, edge_cost: np.ndarray,
                    dist_rows: np.ndarray) -> np.ndarray:
        """(S, N) per-edge ``edge_cost`` summed along the predecessor
        trees (``_time_table``) on the router's device, host numpy;
        ``dist_rows`` marks the unreachable nodes (inf)."""
        n_rounds = max(1, (max(self.n_nodes - 1, 1)).bit_length())

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return _time_table(
            self._d_senders, on_device(pred.astype(np.int64)),
            on_device(edge_cost), on_device(dist_rows),
            n_rounds=n_rounds).cpu().numpy()

    def _meters_along(self, pred: np.ndarray,
                      metric_rows: np.ndarray) -> np.ndarray:
        """(S, N) meters accumulated along the given predecessor trees.
        Live-metric solves are time-shortest, so leg DISTANCES are
        recovered along those trees rather than read from the solve's
        own (seconds) table. Unreachable → 3e38, the distance solve's
        sentinel."""
        meters = self._tree_table(pred, self.length_m, metric_rows)
        return np.where(np.isfinite(meters), meters,
                        np.float32(3e38)).astype(np.float32)

    def _walk(self, pred_row: np.ndarray, source: int, target: int) -> List[int]:
        """Predecessor edges → node sequence source..target (host-side)."""
        path = [int(target)]
        node = int(target)
        for _ in range(self.n_nodes):
            if node == source:
                break
            e = int(pred_row[node])
            if e < 0:
                return []  # unreachable
            node = int(self.senders[e])
            path.append(node)
        if node != source:
            # Budget exhausted without reaching the source: a predecessor
            # cycle. Unreachable beats a garbage path.
            return []
        return path[::-1]

    def route_legs(self, points_latlon: np.ndarray,
                   time_scale: float = 1.0,
                   hour: Optional[int] = None) -> "RoadLegs":
        """Legs between M waypoints over the road graph: one batched
        solve, lazy memoized walks. ``time_scale`` maps car times to the
        vehicle profile; ``hour`` (0-23) selects the GNN's congestion
        regime, None prices at noon."""
        return self.route_legs_batch([(points_latlon, time_scale, hour)])[0]

    def route_legs_batch(self, problems) -> List["RoadLegs"]:
        """Many waypoint sets → one :class:`RoadLegs` each, sharing as
        few device solves as memory allows (``problems``: a list of
        ``route_legs`` argument triples).

        Problems first consult the route fast lane: a cached identical
        problem skips snap and solve, and concurrent identical problems
        collapse onto one solve. The remainder concatenates along the
        source axis in groups whose fetch stays under ~64 MB, and splits
        back as row slices, bitwise what per-problem solves return.

        ONE live-metric snapshot serves the whole batch: every problem
        in it prices (and, with the route metric armed, routes) against
        the same generation, and a concurrent flip affects only later
        batches. A changed learned-pricer artifact is picked up first,
        once for the whole batch. The ``router.route_legs`` span carries
        the batch's provenance: solver regime, metric epoch, road-model
        generation and route-cache outcome."""
        with trace_span("router.route_legs",
                        problems=len(problems)) as span:
            return self._route_legs_batch_traced(problems, span)

    def _route_legs_batch_traced(self, problems, span) -> List["RoadLegs"]:
        self._maybe_reload_models()
        pts_list = [np.asarray(p, np.float32) for p, _, _ in problems]
        counts = [len(p) for p in pts_list]
        live = self._live
        out: List[Optional[RoadLegs]] = [None] * len(problems)
        cache = self._route_cache
        keys: List = [None] * len(problems)
        aliases: List[Tuple[int, int]] = []        # (idx, lead idx)
        waits: List[Tuple[int, object]] = []       # (idx, flight)
        solve_idx: List[int] = list(range(len(problems)))
        if cache is not None:
            epoch = ((live.epoch, live.gen) if live is not None
                     else (0, 0))
            gen = self._model_gen
            my_leads: Dict = {}
            solve_idx = []
            for i, pts in enumerate(pts_list):
                _, time_scale, hour = problems[i]
                eff_hour = 12 if hour is None else int(hour) % 24
                key = (pts.tobytes(), len(pts), float(time_scale),
                       eff_hour, epoch, gen)
                keys[i] = key
                lead = my_leads.get(key)
                if lead is not None:
                    # duplicate inside this batch: share the lead's
                    # legs (waiting on our own flight would deadlock)
                    aliases.append((i, lead))
                    continue
                state, val = cache.lookup(key)
                if state == "hit":
                    out[i] = val
                elif state == "wait":
                    waits.append((i, val))
                else:
                    my_leads[key] = i
                    solve_idx.append(i)
        span.set_attr(
            "solver",
            "hub_labels" if (self._hier is not None
                             and self._hier._labels is not None)
            else ("overlay_top_bf" if self._hier is not None
                  else "flat_bf"))
        span.set_attr("metric_epoch",
                      live.epoch if live is not None else 0)
        span.set_attr("model_generation", self._model_gen)
        if cache is None:
            span.set_attr("route_cache", "off")
        else:
            span.set_attr("route_cache_hits",
                          sum(1 for o in out if o is not None))
            span.set_attr("route_cache_misses", len(solve_idx))
            span.set_attr("route_cache_waits", len(waits))
            span.set_attr("route_cache_aliases", len(aliases))
        try:
            if solve_idx:
                self._solve_problems(problems, pts_list, counts, solve_idx,
                                     live, out, copy_rows=cache is not None)
        except BaseException as e:
            if cache is not None:
                for i in solve_idx:
                    cache.abort(keys[i], e)
            raise
        if cache is not None:
            for i in solve_idx:
                cache.commit(keys[i], out[i], out[i].nbytes())
        for i, lead in aliases:
            out[i] = out[lead]
        if waits:
            # A parked waiter must not outlive its request's deadline.
            dl = current_deadline()
            budget = None if dl is None else max(0.0, dl - time.monotonic())
            for i, flight in waits:
                out[i] = cache.wait(flight, budget)
        return out

    def _solve_problems(self, problems, pts_list, counts, solve_idx, live,
                        out, *, copy_rows: bool) -> None:
        """Snap + grouped solves + :class:`RoadLegs` for the selected
        problems. ``copy_rows`` detaches each problem's rows from the
        group's arrays so a cached entry never pins a whole group."""
        sel_counts = [counts[i] for i in solve_idx]
        offsets = np.concatenate([[0], np.cumsum(sel_counts)])
        all_pts = np.concatenate([pts_list[i] for i in solve_idx], axis=0)
        # snap() builds an (M, N) haversine table: chunk its rows.
        snap_chunk = max(1, (16 << 20) // max(self.n_nodes, 1))
        all_nodes = np.concatenate([
            self.snap(all_pts[i:i + snap_chunk])
            for i in range(0, len(all_pts), snap_chunk)])
        # First/last mile: the point↔snapped-node gap is charged into
        # every leg (at collector free-flow for the duration).
        all_snap = haversine_np(
            all_pts[:, 0], all_pts[:, 1],
            self.coords[all_nodes, 0],
            self.coords[all_nodes, 1]).astype(np.float32)

        budget = _legs_batch_row_budget(self.n_nodes)
        groups: List[List[int]] = []
        cur: List[int] = []
        rows = 0
        for j, m in enumerate(sel_counts):
            if cur and rows + m > budget:
                groups.append(cur)
                cur, rows = [], 0
            cur.append(j)
            rows += m
        if cur:
            groups.append(cur)

        def _rows(a, lo, hi):
            return a[lo:hi].copy() if copy_rows else a[lo:hi]

        for g in groups:
            sel = np.concatenate([np.arange(offsets[j], offsets[j + 1])
                                  for j in g])
            dist, pred = self.shortest(all_nodes[sel], live=live)
            meters = (self._meters_along(pred, dist)
                      if live is not None and live.route else None)
            pos = 0
            for j in g:
                i = solve_idx[j]
                m = sel_counts[j]
                _, time_scale, hour = problems[i]
                eff_hour = 12 if hour is None else int(hour) % 24
                if live is not None:
                    # Live pricing: the legs' per-edge seconds ARE the
                    # installed metric (hour blending happened at flip
                    # time), so solves, leg durations and the export
                    # stay coherent.
                    time_arr = live.time_s
                    cost_model = f"live+{self.leg_cost_model}"
                else:
                    time_arr = self.edge_time_s(eff_hour)
                    cost_model = self.leg_cost_model
                out[i] = RoadLegs(
                    self, pts_list[i],
                    all_nodes[offsets[j]:offsets[j + 1]],
                    _rows(dist, pos, pos + m), _rows(pred, pos, pos + m),
                    all_snap[offsets[j]:offsets[j + 1]],
                    time_scale, time_arr, cost_model, hour=eff_hour,
                    meters_rows=(_rows(meters, pos, pos + m)
                                 if meters is not None else None))
                pos += m


_SNAP_SPEED_MPS = 8.3  # first/last-mile charged at collector free-flow


def _legs_batch_row_budget(n_nodes: int) -> int:
    """Max source rows per grouped batch solve: bounds each dist f32 +
    pred i32 fetch to ~64 MB whatever the graph size (clamped so tiny
    graphs still group generously and huge ones keep ≥16 rows)."""
    return max(16, min(512, (64 << 20) // (8 * max(n_nodes, 1))))


class RoadLegs:
    """Lazy, memoized per-leg view over one batched shortest-path solve."""

    def __init__(self, router: RoadRouter, points: np.ndarray,
                 nodes: np.ndarray, dist: np.ndarray, pred: np.ndarray,
                 snap_m: np.ndarray, time_scale: float,
                 time_s: Optional[np.ndarray] = None,
                 cost_model: str = "freeflow",
                 hour: int = 12,
                 meters_rows: Optional[np.ndarray] = None) -> None:
        self._r = router
        self._hour = hour
        self._points = points
        self._nodes = nodes
        self._pred = pred
        self._snap_m = snap_m
        self._time_scale = time_scale
        self._time_s = time_s if time_s is not None else router.freeflow_time_s
        self.cost_model = cost_model
        # Live-metric solves are TIME-shortest: ``dist`` rows are
        # seconds and ``meters_rows`` carries the meters recovered along
        # those trees — distance fields stay in meters whatever metric
        # chose the paths.
        self._live_metric = meters_rows is not None
        m = len(points)
        # Full matrix (the VRP input): graph distance + first/last mile.
        phys = meters_rows if meters_rows is not None else dist
        self.dist_m = phys[np.arange(m)[:, None], nodes[None, :]] \
            + snap_m[:, None] + snap_m[None, :]
        np.fill_diagonal(self.dist_m, 0.0)
        self._dist_rows = dist            # (M, N): duration_matrix masks by it
        self._dur_rows: Optional[np.ndarray] = None
        self._memo: Dict[Tuple[int, int], Tuple[float, float, list]] = {}
        self._cost_memo: Dict[Tuple[int, int], Tuple[float, float]] = {}

    def nbytes(self) -> int:
        """Resident bytes a cached entry pins (the route fast lane's
        byte-budget input) — the (M, N) solve rows dominate."""
        n = self._pred.nbytes + self._dist_rows.nbytes + self.dist_m.nbytes
        if self._dur_rows is not None:
            n += self._dur_rows.nbytes
        return int(n)

    def _walk_cost(self, i: int, j: int):
        """Memoized (node_seq, distance_m, duration_s) for leg i→j: ONE
        place owns the walk and the duration formula. ``node_seq`` is []
        when unreachable."""
        cached = self._cost_memo.get((i, j))
        if cached is not None:
            return cached
        node_seq = self._r._walk(self._pred[i], int(self._nodes[i]),
                                 int(self._nodes[j]))
        if not node_seq:
            out = ([], float("inf"), float("inf"))
        else:
            # pred[i][b] is by construction the edge that enters b here
            dur = self._time_scale * (
                float(sum(self._time_s[int(self._pred[i][b])]
                          for b in node_seq[1:]))
                + (self._snap_m[i] + self._snap_m[j]) / _SNAP_SPEED_MPS)
            out = (node_seq, float(self.dist_m[i, j]), float(dur))
        self._cost_memo[(i, j)] = out
        return out

    def reprice_trips(self, trips) -> Dict[Tuple[int, int], float]:
        """Route-context leg durations from the route transformer:
        ``{(i, j): duration_s}`` per leg of the solved trips (stop-index
        lists), or ``{}`` when no transformer serves this graph or a leg
        is unwalkable (callers keep base pricing)."""
        per_trip = self._reprice([[int(s) for s in t] for t in trips])
        if per_trip is None:
            return {}
        out: Dict[Tuple[int, int], float] = {}
        for legs in per_trip:
            out.update(legs)
        return out

    def reprice_orders(self, orders):
        """Transformer durations for candidate single-trip orders → list
        of total route seconds (None per order when unavailable)."""
        per_trip = self._reprice([[int(s) for s in o] for o in orders])
        if per_trip is None:
            return [None] * len(orders)
        return [sum(d for _, d in legs.items()) for legs in per_trip]

    def _reprice(self, trips):
        """Shared core: trips → ``{(i, j): duration_s}`` per trip, or
        None. Each trip's legs concatenate into one edge sequence
        (origin → stops → origin), chunked into ``seq_len`` windows with
        window-local positions (the training distribution), and priced
        in ONE forward on the router's device."""
        t = self._r._transformer
        if t is None or not trips:
            return None
        if self._live_metric:
            # The transformer was trained on the frozen world; letting
            # it re-price would overwrite the live durations the metric
            # flip just installed. Base (live) pricing stands.
            return None
        model, seq_len = t
        r = self._r
        trip_legs: list = []   # per trip: [((a, b), [edge ids]), ...]
        for trip in trips:
            seq = [0] + [s + 1 for s in trip] + [0]
            legs = []
            for a, b in zip(seq[:-1], seq[1:]):
                if a == b:
                    continue
                node_seq, _m, _s = self._walk_cost(a, b)
                if not node_seq:
                    return None  # unwalkable leg: keep base pricing
                legs.append(((a, b),
                             [int(self._pred[a][n]) for n in node_seq[1:]]))
            trip_legs.append(legs)

        windows: list = []   # (trip_idx, [edge ids])
        for ti, legs in enumerate(trip_legs):
            edges = [e for _, leg_edges in legs for e in leg_edges]
            for start in range(0, len(edges), seq_len):
                windows.append((ti, edges[start: start + seq_len]))
        if not windows:
            return [dict() for _ in trip_legs]
        s_max = max(len(w) for _, w in windows)
        feats = np.zeros((len(windows), s_max, model.n_features), np.float32)
        freeflow = np.zeros((len(windows), s_max), np.float32)
        mask = np.zeros((len(windows), s_max), np.float32)
        for wi, (_, edges) in enumerate(windows):
            e_ids = np.asarray(edges, np.int64)
            k = len(e_ids)
            feats[wi, :k] = edge_feature_array(
                r.length_m[e_ids], r.speed_limit[e_ids],
                r.road_class[e_ids], self._hour)
            freeflow[wi, :k] = r.freeflow_time_s[e_ids]
            mask[wi, :k] = 1.0
        dev = r.device
        try:
            pred = model(torch.from_numpy(feats).to(dev),
                         torch.from_numpy(freeflow).to(dev),
                         torch.arange(s_max, device=dev),
                         key_mask=torch.from_numpy(mask).to(dev)
                         ).float().cpu().numpy()
        except Exception as e:  # degrade to base pricing, drop the model
            _log.error("route_transformer_apply_failed",
                       error=f"{type(e).__name__}: {e}")
            with r._model_lock:
                r._transformer = None
            return None

        stream: Dict[int, list] = {ti: [] for ti in range(len(trip_legs))}
        for wi, (ti, edges) in enumerate(windows):
            stream[ti].extend(pred[wi, : len(edges)].tolist())
        out: list = []
        for ti, legs in enumerate(trip_legs):
            flat = stream[ti]
            offset = 0
            priced: Dict[Tuple[int, int], float] = {}
            for (a, b), edges in legs:
                k = len(edges)
                e_ids = np.asarray(edges, np.int64)
                # Same physical floor as the GNN pricer.
                leg_pred = np.maximum(
                    np.asarray(flat[offset: offset + k], np.float32),
                    r.length_m[e_ids] / 16.7)
                offset += k
                priced[(a, b)] = float(self._time_scale * (
                    float(leg_pred.sum())
                    + (self._snap_m[a] + self._snap_m[b]) / _SNAP_SPEED_MPS))
            out.append(priced)
        return out

    def cost(self, i: int, j: int) -> Tuple[float, float]:
        """(distance_m, duration_s) for waypoint leg i→j without the
        polyline; same memoized walk as :meth:`leg`."""
        if i == j:
            return 0.0, 0.0
        _, dist_m, dur = self._walk_cost(i, j)
        return dist_m, dur

    def duration_matrix(self) -> np.ndarray:
        """(M, M) leg seconds for every waypoint pair from one device
        table (``_time_table``), computed once per solve. Values match
        the per-pair walk to f32 rounding (the sums re-associate)."""
        if self._dur_rows is None:
            self._dur_rows = self._r._tree_table(self._pred, self._time_s,
                                                 self._dist_rows)
        dur = self._dur_rows[:, self._nodes].astype(np.float64)
        dur = self._time_scale * (
            dur + (self._snap_m[:, None] + self._snap_m[None, :])
            / _SNAP_SPEED_MPS)
        np.fill_diagonal(dur, 0.0)
        return dur

    def leg(self, i: int, j: int) -> Tuple[float, float, List[List[float]]]:
        """(distance_m, duration_s, [[lon, lat], …]) for waypoint leg i→j."""
        if i == j:
            return 0.0, 0.0, []
        key = (i, j)
        if key in self._memo:
            return self._memo[key]
        node_seq, dist_m, dur = self._walk_cost(i, j)
        if not node_seq:
            out = (float("inf"), float("inf"), [])
        else:
            poly = [[float(self._r.coords[n, 1]), float(self._r.coords[n, 0])]
                    for n in node_seq]
            # endpoints: exact request coordinates, not snapped nodes
            poly.insert(0, [float(self._points[i, 1]), float(self._points[i, 0])])
            poly.append([float(self._points[j, 1]), float(self._points[j, 0])])
            out = (dist_m, dur, poly)
        self._memo[key] = out
        return out


# Process-wide routers, one per device ("cuda", "cpu"), built on first use.
_default_routers: Dict[str, RoadRouter] = {}
_default_lock = threading.Lock()


def default_router(device=None) -> RoadRouter:
    """The process-wide router on ``device``: a real OSM extract when
    ``ROAD_GRAPH_OSM`` points at one (``data/osm.py``), else the
    generated Metro Manila network. A bad extract degrades to the
    generator with a log line rather than taking down routing."""
    dev = resolve_device(device, "default_router")
    key = str(dev)
    with _default_lock:
        router = _default_routers.get(key)
        if router is None:
            osm_path = os.environ.get("ROAD_GRAPH_OSM")
            if osm_path:
                from routest_tpu_torch.data.osm import load_osm

                try:
                    router = RoadRouter(graph=load_osm(osm_path), device=dev)
                except Exception as e:
                    _log.error("osm_extract_unusable", path=osm_path,
                               error=f"{type(e).__name__}: {e}")
            if router is None:
                router = RoadRouter(device=dev)
            _default_routers[key] = router
        return router
