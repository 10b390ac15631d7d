"""Multi-level partition overlay for metro-scale shortest paths, as
PyTorch ops on the router's device.

The counterpart of ``routest_tpu/optimize/hierarchy.py``: the same
nested recursive-bisection partition, degree-2 chain contraction,
per-level boundary tables and pruned cliques, hub labels over the top
overlay, the v4 cache format, and the same query (ascend, top, tiered
descend stitch, chain synthesis). Host parts (partition, contraction,
packing, the cache file) are copies of the JAX package's numpy code;
device parts are torch ops that the JAX package runs as ``jit``
programs, called eagerly here. :meth:`HierarchicalIndex.customize`
re-prices a built or loaded overlay against a live metric from the same
structure. The solve is a program of straight-line segments between its
host-checked relax loops (:meth:`HierarchicalIndex.full_solve_steps`):
run eagerly here, or captured per source bucket as CUDA graphs by the
router on the card (``serve/graphs.py``), the JAX package's per-bucket
AOT programs.

Every float operation on the device is a min, a single float32 add or
subtract, or the one multiply ``T * (1 + slack)`` of
:func:`_prune_cliques`; none depends on summation order. So index
payloads and query answers equal the JAX package's bit for bit, on any
device. What that takes:

- **Sentinels.** ``_INF`` (3e38, finite) where the reference fills with
  it, true ``inf`` only where ``segment_min`` of an empty segment would
  produce it and nothing reads it unclamped; pads route to the same dump
  slots (``c_max``, ``n_top``, ``n_contracted``, ``n_nodes``).
- **Scatters.** ``.at[...].min`` becomes ``scatter_reduce("amin",
  include_self=True)``; ``segment_min`` followed by ``minimum(dist, ·)``
  becomes the same scatter into ``dist``; a ``segment_min`` read without
  that ``minimum`` scatters into ``+inf``. ``.at[...].set`` with an index
  past the end (which JAX drops) writes into an extra dump column.
- **Index dtypes.** Payload arrays and the cache file keep the
  reference's dtypes (int32 ids); the device copies are int64, as torch
  indexing wants.

Each relaxation loop checks convergence on the host once per
``_K_SWEEPS`` sweeps (one device sync); ``relax_from`` and
:func:`_relax_ell` count their calls, sweeps and checks, :func:`polish`
its calls and sweeps, for ``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from routest_tpu_torch.core.config import resolve_device
from routest_tpu_torch.serve.graphs import Loop, drive, run_steps

_INF = 3e38
_INF_NP = np.float32(3e38)
# Sweeps between host checks: the check is a device sync, which
# dominates small graphs (the JAX package's constant).
_K_SWEEPS = 4

# v4: v3 (customization structure) + hub labels (the precomputed
# all-pairs top-overlay distance table), the chain FILL structure
# (direction-start offsets + last-hop edges that let the solve
# synthesize full-graph distances/predecessors from a contracted
# solve), and the contracted level-0 edge arrays the polish/predecessor
# sweeps now run over. The JAX package writes and reads the same format.
_CACHE_VERSION = 4


def _log():
    from routest_tpu_torch.utils.logging import get_logger

    return get_logger("routest.hier")


def _dev_i64(a, device) -> torch.Tensor:
    """Host ids → an int64 tensor on ``device`` (torch indexes with
    int64; payloads keep their own dtype)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.int64))).to(device)


def _dev_f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32))).to(device)


def _inf(shape, device) -> torch.Tensor:
    return torch.full(shape, _INF, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Shared flat-relaxation primitives (road_router builds on these too).
# ---------------------------------------------------------------------------

def _seg_min(values: torch.Tensor, index: torch.Tensor,
             init: torch.Tensor) -> torch.Tensor:
    """``min(init, segment_min(values))`` per row: (S, E) values folded
    by receiver ``index`` (E,) into a copy of the (S, N) ``init``."""
    idx = index.expand(values.shape[0], -1)
    return init.scatter_reduce(1, idx, values, "amin", include_self=True)


def _bf_sweeps(dist: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_K_SWEEPS`` Bellman-Ford sweeps of the (S, N) table ``dist`` →
    (new table, device flag: did any entry fall). One chunk of
    :func:`relax_from`'s loop, and of a captured overlay solve's."""
    new = dist
    for _ in range(_K_SWEEPS):
        proposals = new.index_select(1, senders) + w[None, :]
        new = _seg_min(proposals, receivers, new)
    return new, (new < dist).any()


def relax_from(senders: torch.Tensor, receivers: torch.Tensor,
               w: torch.Tensor, dist0: torch.Tensor, *, max_iters: int
               ) -> Tuple[torch.Tensor, bool]:
    """Bellman-Ford sweeps from the (S, N) table ``dist0`` over
    receiver-sorted edges → (relaxed table, converged): converged is
    True iff a round of sweeps changed nothing, False when
    ``max_iters`` was reached first (the distances are then partial).

    A sweep is ``min(dist, segment_min(dist[:, senders] + w))``; the
    ``segment_min`` is a ``scatter_reduce`` (``"amin"``, ``include_self``)
    into a copy of ``dist``, which absorbs JAX's empty-segment ``+inf``
    the same way the ``min`` with ``dist`` does. The host checks once
    per :func:`_bf_sweeps` chunk (:func:`drive`)."""
    box = [dist0]

    def chunk():
        box[0], changed = _bf_sweeps(box[0], senders, receivers, w)
        return changed

    changed = drive(relax_from, max_iters, _K_SWEEPS, chunk)
    return box[0], not changed


relax_from.calls = 0
relax_from.sweeps = 0
relax_from.checks = 0


def polish(senders: torch.Tensor, receivers: torch.Tensor, w: torch.Tensor,
           dist: torch.Tensor, *, n_sweeps: int) -> torch.Tensor:
    """``n_sweeps`` relaxation sweeps with no convergence check (so no
    host sync). Overlay distances are already exact; what predecessor
    recovery needs is that every node's value was *assigned* from a
    ``dist[s] + w`` proposal so the minimal-slack edge is ~0 bitwise —
    one sweep re-anchors that, a second covers senders that moved in the
    first."""
    polish.calls += 1
    for _ in range(n_sweeps):
        proposals = dist.index_select(1, senders) + w[None, :]
        dist = _seg_min(proposals, receivers, dist)
    polish.sweeps += n_sweeps
    return dist


polish.calls = 0
polish.sweeps = 0


def tight_edges(senders: torch.Tensor, receivers: torch.Tensor,
                w: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Predecessor recovery from a converged table: per node, the
    entering edge of minimal slack ``dist[s] + w - dist[r]`` (within a
    1 cm merge slack), preferring the strictly closest sender, then the
    largest sorted edge id; -1 where no edge enters. Same evaluation
    order as the JAX ``tight_edges``, so the same ids come out."""
    n_src, n_nodes = dist.shape
    d_s = dist.index_select(1, senders)
    slack = d_s + w[None, :] - dist.index_select(1, receivers)
    inf = torch.full((n_src, n_nodes), float("inf"), dtype=dist.dtype,
                     device=dist.device)
    min_slack = _seg_min(slack, receivers, inf)
    tight = slack <= min_slack.index_select(1, receivers) + 1e-2
    sd = torch.where(tight, d_s, torch.full_like(d_s, _INF))
    best_sd = _seg_min(sd, receivers, inf)
    pick = tight & (sd <= best_sd.index_select(1, receivers))
    e_ids = torch.arange(senders.shape[0], device=dist.device)
    cand = torch.where(pick, e_ids[None, :], -1)
    init = torch.full((n_src, n_nodes), -1, dtype=torch.int64,
                      device=dist.device)
    return init.scatter_reduce(1, receivers.expand(n_src, -1), cand, "amax",
                               include_self=True)


def tight_pred(senders: torch.Tensor, receivers: torch.Tensor,
               w: torch.Tensor, dist: torch.Tensor,
               sources: torch.Tensor) -> torch.Tensor:
    """:func:`tight_edges` with each row's source set to -1."""
    pred = tight_edges(senders, receivers, w, dist)
    pred[torch.arange(dist.shape[0], device=dist.device), sources] = -1
    return pred


def _build_labels(top_s: np.ndarray, top_r: np.ndarray, top_w: np.ndarray,
                  n_top: int, device) -> Tuple[np.ndarray, Dict]:
    """Hub labels: the exact all-pairs distance table over the top
    overlay graph, an identity-seeded :func:`relax_from` over every top
    boundary node (the per-query top BF with its source axis widened).
    Rows chunk to bound the (rows, E) proposal tensor, each chunk the
    same shape, pad rows re-solving node 0. Returns the (n_top, n_top)
    f32 table + build stats. Exact by the level-stack induction, so the
    query's fold ``min_b(seed[s, b] + labels[b, v])`` is the top BF's
    fixed point."""
    t0 = time.perf_counter()
    e_top = max(1, len(top_s))
    chunk = int(np.clip((256 << 20) // (4 * e_top), 64, n_top))
    d_s = _dev_i64(top_s, device)
    d_r = _dev_i64(top_r, device)
    d_w = _dev_f32(top_w, device)
    labels = np.empty((n_top, n_top), np.float32)
    for lo in range(0, n_top, chunk):
        hi = min(lo + chunk, n_top)
        d0 = np.full((chunk, n_top), _INF_NP, np.float32)
        d0[np.arange(hi - lo), lo + np.arange(hi - lo)] = 0.0
        d0[hi - lo:, 0] = 0.0          # pad rows: harmless re-solves
        out, _ = relax_from(d_s, d_r, d_w, _dev_f32(d0, device),
                            max_iters=n_top + _K_SWEEPS)
        labels[lo:hi] = out[: hi - lo].cpu().numpy()
    stats = {
        "nodes": int(n_top),
        "bytes": int(labels.nbytes),
        "build_s": round(time.perf_counter() - t0, 3),
    }
    return labels, stats


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------

def partition_cells_nested(
        coords: np.ndarray,
        targets: Sequence[int]) -> List[Tuple[np.ndarray, int]]:
    """(N, 2) coords + finest-first cell-size targets → one (N,) cell
    assignment per level, finest first, **nested**: every level-(k+1)
    cell is a union of level-k cells, because all levels are cuts of
    the SAME recursive-median-bisection tree at different size
    thresholds. Cells are size-balanced (≤ target) and geometrically
    compact, which keeps boundary sets small — the quantity every
    overlay cost scales with."""
    n = len(coords)
    L = len(targets)
    cells = [np.zeros(n, np.int32) for _ in range(L)]
    counts = [0] * L
    stack: List[Tuple[np.ndarray, int]] = [(np.arange(n), L - 1)]
    while stack:
        idx, lvl = stack.pop()
        if len(idx) <= targets[lvl]:
            cells[lvl][idx] = counts[lvl]
            counts[lvl] += 1
            if lvl > 0:
                stack.append((idx, lvl - 1))
            continue
        c = coords[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        stack.append((idx[order[:half]], lvl))
        stack.append((idx[order[half:]], lvl))
    return [(cells[k], counts[k]) for k in range(L)]


def partition_cells(coords: np.ndarray,
                    cell_target: int) -> Tuple[np.ndarray, int]:
    """Single-level cut of the bisection tree (the multi-level
    machinery with one threshold)."""
    (cell, n_cells), = partition_cells_nested(
        np.asarray(coords, np.float32), [cell_target])
    return cell, n_cells


def _level_targets(n: int, cell_target: Optional[int] = None,
                   max_levels: Optional[int] = None) -> List[int]:
    """Finest-first cell-size ladder. Each coarser level groups ~ratio
    finer cells; levels stack while the next one would still have ≥ 4
    cells — past that the top overlay BF is already tiny."""
    if cell_target is None:
        try:
            cell_target = int(
                os.environ.get("ROUTEST_HIER_CELL_TARGET", "0") or 0)
        except ValueError:
            cell_target = 0
    # Hub labels change the balance at the top: the top phase is a
    # precomputed table fold instead of an iterative BF, so the ladder
    # no longer needs to stop while the top is still large enough to
    # matter — it should instead use SMALLER level-1 cells (every
    # query phase is cheaper in small cells; the top grows, but the
    # fold doesn't care) and stack GENTLER (ratio-4) levels until the
    # top fits the label budget. Measured at 250k: 1.45√n cells cut
    # the non-top query phases 225→154 ms vs the 2.2√n BF balance.
    labels_on = _labels_max() > 0
    if not cell_target:
        # Balance the phases: cell work ~ c, overlay hops ~ sqrt(N/c).
        cell_target = max(160, int((1.45 if labels_on else 2.2)
                                   * np.sqrt(n)))
    try:
        ratio = int(os.environ.get("ROUTEST_HIER_RATIO", "0") or 0)
    except ValueError:
        ratio = 0
    if not ratio:
        ratio = 4 if labels_on else 16
    ratio = max(2, ratio)
    if max_levels is None:
        try:
            max_levels = int(
                os.environ.get("ROUTEST_HIER_MAX_LEVELS", "0") or 0)
        except ValueError:
            max_levels = 0
    max_levels = max_levels or 8
    # With labels the ladder runs all the way down to a 2-cell cut —
    # every extra level shrinks the top boundary, and the label build
    # cost is quadratic-ish in it; without labels a <4-cell level's
    # stitch cost outweighs the top-BF hops it saves.
    min_cells = 1 if labels_on else 4
    targets = [int(cell_target)]
    while (len(targets) < max_levels
           and n // (targets[-1] * ratio) >= min_cells):
        targets.append(targets[-1] * ratio)
    return targets


# Stop stacking levels once the top boundary fits this budget: by
# here the label fold is already cheap, and the next level's cells
# would be few and DENSE (clique-dominated), making its ascend cost
# more than the label-build seconds it saves (measured at 250k: the
# final 2-cell level cost 211 ms of ascend to save 44 s of one-time
# label build).
_LABEL_STOP = 2560


def _labels_max() -> int:
    """Hub labels build when the top overlay has at most this many
    boundary nodes (``ROUTEST_HIER_LABELS``; 0/off disables). The label
    table is (top, top) f32 — 4096 nodes = 64 MB resident and an
    all-pairs device BF at build time — so the cap bounds both."""
    raw = os.environ.get("ROUTEST_HIER_LABELS", "4096").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 4096


def _prune_slack() -> float:
    try:
        return float(os.environ.get("ROUTEST_HIER_PRUNE_SLACK", "2e-7"))
    except ValueError:
        return 2e-7


def _contract_interior() -> int:
    """Max interior nodes per contracted chain segment
    (``ROUTEST_HIER_CONTRACT``; 0 disables contraction). The router's
    polish pass must run at least this many sweeps — that is what fills
    chain-interior distances back in — so the two knobs are coupled in
    ``road_router``."""
    try:
        return max(0, int(os.environ.get("ROUTEST_HIER_CONTRACT", "2")))
    except ValueError:
        return 2


# ---------------------------------------------------------------------------
# Degree-2 chain contraction
# ---------------------------------------------------------------------------

def _contract_chains(coords: np.ndarray, senders: np.ndarray,
                     receivers: np.ndarray, w: np.ndarray,
                     max_interior: int) -> Optional[Dict[str, np.ndarray]]:
    """Collapse degree-2 chains (OSM bend nodes — ~80% of a real street
    extract) into single weighted edges before the overlay is built.

    Every overlay cost scales with the boundary-node count, and bend
    nodes on cell-border streets are boundary nodes that carry zero
    routing information: contracting them shrinks the overlay's node,
    clique and edge counts by the bend ratio (~2.5–6×) while keeping
    the metric EXACT — a chain is a forced path, so its length is a
    constant.

    A node is chain-interior iff it has exactly two distinct neighbors
    and is a pure pass-through (two-way to both, or one-in/one-out
    across them); mixed two-way/one-way junctions, parallel-edge and
    self-loop endpoints stay. Chains longer than ``max_interior`` are
    split (every ``max_interior``-th interior node is promoted) so the
    router's polish sweeps — which re-derive interior distances from
    the contracted solution — need only ``max_interior`` sweeps.
    All-interior cycles (roundabouts) promote their smallest node.

    Returns None when nothing contracts, else:
      ``cid_of``      (N,) contracted id per original node, -1 interior
      ``kept``        (N',) original id per contracted node
      ``c_senders``/``c_receivers``/``c_w`` contracted edge list
      ``seed_node``   (N, 2) contracted ids reachable FROM each
                      original node along its chain (pad -1)
      ``seed_w``      (N, 2) the along-chain cost to each (pad INF)
      ``edge_comp_ptr``/``edge_comp`` ragged ORIGINAL-edge composition
                      per contracted edge — a contracted weight is the
                      sum of its composition under ANY metric, which is
                      what lets :meth:`HierarchicalIndex.customize`
                      re-price the contraction without re-walking it
      ``seed_comp_ptr``/``seed_comp`` same, per (node, slot) seed
    """
    n = len(coords)
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    w = np.asarray(w, np.float32)
    loop = senders == receivers
    out_deg = np.bincount(senders, minlength=n)
    in_deg = np.bincount(receivers, minlength=n)
    # Distinct undirected neighbors + parallel-edge detection.
    a = np.minimum(senders, receivers)
    b = np.maximum(senders, receivers)
    und = np.unique(a * n + b)
    ua, ub = und // n, und % n
    und_deg = np.bincount(ua, minlength=n) + np.bincount(ub, minlength=n)
    ordered, counts = np.unique(senders * n + receivers, return_counts=True)
    dup = ordered[counts > 1]
    blocked = np.zeros(n, bool)
    blocked[senders[loop]] = True
    blocked[(dup // n)] = True
    blocked[(dup % n)] = True
    interior = (~blocked & (und_deg == 2)
                & (((out_deg == 2) & (in_deg == 2))
                   | ((out_deg == 1) & (in_deg == 1))))
    if not interior.any():
        return None

    # Adjacency restricted to edges touching interiors (python walk —
    # chains are short and each interior is visited once). ``eid``
    # remembers WHICH original edge carries each (s, r) hop so chain
    # weights stay re-derivable under a different metric (interior
    # endpoints are never parallel-edge endpoints — those are blocked —
    # so the hop→edge mapping is unique).
    touch = interior[senders] | interior[receivers]
    ew: Dict[Tuple[int, int], float] = {}
    eid: Dict[Tuple[int, int], int] = {}
    for e, s, r, wt in zip(np.flatnonzero(touch), senders[touch],
                           receivers[touch], w[touch]):
        key = (int(s), int(r))
        if key not in ew or wt < ew[key]:
            ew[key] = float(wt)
            eid[key] = int(e)

    # Undirected neighbor map for interiors (both directions known from
    # the degree pattern: 2-2 has adj both ways; 1-1 only forward, so
    # fold the reverse in from the incoming side).
    nbrs: Dict[int, List[int]] = {}
    for s, r in zip(senders[touch], receivers[touch]):
        s, r = int(s), int(r)
        if interior[s]:
            nbrs.setdefault(s, [])
            if r not in nbrs[s]:
                nbrs[s].append(r)
        if interior[r]:
            nbrs.setdefault(r, [])
            if s not in nbrs[r]:
                nbrs[r].append(s)

    promoted = np.zeros(n, bool)
    visited = np.zeros(n, bool)
    chains: List[List[int]] = []
    for v0 in np.flatnonzero(interior):
        v0 = int(v0)
        if visited[v0]:
            continue
        # Expand to both ends.
        chain = [v0]
        visited[v0] = True
        for direction in (0, 1):
            prev, cur = v0, nbrs[v0][direction] if len(
                nbrs[v0]) > direction else None
            if cur is None:
                continue
            while interior[cur] and not visited[cur]:
                visited[cur] = True
                if direction == 0:
                    chain.append(cur)
                else:
                    chain.insert(0, cur)
                nxt = [x for x in nbrs[cur] if x != prev]
                if not nxt:
                    cur = None
                    break
                prev, cur = cur, nxt[0]
            if cur is not None and not interior[cur]:
                if direction == 0:
                    chain.append(cur)
                else:
                    chain.insert(0, cur)
            elif cur is not None and visited[cur] and cur == (
                    chain[0] if direction == 0 else chain[-1]):
                # closed all-interior cycle: break it at the smallest id
                break
        # Ensure endpoints are non-interior; cycles promote min node.
        if interior[chain[0]] and interior[chain[-1]]:
            keep_node = min(chain)
            promoted[keep_node] = True
            i = chain.index(keep_node)
            chain = chain[i:] + chain[:i + 1]
        # Split long runs: promote every max_interior-th interior.
        run = 0
        for node in chain[1:-1]:
            run += 1
            if run > max_interior:
                promoted[node] = True
                run = 0
        chains.append(chain)

    interior &= ~promoted
    cid_of = np.full(n, -1, np.int64)
    kept = np.flatnonzero(~interior)
    cid_of[kept] = np.arange(len(kept))

    # Contracted edges: originals not touching interiors + one summed
    # edge per traversable chain-segment direction.
    keep_edge = ~(interior[senders] | interior[receivers])
    kept_edge_ids = np.flatnonzero(keep_edge)
    c_s = [cid_of[senders[keep_edge]]]
    c_r = [cid_of[receivers[keep_edge]]]
    c_w = [w[keep_edge]]
    chain_edge_comp: List[List[int]] = []      # per chain-emitted edge
    seed_comp: Dict[int, List[int]] = {}       # (node*2 + slot) → edges
    fill_comp: Dict[int, List[int]] = {}       # (node*2 + slot) → edges
    seed_node = np.full((n, 2), -1, np.int64)
    seed_w = np.full((n, 2), np.inf, np.float64)
    seed_last = np.full((n, 2), -1, np.int64)
    seed_node[kept, 0] = cid_of[kept]
    seed_w[kept, 0] = 0.0
    # Fill structure (the inverse of seeds): which contracted node
    # REACHES each interior along its chain, at what along-chain cost,
    # entering through which original edge. The solve uses it to
    # synthesize exact full-graph distances and predecessors from a
    # contracted solve — interiors are never relaxed on device.
    fill_node = np.full((n, 2), -1, np.int64)
    fill_w = np.full((n, 2), np.inf, np.float64)
    fill_last = np.full((n, 2), -1, np.int64)
    fill_dir = np.full((n, 2), -1, np.int64)   # emitted-direction id
    n_dirs = 0

    def emit(seg: List[int]) -> None:
        """One kept→kept segment: summed edges per direction + seed and
        fill entries for its interiors."""
        nonlocal n_dirs
        for s_dir in (0, 1):
            nodes = seg if s_dir == 0 else seg[::-1]
            total = 0.0
            ok = True
            partial = [0.0]
            hop_ids: List[int] = []
            for x, y in zip(nodes[:-1], nodes[1:]):
                wt = ew.get((x, y))
                if wt is None:
                    ok = False
                    break
                total += wt
                partial.append(total)
                hop_ids.append(eid[(x, y)])
            if not ok:
                continue
            c_s.append(np.asarray([cid_of[nodes[0]]]))
            c_r.append(np.asarray([cid_of[nodes[-1]]]))
            c_w.append(np.asarray([total], np.float32))
            chain_edge_comp.append(hop_ids)
            dir_id = n_dirs
            n_dirs += 1
            # Seeds: every interior can reach the segment's END in this
            # direction at cost (total - partial). Fill: the segment's
            # START reaches every interior at cost partial, entering
            # through hop i-1.
            for i, node in enumerate(nodes[1:-1], start=1):
                slot = 0 if seed_node[node, 0] < 0 else 1
                seed_node[node, slot] = cid_of[nodes[-1]]
                seed_w[node, slot] = total - partial[i]
                seed_last[node, slot] = hop_ids[-1]
                seed_comp[node * 2 + slot] = hop_ids[i:]
                fill_node[node, slot] = cid_of[nodes[0]]
                fill_w[node, slot] = partial[i]
                fill_last[node, slot] = hop_ids[i - 1]
                fill_dir[node, slot] = dir_id
                fill_comp[node * 2 + slot] = hop_ids[:i]

    for chain in chains:
        seg: List[int] = [chain[0]]
        for node in chain[1:]:
            seg.append(node)
            if not interior[node]:
                if len(seg) > 1:
                    emit(seg)
                seg = [node]
        if len(seg) > 1:
            emit(seg)

    c_senders = np.concatenate(c_s)
    c_receivers = np.concatenate(c_r)
    c_weights = np.concatenate(c_w).astype(np.float32)
    # Ragged composition arrays: kept originals are singleton
    # compositions (vectorized block), chain edges append their hop
    # lists in emit order — aligned with c_senders.
    chain_lens = np.asarray([len(ids) for ids in chain_edge_comp],
                            np.int64)
    k0 = len(kept_edge_ids)
    edge_comp_ptr = np.concatenate([
        np.arange(k0 + 1, dtype=np.int64),
        k0 + np.cumsum(chain_lens)])
    edge_comp = np.concatenate(
        [kept_edge_ids]
        + [np.asarray(ids, np.int64) for ids in chain_edge_comp]
        if chain_edge_comp else [kept_edge_ids]).astype(np.int64)
    def _ragged(comp: Dict[int, List[int]]):
        lens = np.zeros(2 * n, np.int64)
        for slot_key, ids in comp.items():
            lens[slot_key] = len(ids)
        ptr = np.zeros(2 * n + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        flat = np.zeros(int(ptr[-1]), np.int64)
        for slot_key, ids in comp.items():
            lo = ptr[slot_key]
            flat[lo:lo + len(ids)] = ids
        return ptr, flat

    seed_comp_ptr, seed_comp_flat = _ragged(seed_comp)
    fill_comp_ptr, fill_comp_flat = _ragged(fill_comp)
    return {
        "cid_of": cid_of, "kept": kept,
        "c_senders": c_senders, "c_receivers": c_receivers,
        "c_w": c_weights,
        "seed_node": seed_node.astype(np.int64),
        "seed_w": np.where(np.isfinite(seed_w), seed_w,
                           _INF_NP).astype(np.float32),
        "seed_last": seed_last,
        "fill_node": fill_node, "fill_last": fill_last,
        "fill_dir": fill_dir,
        "fill_w": np.where(np.isfinite(fill_w), fill_w,
                           _INF_NP).astype(np.float32),
        "edge_comp_ptr": edge_comp_ptr,
        "edge_comp": edge_comp,
        "seed_comp_ptr": seed_comp_ptr,
        "seed_comp": seed_comp_flat,
        "fill_comp_ptr": fill_comp_ptr,
        "fill_comp": fill_comp_flat,
    }


def _pack_ell_flat(senders: np.ndarray, receivers: np.ndarray,
                   w: np.ndarray, tags: np.ndarray, n_nodes: int):
    """Receiver-sorted flat edge list → width-8 ELL minirows
    ``(m, W) senders/weights/tags + (m,) receivers`` (the
    :func:`_ell_pack` layout for ONE graph instead of per-cell).
    ``tags`` rides along per lane (pad -1) — the fused solve stores
    the ORIGINAL entering edge there so predecessor recovery needs no
    later remap. Pad lanes carry (0, INF, -1); pad minirows receive
    into ``n_nodes - 1`` (sorted order kept, INF never wins)."""
    E = len(senders)
    if E == 0:
        return (np.zeros((1, _ELL_W), np.int32),
                np.full((1, _ELL_W), _INF_NP, np.float32),
                np.full((1, _ELL_W), -1, np.int32),
                np.full((1,), max(n_nodes - 1, 0), np.int32))
    new_run = np.empty(E, bool)
    new_run[0] = True
    new_run[1:] = receivers[1:] != receivers[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(E), 0))
    rank = np.arange(E) - run_start
    new_mini = new_run | (rank % _ELL_W == 0)
    mini_id = np.cumsum(new_mini) - 1
    lane = rank % _ELL_W
    m = int(mini_id[-1]) + 1
    ell_s = np.zeros((m, _ELL_W), np.int32)
    ell_w = np.full((m, _ELL_W), _INF_NP, np.float32)
    ell_t = np.full((m, _ELL_W), -1, np.int32)
    ell_r = np.full((m,), max(n_nodes - 1, 0), np.int32)
    ell_s[mini_id, lane] = senders
    ell_w[mini_id, lane] = w
    ell_t[mini_id, lane] = tags
    ell_r[mini_id] = receivers
    return ell_s, ell_w, ell_t, ell_r


def _identity_fill(n: int) -> Dict[str, np.ndarray]:
    """Fill structure of an uncontracted graph: no interiors, every
    slot a pad — the synthesis stage degenerates to the kept-node
    gather."""
    ids = np.full((n, 2), -1, np.int64)
    return {"node": ids, "w": np.full((n, 2), _INF_NP, np.float32),
            "last": ids.copy(), "dir": ids.copy(),
            "seed_last": ids.copy()}


# ---------------------------------------------------------------------------
# Batched within-cell relaxation (precompute + query ascend)
# ---------------------------------------------------------------------------


def _relax_blockdiag(cs: torch.Tensor, cr: torch.Tensor, cw: torch.Tensor,
                     dist0: torch.Tensor, *, c_max: int,
                     max_iters: int) -> torch.Tensor:
    """Restricted Bellman-Ford inside many cells at once, as ONE
    block-diagonal graph.

    ``cs``/``cr``/``cw``: (G, e_max) cell-local edge arrays, sorted by
    local receiver, padded with (0, c_max-1, INF) edges whose proposals
    can never win. ``dist0``: (R, G*c_max) distance rows laid out
    cell-major. Offsetting each cell's local ids by ``g*c_max`` turns
    the G independent cells into one graph, so each sweep is one wide
    gather and one scatter-min (:func:`relax_from`)."""
    G = cs.shape[0]
    offs = (torch.arange(G, device=cs.device) * c_max)[:, None]
    s_flat = (cs + offs).reshape(-1)
    r_flat = (cr + offs).reshape(-1)
    w_flat = cw.reshape(-1)
    dist, _ = relax_from(s_flat, r_flat, w_flat, dist0, max_iters=max_iters)
    return dist


# ELL minirow width: per-receiver edge runs pad to multiples of this
# and reduce densely. 8 keeps street-node padding waste ≤ ~40% while
# cutting the (single-row) segment reduction to m_max elements.
_ELL_W = 8


def _ell_pack(ie_cell: np.ndarray, ie_s: np.ndarray, ie_r: np.ndarray,
              ie_w: np.ndarray, P: int,
              c_max: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cell-grouped receiver-sorted edges → per-cell ELL minirows:
    ``(P, m_max, W)`` senders/weights + ``(P, m_max)`` minirow
    receivers. Each receiver's edge run is chunked into width-W
    minirows, so a query sweep is one dense ``(m, W)`` gather+min (the
    fast layout at ANY row count) followed by a segment-min over only
    ``m ≈ E/W`` elements instead of E. Pad lanes carry (0, INF); pad
    minirows receive into local ``c_max - 1`` (sorted order kept, INF
    never wins)."""
    E = len(ie_cell)
    if E == 0:
        return (np.zeros((P, 1, _ELL_W), np.int32),
                np.full((P, 1, _ELL_W), _INF_NP, np.float32),
                np.full((P, 1), max(c_max - 1, 0), np.int32))
    key = ie_cell.astype(np.int64) * c_max + ie_r
    new_run = np.empty(E, bool)
    new_run[0] = True
    new_run[1:] = key[1:] != key[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(E), 0))
    rank = np.arange(E) - run_start
    new_mini = new_run | (rank % _ELL_W == 0)
    mini_id = np.cumsum(new_mini) - 1                 # global minirow id
    lane = rank % _ELL_W
    mini_cell = ie_cell[new_mini]
    m_counts = np.bincount(mini_cell, minlength=P)
    m_max = max(1, int(m_counts.max()))
    m_starts = np.zeros(P + 1, np.int64)
    np.cumsum(m_counts, out=m_starts[1:])
    mini_local = mini_id - m_starts[ie_cell]
    ell_s = np.zeros((P, m_max, _ELL_W), np.int32)
    ell_w = np.full((P, m_max, _ELL_W), _INF_NP, np.float32)
    ell_r = np.full((P, m_max), max(c_max - 1, 0), np.int32)
    ell_s[ie_cell, mini_local, lane] = ie_s
    ell_w[ie_cell, mini_local, lane] = ie_w
    ell_r[ie_cell, mini_local] = ie_r
    return ell_s, ell_w, ell_r


def _ell_prep(es: torch.Tensor, ew_: torch.Tensor, er: torch.Tensor,
              c_max: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ELL-packed cells (``es``/``ew_``: (S, m_max, W), ``er``: (S,
    m_max)) → one block-diagonal layout over the flat (S*c_max,) table:
    (sender ids, receiver minirow ids, (S*m_max, W) weights)."""
    S, m_max, W = es.shape
    offs = torch.arange(S, device=es.device) * c_max
    return ((es + offs[:, None, None]).reshape(-1),
            (er + offs[:, None]).reshape(-1),
            ew_.reshape(S * m_max, W))


def _ell_sweeps(dist: torch.Tensor, ell
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_K_SWEEPS`` sweeps of :func:`_relax_ell` over the flat table →
    (new table, device flag: did any entry fall). Per sweep: a dense
    (S*m, W) gather + lane min, then a scatter-min over the S*m
    minirows into the table."""
    s_flat, r_flat, w_flat = ell
    new = dist
    for _ in range(_K_SWEEPS):
        prop = (new.index_select(0, s_flat).view(w_flat.shape)
                + w_flat).amin(dim=1)
        new = new.scatter_reduce(0, r_flat, prop, "amin",
                                 include_self=True)
    return new, (new < dist).any()


def _relax_ell(es: torch.Tensor, ew_: torch.Tensor, er: torch.Tensor,
               dist0: torch.Tensor, *, c_max: int,
               max_iters: int) -> torch.Tensor:
    """Block-diagonal restricted Bellman-Ford over ELL-packed cells —
    the query layout (one selected cell per source). ``es``/``ew_``:
    (S, m_max, W); ``er``: (S, m_max); ``dist0``: (S, c_max). Chunks of
    :func:`_ell_sweeps`, a host check after each (:func:`drive`)."""
    ell = _ell_prep(es, ew_, er, c_max)
    box = [dist0.reshape(-1)]

    def chunk():
        box[0], changed = _ell_sweeps(box[0], ell)
        return changed

    drive(_relax_ell, max_iters, _K_SWEEPS, chunk)
    return box[0].reshape(dist0.shape[0], c_max)


_relax_ell.calls = 0
_relax_ell.sweeps = 0
_relax_ell.checks = 0


def _cell_all_pairs(ces: np.ndarray, cer: np.ndarray, cew: np.ndarray,
                    sizes: np.ndarray, c_max: int, device) -> np.ndarray:
    """(P, c_max, c_max) EXACT in-cell all-pairs tables — the
    dense-level ascend's precompute. High overlay levels are
    clique-dominated (hundreds of edges per node), so the per-query
    in-cell relaxation that is cheap at street density is costly there;
    with the full table the ascend is a fold over the entry seeds
    instead. Identity-seeded restricted BF per cell, source-chunked to
    bound the (rows, E) proposal tensor; rows at or beyond the cell's
    size are masked INF."""
    P, e_max = ces.shape
    pt = np.empty((P, c_max, c_max), np.float32)
    chunk = int(np.clip((192 << 20) // (4 * max(e_max, c_max, 1)),
                        32, c_max))
    for p in range(P):
        d_s = _dev_i64(ces[p], device)
        d_r = _dev_i64(cer[p], device)
        d_w = _dev_f32(cew[p], device)
        for lo in range(0, c_max, chunk):
            hi = min(lo + chunk, c_max)
            d0 = np.full((chunk, c_max), _INF_NP, np.float32)
            d0[np.arange(hi - lo), lo + np.arange(hi - lo)] = 0.0
            d0[hi - lo:, 0] = 0.0      # pad rows: harmless re-solves
            out, _ = relax_from(d_s, d_r, d_w, _dev_f32(d0, device),
                                max_iters=c_max + _K_SWEEPS)
            pt[p, lo:hi] = out[: hi - lo].cpu().numpy()
        pt[p, sizes[p]:] = _INF_NP
    return pt


def _prune_cliques(T: torch.Tensor, *, slack: float = 2e-7) -> torch.Tensor:
    """(P, b, b) restricted boundary metric → keep mask for clique
    edges. An edge (i, j) is *implied* when some third boundary node k
    gives ``T[i,k] + T[k,j] ≤ T[i,j]`` (within ``slack``): the overlay
    metric closure is unchanged by dropping it, because T is itself the
    restricted metric (triangle inequality holds), both legs are
    strictly shorter than the whole (legs below 1 m are excluded so the
    induction bottoms out), and the implication chain therefore
    terminates at kept edges.

    ``slack`` trades exactness for edge count: a pruned near-tie's
    traffic reroutes over a bypass at most ``(1+slack)`` longer; at the
    default ~2 ulps the inflation stays inside float32 rounding
    (``ROUTEST_HIER_PRUNE_SLACK``). The JAX package's ``fori_loop`` over
    k is a Python loop here; the ``< 1.0`` guard and the
    ``T * (1 + slack)`` compare are as written there."""
    P, b, _ = T.shape
    via = torch.full_like(T, _INF)
    for k in range(b):
        a = T[:, :, k].clone()
        a[:, k] = _INF                                # exclude i == k
        a = torch.where(a < 1.0, _INF, a)             # zero-length guard
        c = T[:, k, :].clone()
        c[:, k] = _INF                                # exclude j == k
        c = torch.where(c < 1.0, _INF, c)
        via = torch.minimum(via, a[:, :, None] + c[:, None, :])
    implied = via <= T * (1 + slack)
    finite = T < 1e37
    eye = torch.eye(b, dtype=torch.bool, device=T.device)[None]
    return finite & ~eye & ~implied


# ---------------------------------------------------------------------------
# One level of the stack
# ---------------------------------------------------------------------------

_LEVEL_KEYS = ("cell", "local_of_node", "src_cell", "ell_s", "ell_w",
               "ell_r", "bl", "cbo", "table", "perm_of_node", "b_global")


def _stitch_tiers(bcounts: np.ndarray, max_tiers: int = 4,
                  min_cells: int = 8) -> Tuple[Tuple[int, int, int], ...]:
    """Cells are build-ordered by DESCENDING boundary count; split them
    into ≤ ``max_tiers`` contiguous ranges, each folding only its own
    max boundary count. The descend stitch then pays
    Σ tier_cells × tier_b instead of P × b_max — and trailing
    boundary-free cells (disconnected pockets) cost zero iterations."""
    P = len(bcounts)
    tiers: List[Tuple[int, int, int]] = []
    lo = 0
    while lo < P:
        bb = int(bcounts[lo])
        if bb == 0 or len(tiers) == max_tiers - 1:
            tiers.append((lo, P, bb))
            break
        hi = lo + 1
        while hi < P and (int(bcounts[hi]) * 2 > bb or hi - lo < min_cells):
            hi += 1
        tiers.append((lo, hi, bb))
        lo = hi
    return tuple(tiers)


def _table_chunk(P: int, b_max: int, e_max: int, c_max: int) -> int:
    """Cells per batched precompute dispatch, from a ~256 MB budget on
    the (chunk, b_max, max(e_max, c_max)) proposal tensor: big graphs
    chunk to bound memory, small ones batch the whole level in one
    dispatch instead of 64-cell driblets (the 1M-node build spent most
    of its wall time on dispatch count, not FLOPs)."""
    per_cell = 4 * max(b_max, 1) * max(e_max, c_max, 1)
    return int(np.clip((256 << 20) // per_cell, 8, max(P, 8)))


class _Level:
    """One level: its payload (host numpy, the reference's dtypes),
    device tensors on ``device`` and query metadata."""

    def __init__(self, p: Dict[str, np.ndarray], stats: Dict,
                 device) -> None:
        self.device = device
        self._payload = {name: np.asarray(p[name]) for name in _LEVEL_KEYS}
        pt = p.get("pt")
        if pt is not None:
            self._payload["pt"] = np.asarray(pt)
        self.cell = self._payload["cell"]
        self.local_of_node = self._payload["local_of_node"]
        self.src_cell = self._payload["src_cell"]
        self.b_global = self._payload["b_global"]
        P, b_max = p["cbo"].shape
        self.n_cells = P
        self.b_max = b_max
        self.c_max = int(p["table"].shape[2])
        self.n_overlay = int(len(p["b_global"]))
        self.d_ell_s = _dev_i64(p["ell_s"], device)
        self.d_ell_w = _dev_f32(p["ell_w"], device)
        self.d_ell_r = _dev_i64(p["ell_r"], device)
        self.d_bl = _dev_i64(p["bl"], device)
        self.d_cbo = _dev_i64(p["cbo"], device)
        self.d_table = _dev_f32(p["table"], device)
        self.d_perm = _dev_i64(p["perm_of_node"], device)
        # Dense-level all-pairs table (+ one INF pad row per cell so
        # pad entry positions fold to INF); None at street density.
        self.d_pt = (_dev_f32(np.concatenate(
            [pt, np.full((pt.shape[0], 1, self.c_max), _INF_NP,
                         np.float32)], axis=1), device)
            if pt is not None else None)
        # G_{k-1}-node → local slot, padded with a dump slot (= c_max)
        # so the next level's seed scatter can route pad entries there.
        self.d_local_pad = _dev_i64(np.concatenate(
            [np.asarray(p["local_of_node"], np.int64),
             np.asarray([self.c_max], np.int64)]), device)
        bcounts = (np.asarray(p["cbo"]) < self.n_overlay).sum(axis=1)
        self.tiers = _stitch_tiers(bcounts)
        self.stats = stats

    def payload(self) -> Dict[str, np.ndarray]:
        return dict(self._payload)


def _build_level(senders: np.ndarray, receivers: np.ndarray, w: np.ndarray,
                 cell: np.ndarray, n_cells: int, *,
                 chunk_cells: Optional[int] = None,
                 prune_slack: float = 2e-7,
                 device=None) -> Optional[Tuple[Dict, Dict, Tuple]]:
    """One overlay level over an arbitrary input graph: cell-grouped
    edge arrays, boundary tables, pruned cliques. Returns
    ``(payload, stats, (ovl_s, ovl_r, ovl_w))`` — the overlay graph is
    the next level's input — or None when the level cannot help (a
    single cell, or no cell-crossing edges)."""
    n = len(cell)
    P = int(n_cells)
    if P < 2:
        return None
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    w = np.asarray(w, np.float32)

    s_cell, r_cell = cell[senders], cell[receivers]
    internal = s_cell == r_cell
    cross = np.flatnonzero(~internal)
    if len(cross) == 0:
        return None

    # Boundary nodes: endpoints of cell-crossing edges. Cells are
    # RENUMBERED by descending boundary count so the descend stitch can
    # run in contiguous tiers (``_stitch_tiers``).
    is_b = np.zeros(n, bool)
    is_b[senders[cross]] = True
    is_b[receivers[cross]] = True
    bcounts_raw = np.bincount(cell[is_b], minlength=P)
    remap = np.empty(P, np.int32)
    remap[np.argsort(-bcounts_raw, kind="stable")] = np.arange(
        P, dtype=np.int32)
    cell = remap[cell]
    s_cell, r_cell = cell[senders], cell[receivers]

    order = np.argsort(cell, kind="stable")
    sizes = np.bincount(cell, minlength=P)
    starts = np.zeros(P + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    c_max = int(sizes.max())
    local_of_node = np.empty(n, np.int32)
    local_of_node[order] = (np.arange(n) - starts[cell[order]]).astype(
        np.int32)

    # Internal edges, grouped by cell and sorted by local receiver.
    ie = np.flatnonzero(internal)
    ie_cell = s_cell[ie]
    ie_s = local_of_node[senders[ie]]
    ie_r = local_of_node[receivers[ie]]
    ie_w = w[ie]
    eorder = np.lexsort((ie_r, ie_cell))
    ie_cell, ie_s, ie_r, ie_w = (a[eorder] for a in (ie_cell, ie_s, ie_r,
                                                     ie_w))
    ecounts = np.bincount(ie_cell, minlength=P)
    e_max = max(1, int(ecounts.max()))
    ces = np.zeros((P, e_max), np.int32)
    cer = np.full((P, e_max), c_max - 1, np.int32)
    cew = np.full((P, e_max), _INF_NP, np.float32)
    estarts = np.zeros(P + 1, np.int64)
    np.cumsum(ecounts, out=estarts[1:])
    flat_pos = np.arange(len(ie)) - estarts[ie_cell]
    ces[ie_cell, flat_pos] = ie_s
    cer[ie_cell, flat_pos] = ie_r
    cew[ie_cell, flat_pos] = ie_w

    b_global = order[is_b[order]]            # cell-grouped boundary list
    b_cell = cell[b_global]
    bcounts = np.bincount(b_cell, minlength=P)
    b_max = int(bcounts.max())
    B = len(b_global)
    bstarts = np.zeros(P + 1, np.int64)
    np.cumsum(bcounts, out=bstarts[1:])
    b_pos = np.arange(B) - bstarts[b_cell]
    bl = np.zeros((P, b_max), np.int32)      # local idx, pad 0 (masked later)
    bl[b_cell, b_pos] = local_of_node[b_global]
    ovl_of_node = np.full(n, -1, np.int64)
    ovl_of_node[b_global] = np.arange(B)
    cbo = np.full((P, b_max), B, np.int32)   # overlay id, pad B (= INF slot)
    cbo[b_cell, b_pos] = np.arange(B)

    # Batched in-cell tables. Clique-DENSE levels (≥ 64 edges/node —
    # upper overlay levels, never street-density level 1) build the
    # FULL in-cell all-pairs table instead: the boundary table is a
    # row subset of it, and the query's ascend into such a cell
    # becomes a fold over the table rather than a relaxation over
    # hundreds of thousands of clique edges per request.
    t_pt = time.perf_counter()
    pt: Optional[np.ndarray] = None
    if (e_max >= 64 * c_max
            and P * c_max * c_max * 4 <= (512 << 20)):
        pt = _cell_all_pairs(ces, cer, cew, sizes, c_max, device)
        table = np.ascontiguousarray(
            pt[np.arange(P)[:, None], bl, :])
        row = np.arange(b_max)[None, :]
        table[row >= bcounts[:, None]] = _INF_NP
    else:
        # Chunked so the (chunk, b_max, e_max) proposal tensor stays
        # bounded whatever the graph size — and so small levels run in
        # ONE batched relaxation rather than many.
        if chunk_cells is None:
            chunk_cells = _table_chunk(P, b_max, e_max, c_max)
        chunk_cells = min(chunk_cells, P)
        table = np.empty((P, b_max, c_max), np.float32)
        max_iters = c_max + _K_SWEEPS
        for lo in range(0, P, chunk_cells):
            hi = min(lo + chunk_cells, P)
            pad = chunk_cells - (hi - lo)
            g_ces = np.concatenate([ces[lo:hi],
                                    np.zeros((pad, e_max), np.int32)])
            g_cer = np.concatenate([cer[lo:hi],
                                    np.full((pad, e_max), c_max - 1,
                                            np.int32)])
            g_cew = np.concatenate([cew[lo:hi],
                                    np.full((pad, e_max), _INF_NP,
                                            np.float32)])
            g_bl = np.concatenate([bl[lo:hi],
                                   np.zeros((pad, b_max), np.int32)])
            # Row b of the block-flat table seeds boundary b of EVERY
            # cell in the chunk at once: (b_max, chunk*c_max).
            d0 = _inf((b_max, chunk_cells * c_max), device)
            pos = (np.arange(chunk_cells, dtype=np.int64)[:, None] * c_max
                   + g_bl).T                              # (b_max, chunk)
            d0[torch.arange(b_max, device=device)[:, None],
               _dev_i64(pos, device)] = 0.0
            out = _relax_blockdiag(_dev_i64(g_ces, device),
                                   _dev_i64(g_cer, device),
                                   _dev_f32(g_cew, device), d0,
                                   c_max=c_max, max_iters=max_iters)
            out = out.cpu().numpy().reshape(b_max, chunk_cells, c_max)
            table[lo:hi] = out.transpose(1, 0, 2)[: hi - lo]
        # Pad boundary rows carry garbage (seeded at local 0): mask.
        row = np.arange(b_max)[None, :]
        table[row >= bcounts[:, None]] = _INF_NP

    # Cliques: the boundary↔boundary submatrix of each table.
    T = table[np.arange(P)[:, None, None],
              np.arange(b_max)[None, :, None], bl[:, None, :]]
    T = np.where((row[..., None] >= bcounts[:, None, None])
                 | (row[:, None, :] >= bcounts[:, None, None]),
                 _INF_NP, T)
    keep = _prune_cliques(_dev_f32(T, device),
                          slack=prune_slack).cpu().numpy()
    candidates = ((T < 1e37) & ~np.eye(b_max, dtype=bool)[None])
    kp, ki, kj = np.nonzero(keep)
    clique_s = cbo[kp, ki].astype(np.int64)
    clique_r = cbo[kp, kj].astype(np.int64)
    clique_w = T[kp, ki, kj]

    # Overlay graph: pruned cliques + the original crossing edges.
    ovl_s = np.concatenate([clique_s, ovl_of_node[senders[cross]]])
    ovl_r = np.concatenate([clique_r, ovl_of_node[receivers[cross]]])
    ovl_w = np.concatenate([clique_w, w[cross]]).astype(np.float32)
    oorder = np.argsort(ovl_r, kind="stable")
    ovl_s = ovl_s[oorder].astype(np.int32)
    ovl_r = ovl_r[oorder].astype(np.int32)
    ovl_w = ovl_w[oorder]

    ell_s, ell_w, ell_r = _ell_pack(ie_cell, ie_s, ie_r, ie_w, P, c_max)
    perm_of_node = (cell.astype(np.int64) * c_max
                    + local_of_node).astype(np.int32)
    stats = {
        "n_nodes": n, "n_cells": P, "c_max": c_max, "b_max": b_max,
        "n_overlay_nodes": B, "n_overlay_edges": int(len(ovl_s)),
        "clique_edges_kept": int(len(clique_s)),
        "clique_edges_pruned": int(candidates.sum() - keep.sum()),
    }
    payload = {
        "cell": cell.astype(np.int32), "local_of_node": local_of_node,
        "ell_s": ell_s, "ell_w": ell_w, "ell_r": ell_r,
        "bl": bl, "cbo": cbo,
        "table": table, "perm_of_node": perm_of_node,
        "b_global": b_global.astype(np.int64),
        "cell_remap": remap,
    }
    if pt is not None:
        payload["pt"] = pt
        stats["pt"] = {"bytes": int(pt.nbytes),
                       "build_s": round(time.perf_counter() - t_pt, 3)}
    return payload, stats, (ovl_s, ovl_r, ovl_w)


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------

class HierarchicalIndex:
    """Built once per graph; answers batched exact multi-source
    shortest-path distance queries in O(top-cells-across) device sweeps
    regardless of node count. Lives on its levels' device."""

    def __init__(self, levels: List[_Level], top_s: np.ndarray,
                 top_r: np.ndarray, top_w: np.ndarray, stats: Dict, *,
                 expand_idx: np.ndarray, seed_node: np.ndarray,
                 seed_w: np.ndarray, l0: Optional[Dict] = None,
                 fill: Optional[Dict] = None,
                 labels: Optional[np.ndarray] = None) -> None:
        self.levels = levels
        self.n_levels = len(levels)
        l1 = levels[0]
        dev = self.device = l1.device
        self.cell = l1.cell
        self.n_cells = l1.n_cells
        self.local_of_node = l1.local_of_node
        self.c_max = l1.c_max
        self.b_max = l1.b_max
        self.n_overlay = l1.n_overlay
        self.n_top = levels[-1].n_overlay
        # Chain contraction mapping: the overlay lives on the
        # contracted graph; ``expand_idx`` gathers contracted rows back
        # to full-graph node order (pad slot = INF), ``seed_node``/
        # ``seed_w`` turn an arbitrary full-graph source into ≤2
        # (contracted node, along-chain offset) seeds.
        self._expand_idx = np.asarray(expand_idx, np.int64)
        self._seed_node = np.asarray(seed_node, np.int64)
        self._seed_w = np.asarray(seed_w, np.float32)
        self.n_contracted = len(l1.cell)
        self.n_nodes = len(expand_idx)
        self._contracted = self.n_nodes != self.n_contracted or bool(
            (self._expand_idx != np.arange(self.n_nodes)).any())
        self._d_expand = _dev_i64(np.where(
            self._expand_idx >= 0, self._expand_idx, self.n_contracted), dev)
        # contracted node → its G_k overlay id per level (-1 when the
        # node is not a level-k boundary node) — seed entry lookup.
        gk = [np.arange(self.n_contracted, dtype=np.int64)]
        for lvl in levels:
            inv = np.full(len(lvl.cell), -1, np.int64)
            inv[lvl.b_global] = np.arange(lvl.n_overlay)
            prev = gk[-1]
            gk.append(np.where(prev >= 0, inv[np.maximum(prev, 0)], -1))
        self._gk = gk
        self._top_s = np.asarray(top_s, np.int32)
        self._top_r = np.asarray(top_r, np.int32)
        self._top_w = np.asarray(top_w, np.float32)
        self._d_top_s = _dev_i64(self._top_s, dev)
        self._d_top_r = _dev_i64(self._top_r, dev)
        self._d_top_w = _dev_f32(self._top_w, dev)
        # Hub labels: the exact all-pairs top-overlay table. When
        # present the query's top stage is one gather-fold over the
        # source's top-cell boundary seeds; when absent the iterative
        # top BF runs (same answers — the table IS its fixed point).
        self._labels = (np.asarray(labels, np.float32)
                        if labels is not None else None)
        self._d_labels = (_dev_f32(self._labels, dev)
                          if self._labels is not None else None)
        # Level-0 (contracted) edge arrays: what the full solve's
        # polish + predecessor sweeps run over, as width-8 ELL minirows
        # whose lane tags carry the ORIGINAL edge entering the receiver
        # (``edge_last``), so recovered predecessors need no remap.
        self._l0 = l0
        self._fill = fill
        if l0 is not None:
            l0_r = np.asarray(l0["receivers"], np.int64)
            perm = np.argsort(l0_r, kind="stable")
            s_sorted = np.asarray(l0["senders"],
                                  np.int64)[perm].astype(np.int32)
            r_sorted = l0_r[perm].astype(np.int32)
            w_sorted = np.asarray(l0["w"], np.float32)[perm]
            last_sorted = np.asarray(l0["edge_last"],
                                     np.int64)[perm].astype(np.int32)
            es, ew_, et, er = _pack_ell_flat(s_sorted, r_sorted, w_sorted,
                                             last_sorted, self.n_contracted)
            self._d_l0_ell = (_dev_i64(es, dev), _dev_f32(ew_, dev),
                              _dev_i64(et, dev), _dev_i64(er, dev))
        if fill is not None:
            nc = self.n_contracted

            def _pad_ids(a):
                a = np.asarray(a, np.int64)
                return _dev_i64(np.where(a >= 0, a, nc), dev)

            self._d_fill_node = _pad_ids(fill["node"])
            self._d_fill_w = _dev_f32(fill["w"], dev)
            self._d_fill_last = _dev_i64(fill["last"], dev)
            self._d_fill_dir = _dev_i64(fill["dir"], dev)
            self._d_seed_node_full = _pad_ids(self._seed_node)
            self._d_seed_w_full = _dev_f32(self._seed_w, dev)
            self._d_seed_last = _dev_i64(fill["seed_last"], dev)
            # Direction tables for the interior-source same-segment
            # correction: each emitted chain direction carries at most
            # ``interior_cap`` interiors, so the correction is a
            # handful of per-source scatters over (n_dirs, k_max)
            # tables instead of dense (S, N) compare passes. Pad row =
            # n_dirs, pad node id = n_nodes — writes there land in the
            # solve's dump column.
            fd = np.asarray(fill["dir"], np.int64)
            fw_np = np.asarray(fill["w"], np.float32)
            fl_np = np.asarray(fill["last"], np.int64)
            mask = fd >= 0
            self._n_dirs = int(fd.max()) + 1 if mask.any() else 0
            kmax = 1
            dir_nodes = np.full((self._n_dirs + 1, 1), self.n_nodes,
                                np.int64)
            dir_w = np.full((self._n_dirs + 1, 1), _INF_NP, np.float32)
            dir_last = np.full((self._n_dirs + 1, 1), -1, np.int64)
            if self._n_dirs:
                vv, ss = np.nonzero(mask)
                dd = fd[vv, ss]
                order = np.argsort(dd, kind="stable")
                dd, vv, ss = dd[order], vv[order], ss[order]
                counts = np.bincount(dd, minlength=self._n_dirs)
                kmax = max(1, int(counts.max()))
                starts = np.zeros(self._n_dirs + 1, np.int64)
                np.cumsum(counts, out=starts[1:])
                ranks = np.arange(len(dd)) - starts[dd]
                dir_nodes = np.full((self._n_dirs + 1, kmax),
                                    self.n_nodes, np.int64)
                dir_w = np.full((self._n_dirs + 1, kmax), _INF_NP,
                                np.float32)
                dir_last = np.full((self._n_dirs + 1, kmax), -1, np.int64)
                dir_nodes[dd, ranks] = vv
                dir_w[dd, ranks] = fw_np[vv, ss]
                dir_last[dd, ranks] = fl_np[vv, ss]
            self._dir_kmax = kmax
            self._d_dir_nodes = _dev_i64(dir_nodes, dev)
            self._d_dir_w = _dev_f32(dir_w, dev)
            self._d_dir_last = _dev_i64(dir_last, dev)
        self.stats = stats
        # Topology-only customization structure (partition-tree cuts +
        # contraction composition), attached by ``build``/``load`` and
        # written to the cache so either package's ``customize`` can
        # re-price a loaded index; None for indexes constructed directly.
        self._structure: Optional[Dict] = None
        self.query_fn = self._build_query()

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, coords: np.ndarray, senders: np.ndarray,
              receivers: np.ndarray, w: np.ndarray, *,
              cell_target: Optional[int] = None,
              cell_targets: Optional[Sequence[int]] = None,
              max_levels: Optional[int] = None,
              chunk_cells: Optional[int] = None,
              cache_path: Optional[str] = None,
              fingerprint: Optional[Dict] = None,
              device=None) -> Optional["HierarchicalIndex"]:
        """Returns None when the graph is too small to benefit (a
        single cell, or no cell-crossing edges). With ``cache_path``,
        the host-side payload is written there (npz) before device
        upload so later processes skip the whole precompute
        (:meth:`load` — metro-extract serving spawns N workers, and
        each would otherwise pay the batched in-cell relaxation);
        ``fingerprint`` (the router's graph fingerprint) is embedded so
        a loaded payload is bound to ITS graph by content, not by the
        predictable cache filename. ``cell_targets`` (finest first)
        overrides the auto ladder — tests force deep stacks on small
        graphs with it. ``device``: where the index lives (the router's
        device; ``cuda`` unless the caller asks for the CPU)."""
        device = resolve_device(device, "HierarchicalIndex")
        t0 = time.perf_counter()
        n_full = len(coords)
        coords = np.asarray(coords, np.float32)
        senders = np.asarray(senders, np.int64)
        receivers = np.asarray(receivers, np.int64)
        w = np.asarray(w, np.float32)
        # Degree-2 chain contraction: the overlay is built on the
        # contracted graph (intersections + chain shortcuts), which
        # shrinks every boundary-scaled cost by the bend ratio.
        interior_cap = _contract_interior()
        contraction = (_contract_chains(coords, senders, receivers, w,
                                        interior_cap)
                       if interior_cap else None)
        if contraction is not None:
            kept = contraction["kept"]
            c_coords = coords[kept]
            g_s = contraction["c_senders"]
            g_r = contraction["c_receivers"]
            g_w = contraction["c_w"]
            expand_idx = contraction["cid_of"]
            seed_node = contraction["seed_node"]
            seed_w = contraction["seed_w"]
            edge_last = contraction["edge_comp"][
                contraction["edge_comp_ptr"][1:] - 1]
            fill = {"node": contraction["fill_node"],
                    "w": contraction["fill_w"],
                    "last": contraction["fill_last"],
                    "dir": contraction["fill_dir"],
                    "seed_last": contraction["seed_last"]}
        else:
            c_coords = coords
            g_s, g_r, g_w = senders, receivers, w
            expand_idx = np.arange(n_full, dtype=np.int64)
            seed_node = np.stack([np.arange(n_full, dtype=np.int64),
                                  np.full(n_full, -1, np.int64)], axis=1)
            seed_w = np.stack([np.zeros(n_full, np.float32),
                               np.full(n_full, _INF_NP, np.float32)], axis=1)
            edge_last = np.arange(len(g_s), dtype=np.int64)
            fill = _identity_fill(n_full)
        l0 = {"senders": np.asarray(g_s, np.int64),
              "receivers": np.asarray(g_r, np.int64),
              "w": np.asarray(g_w, np.float32),
              "edge_last": edge_last}
        n = len(c_coords)
        contract_s = round(time.perf_counter() - t0, 3)
        auto_ladder = cell_targets is None
        if cell_targets is None:
            cell_targets = _level_targets(n, cell_target,
                                          max_levels=max_levels)
        t_part = time.perf_counter()
        parts = partition_cells_nested(c_coords,
                                       [int(t) for t in cell_targets])
        partition_s = round(time.perf_counter() - t_part, 3)
        # Everything a metric customization can reuse: the level-0 input
        # topology, the bisection-tree cuts, and the contraction's
        # original-edge composition. All of it is weight-independent —
        # re-pricing starts from here and skips the contraction walk and
        # the partition entirely (the CRP customization/offline split).
        structure: Dict = {
            "c_senders": np.asarray(g_s, np.int64),
            "c_receivers": np.asarray(g_r, np.int64),
            "parts": [(np.asarray(c0, np.int32), int(P))
                      for c0, P in parts],
        }
        if contraction is not None:
            for key in ("edge_comp_ptr", "edge_comp",
                        "seed_comp_ptr", "seed_comp",
                        "fill_comp_ptr", "fill_comp"):
                structure[key] = contraction[key]
        prune_slack = _prune_slack()
        lmax = _labels_max()
        # Early label-stop applies only to the auto ladder: explicit
        # ``cell_targets`` (tests forcing deep stacks) build every
        # requested level. ``B * 8 <= n`` keeps small auto builds
        # multi-level too — the stop exists to skip DENSE top levels
        # at scale, not to flatten every small graph to one level.
        label_stop = min(lmax, _LABEL_STOP) if lmax and auto_ladder else 0
        node_origin = np.arange(n)        # current-graph node → G0 node
        levels: List[_Level] = []
        for li, (cell0, P) in enumerate(parts):
            t_lvl = time.perf_counter()
            built = _build_level(g_s, g_r, g_w,
                                 cell0[node_origin].astype(np.int32), P,
                                 chunk_cells=chunk_cells,
                                 prune_slack=prune_slack,
                                 device=device)
            if built is None:
                if li == 0:
                    return None
                break
            payload, lstats, ovl = built
            B = len(payload["b_global"])
            stalled = (B >= len(node_origin) if lmax
                       else 2 * B > len(node_origin))
            if li > 0 and stalled:
                # The overlay stopped shrinking — another level would
                # cost more stitch work than its BF saves. With labels
                # on, ANY shrink is worth stacking: the top phase is a
                # table fold (not a BF whose hop count the level must
                # pay back), and every node shaved off the top cuts
                # the all-pairs label build quadratically.
                break
            # Source lookup: G0 node → this level's (renumbered) cell.
            payload["src_cell"] = payload["cell_remap"][
                cell0].astype(np.int32)
            lstats["level"] = li + 1
            lstats["build_s"] = round(time.perf_counter() - t_lvl, 3)
            levels.append(_Level(payload, lstats, device))
            g_s, g_r, g_w = ovl
            node_origin = node_origin[payload["b_global"]]
            if label_stop and B <= label_stop and B * 8 <= n:
                break
        if not levels:
            return None

        # Hub labels over the top overlay: built with the same batched
        # relaxation the per-query top BF runs, so the table is exact
        # and the query's top phase becomes a fold over it. Skipped
        # (with the BF kept as the serving path) when the top is bigger
        # than the label budget or the knob is off.
        labels = None
        n_top = levels[-1].n_overlay
        label_stats: Optional[Dict] = None
        if lmax and 2 <= n_top <= lmax and len(g_s):
            labels, label_stats = _build_labels(g_s, g_r, g_w, n_top,
                                                device)

        l1 = levels[0].stats
        stats = {
            # Legacy single-level keys = level 1 (health/test consumers).
            "n_cells": l1["n_cells"], "c_max": l1["c_max"],
            "b_max": l1["b_max"],
            "n_overlay_nodes": l1["n_overlay_nodes"],
            "n_overlay_edges": l1["n_overlay_edges"],
            "clique_edges_kept": l1["clique_edges_kept"],
            "clique_edges_pruned": l1["clique_edges_pruned"],
            "n_levels": len(levels),
            "top_nodes": levels[-1].n_overlay,
            "top_edges": int(len(g_s)),
            "prune_slack": prune_slack,
            "partition_s": partition_s,
            "contraction": {
                "interior_cap": interior_cap,
                "n_full": n_full, "n_contracted": n,
                "contract_s": contract_s,
            },
            "levels": [dict(lvl.stats) for lvl in levels],
            "build_s": 0.0,
        }
        if label_stats is not None:
            stats["labels"] = label_stats
        index = cls(levels, g_s, g_r, g_w, stats,
                    expand_idx=expand_idx, seed_node=seed_node,
                    seed_w=seed_w, l0=l0, fill=fill, labels=labels)
        index._structure = structure
        stats["build_s"] = round(time.perf_counter() - t0, 3)
        if cache_path:
            index._save(cache_path, fingerprint)
        return index

    # -- metric customization (CRP-style re-pricing) ----------------------

    def customize(self, w_full: np.ndarray) -> "HierarchicalIndex":
        """Re-price this overlay against a NEW per-edge metric without
        rebuilding its structure — the CRP metric-customization phase
        (JAX ``HierarchicalIndex.customize``).

        ``w_full`` is the full-graph edge weight array (same edge order
        as the ``senders``/``receivers`` the index was built from; any
        positive metric). Reused as-is: the bisection-tree cuts, the
        chain-contraction walk (new chain weights are composition sums
        over ``w_full``, in float64 as in the JAX package), every
        level's cell membership and boundary sets. Recomputed on the
        index's device: in-cell boundary tables, clique pruning and
        overlay weights (``_build_level``), and the hub labels.

        Returns a NEW index on the same device (the current one keeps
        serving — callers flip atomically); raises ``ValueError`` when
        the index carries no structure (direct construction)."""
        s = self._structure
        if s is None:
            raise ValueError(
                "index has no customization structure (built by an "
                "older cache version? rebuild the overlay)")
        t0 = time.perf_counter()
        device = self.device
        w_full = np.asarray(w_full, np.float32)
        ecp = s.get("edge_comp_ptr")
        if ecp is not None:
            # Chain-contracted graph: contracted edge k's weight is the
            # sum of its original-edge composition; seed and fill
            # offsets likewise (cumulative-sum ragged reduction: empty
            # segments sum to 0).
            comp = s["edge_comp"]
            cs = np.concatenate([
                [0.0], np.cumsum(w_full[comp], dtype=np.float64)])
            g_w = (cs[ecp[1:]] - cs[ecp[:-1]]).astype(np.float32)
            scp = s["seed_comp_ptr"]
            scs = np.concatenate([
                [0.0], np.cumsum(w_full[s["seed_comp"]],
                                 dtype=np.float64)])
            seed_sums = (scs[scp[1:]] - scs[scp[:-1]]).reshape(-1, 2)
            seed_w = np.where(self._seed_node >= 0, seed_sums,
                              _INF_NP).astype(np.float32)
            fcp = s["fill_comp_ptr"]
            fcs = np.concatenate([
                [0.0], np.cumsum(w_full[s["fill_comp"]],
                                 dtype=np.float64)])
            fill_sums = (fcs[fcp[1:]] - fcs[fcp[:-1]]).reshape(-1, 2)
            fill = dict(self._fill or _identity_fill(len(w_full)))
            fill["w"] = np.where(
                np.asarray(fill["node"]) >= 0, fill_sums,
                _INF_NP).astype(np.float32)
        else:
            g_w = w_full
            seed_w = self._seed_w  # identity contraction: col0 = 0,
            #                        col1 = INF — weight-independent
            fill = self._fill      # all pads — weight-independent
        g_s = s["c_senders"]
        g_r = s["c_receivers"]
        g_w0 = g_w                 # level-0 weights, before the loop
        #                            rebinds g_w to overlay weights
        prune_slack = float(self.stats.get("prune_slack", _prune_slack()))
        lmax = _labels_max()
        node_origin = np.arange(len(self.levels[0].cell))
        levels: List[_Level] = []
        for li, (cell0, P) in enumerate(s["parts"]):
            t_lvl = time.perf_counter()
            built = _build_level(g_s, g_r, g_w,
                                 cell0[node_origin].astype(np.int32), P,
                                 prune_slack=prune_slack, device=device)
            if built is None:
                if li == 0:
                    raise ValueError("customization built no levels — "
                                     "graph/structure mismatch")
                break
            payload, lstats, ovl = built
            B = len(payload["b_global"])
            stalled = (B >= len(node_origin) if lmax
                       else 2 * B > len(node_origin))
            if li > 0 and stalled:
                break
            payload["src_cell"] = payload["cell_remap"][
                cell0].astype(np.int32)
            lstats["level"] = li + 1
            lstats["build_s"] = round(time.perf_counter() - t_lvl, 3)
            levels.append(_Level(payload, lstats, device))
            g_s, g_r, g_w = ovl
            node_origin = node_origin[payload["b_global"]]
            if (lmax and B <= min(lmax, _LABEL_STOP)
                    and B * 8 <= len(self.levels[0].cell)):
                break
        # Re-price the labels too (same build, new top weights): a
        # live-metric flip then keeps the fold path instead of falling
        # back to the iterative top BF.
        labels = None
        n_top = levels[-1].n_overlay
        label_stats: Optional[Dict] = None
        if lmax and 2 <= n_top <= lmax and len(g_s):
            labels, label_stats = _build_labels(g_s, g_r, g_w, n_top,
                                                device)
        l1 = levels[0].stats
        stats = {
            "n_cells": l1["n_cells"], "c_max": l1["c_max"],
            "b_max": l1["b_max"],
            "n_overlay_nodes": l1["n_overlay_nodes"],
            "n_overlay_edges": l1["n_overlay_edges"],
            "clique_edges_kept": l1["clique_edges_kept"],
            "clique_edges_pruned": l1["clique_edges_pruned"],
            "n_levels": len(levels),
            "top_nodes": levels[-1].n_overlay,
            "top_edges": int(len(g_s)),
            "prune_slack": prune_slack,
            "partition_s": 0.0,        # reused — that is the point
            "contraction": dict(self.stats.get("contraction", {})),
            "levels": [dict(lvl.stats) for lvl in levels],
            "customized": True,
            "full_build_s": self.stats.get("build_s", 0.0),
        }
        if label_stats is not None:
            stats["labels"] = label_stats
        l0 = dict(self._l0) if self._l0 is not None else None
        if l0 is not None:
            l0["w"] = np.asarray(g_w0, np.float32)
        out = type(self)(levels, g_s, g_r, g_w, stats,
                         expand_idx=self._expand_idx,
                         seed_node=self._seed_node, seed_w=seed_w,
                         l0=l0, fill=fill, labels=labels)
        out._structure = s
        stats["build_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _save(self, cache_path: str, fingerprint: Optional[Dict]) -> None:
        flat: Dict[str, np.ndarray] = {
            "top_s": self._top_s, "top_r": self._top_r, "top_w": self._top_w,
            "expand_idx": self._expand_idx,
            "seed_node": self._seed_node, "seed_w": self._seed_w,
        }
        if self._labels is not None:
            flat["labels"] = self._labels
        if self._l0 is not None:
            for name in ("senders", "receivers", "w", "edge_last"):
                flat[f"g0_{name}"] = np.asarray(self._l0[name])
        if self._fill is not None:
            for name in ("node", "w", "last", "dir", "seed_last"):
                flat[f"fill_{name}"] = np.asarray(self._fill[name])
        for k, lvl in enumerate(self.levels):
            p = lvl.payload()
            for name in _LEVEL_KEYS:
                flat[f"l{k}_{name}"] = p[name]
            if "pt" in p:
                flat[f"l{k}_pt"] = p["pt"]
        # v3: the customization structure rides along, so a worker that
        # REHYDRATES the overlay can still re-price it against a live
        # metric (the whole point of shipping structure, not just
        # payload).
        s = self._structure
        if s is not None:
            flat["s_c_senders"] = s["c_senders"]
            flat["s_c_receivers"] = s["c_receivers"]
            flat["s_parts"] = np.stack(
                [c0 for c0, _ in s["parts"]]).astype(np.int32)
            flat["s_parts_counts"] = np.asarray(
                [P for _, P in s["parts"]], np.int64)
            if "edge_comp_ptr" in s:
                for name in ("edge_comp_ptr", "edge_comp",
                             "seed_comp_ptr", "seed_comp",
                             "fill_comp_ptr", "fill_comp"):
                    flat[f"s_{name}"] = s[name]
        tmp = f"{cache_path}.tmp{os.getpid()}.npz"
        try:
            np.savez_compressed(
                tmp, _version=np.int64(_CACHE_VERSION),
                _n_levels=np.int64(self.n_levels),
                _stats=np.frombuffer(json.dumps(self.stats).encode(),
                                     dtype=np.uint8),
                _fp=np.frombuffer(
                    json.dumps(fingerprint or {},
                               sort_keys=True).encode(), dtype=np.uint8),
                **flat)
            os.replace(tmp, cache_path)
        except OSError:
            # cache is an optimization, never a dependency — but a
            # half-written tmp must not accumulate
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @classmethod
    def load(cls, cache_path: str,
             fingerprint: Optional[Dict] = None,
             device=None) -> Optional["HierarchicalIndex"]:
        """Rehydrate a cached overlay; None on any mismatch/corruption
        (callers rebuild) — LOUDLY, so a fleet whose replicas silently
        re-spend minutes of precompute per boot is visible in logs. The
        embedded fingerprint must match the caller's graph — the
        filename alone is predictable, so a payload at the right name
        but for the wrong (or tampered) graph is rejected by content,
        and the worst a poisoned entry can do is force a rebuild.
        The file format is the JAX package's: either loads the other's."""
        device = resolve_device(device, "HierarchicalIndex")
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                version = int(z["_version"])
                if version != _CACHE_VERSION:
                    _log().warning("overlay_cache_rejected",
                                   path=cache_path, reason="version",
                                   found=version, want=_CACHE_VERSION)
                    return None
                if fingerprint is not None:
                    cached_fp = json.loads(bytes(z["_fp"]).decode())
                    if cached_fp != json.loads(
                            json.dumps(fingerprint, sort_keys=True)):
                        _log().warning("overlay_cache_rejected",
                                       path=cache_path,
                                       reason="fingerprint_mismatch",
                                       found=cached_fp, want=fingerprint)
                        return None
                stats = json.loads(bytes(z["_stats"]).decode())
                n_levels = int(z["_n_levels"])
                levels = []
                for k in range(n_levels):
                    p = {name: z[f"l{k}_{name}"] for name in _LEVEL_KEYS}
                    if f"l{k}_pt" in z.files:
                        p["pt"] = z[f"l{k}_pt"]
                    levels.append(_Level(p, stats["levels"][k], device))
                top_s, top_r, top_w = z["top_s"], z["top_r"], z["top_w"]
                expand_idx = z["expand_idx"]
                seed_node, seed_w = z["seed_node"], z["seed_w"]
                labels = z["labels"] if "labels" in z.files else None
                l0 = fill = None
                if "g0_senders" in z.files:
                    l0 = {name: z[f"g0_{name}"]
                          for name in ("senders", "receivers", "w",
                                       "edge_last")}
                if "fill_node" in z.files:
                    fill = {name: z[f"fill_{name}"]
                            for name in ("node", "w", "last", "dir",
                                         "seed_last")}
                structure: Optional[Dict] = None
                if "s_parts" in z.files:
                    parts_arr = z["s_parts"]
                    counts = z["s_parts_counts"]
                    structure = {
                        "c_senders": z["s_c_senders"],
                        "c_receivers": z["s_c_receivers"],
                        "parts": [(parts_arr[k], int(counts[k]))
                                  for k in range(len(counts))],
                    }
                    if "s_edge_comp_ptr" in z.files:
                        for name in ("edge_comp_ptr", "edge_comp",
                                     "seed_comp_ptr", "seed_comp",
                                     "fill_comp_ptr", "fill_comp"):
                            structure[name] = z[f"s_{name}"]
        except Exception as e:
            _log().warning("overlay_cache_rejected", path=cache_path,
                           reason=f"{type(e).__name__}: {e}")
            return None
        stats["loaded_from_cache"] = True
        index = cls(levels, top_s, top_r, top_w, stats,
                    expand_idx=expand_idx, seed_node=seed_node,
                    seed_w=seed_w, l0=l0, fill=fill, labels=labels)
        index._structure = structure
        return index

    # -- query ------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stages(self) -> List[Tuple[str, object]]:
        """The query pipeline as (name, fn) pairs over a carry dict —
        ONE decomposition shared by ``query_fn``, ``full_solve_fn`` and
        ``timed_query`` (stage-by-stage timings). Each fn runs its
        stage's program (:meth:`_stage_steps`) eagerly."""
        return [(name, lambda c, steps=steps: run_steps(steps, c))
                for name, steps in self._stage_steps()]

    def _stage_steps(self) -> List[Tuple[str, list]]:
        """The query pipeline as (name, program) pairs: each program a
        list of segments (``carry → carry``) and host-checked relax
        loops (``serve/graphs.py``'s ``Loop``, whose state rides in
        ``carry["loop"]``), so a captured solve splits at exactly the
        eager loops' host checks."""
        lvls = self.levels
        L = self.n_levels
        top_s, top_r, top_w = self._d_top_s, self._d_top_r, self._d_top_w
        Bt = self.n_top
        dev = self.device

        def scatter_min(dst, index, values):
            return dst.scatter_reduce(1, index, values, "amin",
                                      include_self=True)

        def ell_loop(l, d0: torch.Tensor, p: torch.Tensor) -> Dict:
            # _relax_ell's prologue: the block-diagonal layout + state
            return {"ell": _ell_prep(l.d_ell_s[p], l.d_ell_w[p],
                                     l.d_ell_r[p], l.c_max),
                    "loop": d0[:, :l.c_max].reshape(-1)}

        def ell_steps(l, head, out_key: str) -> list:
            """``head`` (carry → carry with "ell"/"loop"), the loop,
            then the relaxed table under ``out_key``."""
            def tail(c: Dict) -> Dict:
                rest = {k: v for k, v in c.items()
                        if k not in ("ell", "loop")}
                return {**rest, out_key: c["loop"].reshape(-1, l.c_max)}

            loop = Loop("loop", lambda c: _ell_sweeps(c["loop"], c["ell"]),
                        l.c_max + _K_SWEEPS, _K_SWEEPS, _relax_ell)
            return [head, loop, tail]

        def phase1(c: Dict) -> Dict:
            l = lvls[0]
            p = c["p_cells"][0]
            sp = c["seed_pos"][0]                # (S, 2) local ids|dump
            sv = c["seed_val"][0]
            S = sp.shape[0]
            d0 = scatter_min(_inf((S, l.c_max + 1), dev), sp, sv)
            return {**c, **ell_loop(l, d0, p)}

        def make_ascend(k: int):
            lp, l = lvls[k - 1], lvls[k]

            def ascend(c: Dict) -> Dict:
                p_prev = c["p_cells"][k - 1]
                p = c["p_cells"][k]
                local_prev = c[f"local{k - 1}"]
                S = local_prev.shape[0]
                seed = torch.gather(local_prev, 1, lp.d_bl[p_prev])
                pos = l.d_local_pad[lp.d_cbo[p_prev]]
                if l.d_pt is not None:
                    # Dense level: fold the entry seeds through the
                    # precomputed in-cell all-pairs table — same fixed
                    # point as the relaxation below. Pad seeds land on
                    # the per-cell INF row; a min is exact in any order.
                    folded = (seed[:, :, None]
                              + l.d_pt[p[:, None], pos]).amin(dim=1)
                    local = torch.minimum(_inf((S, l.c_max), dev), folded)
                    for j2 in (0, 1):
                        row = l.d_pt[p, c["seed_pos"][k][:, j2]]
                        local = torch.minimum(
                            local, c["seed_val"][k][:, j2, None] + row)
                    return {**c, f"local{k}": torch.clamp_max(local, _INF)}
                d0 = scatter_min(_inf((S, l.c_max + 1), dev), pos, seed)
                # Chain-interior sources whose second endpoint lands in
                # a different cell below this level enter here.
                d0 = scatter_min(d0, c["seed_pos"][k], c["seed_val"][k])
                return {**c, **ell_loop(l, d0, p)}

            if l.d_pt is not None:
                return [ascend]
            return ell_steps(l, ascend, f"local{k}")

        def top_bf(c: Dict) -> Dict:
            l = lvls[L - 1]
            p = c["p_cells"][L - 1]
            local = c[f"local{L - 1}"]
            S = local.shape[0]
            seed = torch.gather(local, 1, l.d_bl[p])
            ovl0 = scatter_min(_inf((S, Bt + 1), dev), l.d_cbo[p], seed)
            ovl0 = scatter_min(ovl0, c["seed_pos"][L], c["seed_val"][L])
            return {**c, "loop": ovl0[:, :Bt].contiguous()}

        def top_bf_out(c: Dict) -> Dict:
            rest = {k: v for k, v in c.items() if k != "loop"}
            return {**rest, "ovl": c["loop"]}

        # relax_from's loop over the top overlay graph
        top_bf_steps = [top_bf, Loop(
            "loop", lambda c: _bf_sweeps(c["loop"], top_s, top_r, top_w),
            Bt + _K_SWEEPS, _K_SWEEPS, relax_from), top_bf_out]

        d_labels = self._d_labels

        def top_labels(c: Dict) -> Dict:
            """Hub-label fold: the top BF's fixed point read off the
            precomputed all-pairs table. A source's only finite top
            seeds are its top-cell boundary distances (+ ≤2 chain
            seeds), so ``min_b(seed_b + labels[b, v])`` IS the top BF
            answer."""
            l = lvls[L - 1]
            p = c["p_cells"][L - 1]
            local = c[f"local{L - 1}"]
            S = local.shape[0]
            seed = torch.gather(local, 1, l.d_bl[p])
            ids = l.d_cbo[p]                     # (S, b), pad = Bt
            lab_pad = torch.cat([d_labels, _inf((1, Bt), dev)], dim=0)
            b = seed.shape[1]
            # bound the (S, b, Bt) proposal on huge tops
            step = max(1, (192 << 20) // max(1, S * Bt * 4))
            acc = _inf((S, Bt), dev)
            for lo in range(0, b, step):
                acc = torch.minimum(acc, (
                    seed[:, lo:lo + step, None]
                    + lab_pad[ids[:, lo:lo + step]]).amin(dim=1))
            for j in (0, 1):
                sid = c["seed_pos"][L][:, j]     # pad = Bt (INF row)
                acc = torch.minimum(
                    acc, c["seed_val"][L][:, j, None] + lab_pad[sid])
            return {**c, "ovl": torch.clamp_max(acc, _INF)}

        def make_descend(k: int):
            l = lvls[k]

            def descend(c: Dict) -> Dict:
                p = c["p_cells"][k]
                local = c[f"local{k}"]
                ovl = c["ovl"]
                S = ovl.shape[0]
                ovl_pad = torch.cat([ovl, _inf((S, 1), dev)], dim=1)
                parts = []
                for lo, hi, bb in l.tiers:
                    cbo_t = l.d_cbo[lo:hi]
                    tab_t = l.d_table[lo:hi]
                    acc = _inf((S, hi - lo, l.c_max), dev)
                    # One min-plus step per boundary slot of the tier:
                    # (S, tier, c_max) per step, never (S, tier, b, c).
                    for b in range(bb):
                        o_b = ovl_pad.index_select(1, cbo_t[:, b])
                        acc = torch.minimum(
                            acc, o_b[:, :, None] + tab_t[None, :, b, :])
                    parts.append(acc)
                acc = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
                flat = acc.reshape(S, l.n_cells * l.c_max)
                # Fold in the ascend local (the only candidate for paths
                # that never leave the source's cell at this level);
                # layout is already cell-major, so the final answer is
                # one gather, not a scatter.
                pos = ((p * l.c_max)[:, None]
                       + torch.arange(l.c_max, device=dev)[None, :])
                flat = scatter_min(flat, pos, local)
                # Unreachable sums overflow f32 (3e38 + 3e38 = inf);
                # clamp back to the finite sentinel so downstream slack
                # arithmetic never sees inf - inf = nan.
                return {**c, "ovl": torch.clamp_max(
                    flat.index_select(1, l.d_perm), _INF)}

            return descend

        def expand(c: Dict) -> Dict:
            """Contracted → full-graph distances: kept nodes gather
            their row; chain interiors take ``min`` over their ≤2 fill
            entries (direction-start distance + along-chain offset).
            Exact for every path that touches a kept node; an interior
            source's own-segment tail is :meth:`full_solve_fn`'s."""
            ovl = c["ovl"]                        # (S, n_contracted)
            S = ovl.shape[0]
            pad = torch.cat([ovl, _inf((S, 1), dev)], dim=1)
            out = pad.index_select(1, self._d_expand)
            if self._fill is not None:
                for j in (0, 1):
                    fn = self._d_fill_node[:, j]
                    fw = self._d_fill_w[:, j]
                    out = torch.minimum(out, pad.index_select(1, fn)
                                        + fw[None, :])
            return {**c, "ovl": torch.clamp_max(out, _INF)}

        stages: List[Tuple[str, list]] = [
            ("phase1", ell_steps(lvls[0], phase1, "local0"))]
        for k in range(1, L):
            stages.append((f"ascend_l{k + 1}", make_ascend(k)))
        stages.append(("top_labels", [top_labels]) if d_labels is not None
                      else ("top_bf", top_bf_steps))
        for k in range(L - 1, -1, -1):
            stages.append((f"descend_l{k + 1}", [make_descend(k)]))
        if self._contracted:
            stages.append(("expand", [expand]))
        return stages

    def _build_query(self):
        stages = self._stages()

        def query(p_cells: torch.Tensor, seed_pos: torch.Tensor,
                  seed_val: torch.Tensor) -> torch.Tensor:
            carry = {"p_cells": p_cells, "seed_pos": seed_pos,
                     "seed_val": seed_val}
            for _name, fn in stages:
                carry = fn(carry)
            return carry["ovl"]

        return query

    def full_solve_fn(self, n_sweeps: int = 2):
        """The router's solve, :meth:`full_solve_steps` run eagerly:
        ``(p_cells, seed_pos, seed_val, src_full) -> (dist (S, N)
        float32, pred (S, N) int64 original edge ids)`` on the index's
        device."""
        steps = self.full_solve_steps(n_sweeps)

        def solve(p_cells: torch.Tensor, seed_pos: torch.Tensor,
                  seed_val: torch.Tensor, src_full: torch.Tensor):
            out = run_steps(steps, {"p_cells": p_cells, "seed_pos": seed_pos,
                                    "seed_val": seed_val,
                                    "src_full": src_full})
            return out["dist"], out["pred"]

        return solve

    def full_solve_steps(self, n_sweeps: int = 2) -> list:
        """The router's solve as a program (:meth:`_stage_steps`):
        overlay query + polish + predecessor recovery ON THE CONTRACTED
        GRAPH, then an exact synthesis of
        full-graph distances and ORIGINAL-edge predecessors from the
        chain fill structure. Synthesis rules (all exact):

        - kept node: distance = its contracted row; predecessor = the
          last ORIGINAL edge of its contracted predecessor edge.
        - chain interior v: min over its ≤2 fill slots of
          ``dist[direction start] + along-chain offset``, plus — when
          the SOURCE sits on the same emitted direction upstream — the
          direct along-chain offset difference (the one path family
          that never touches a kept node). Predecessor = that
          direction's entering hop.
        - seed endpoints of an interior source whose distance still
          equals the seed offset take the chain's last hop as
          predecessor (no contracted edge carried that assignment).

        The program reads the carry keys ``p_cells``, ``seed_pos``,
        ``seed_val`` (:meth:`prep_sources`) and ``src_full`` (the padded
        sources) and leaves ``dist`` (S, N) float32 and ``pred`` (S, N)
        int64 original edge ids."""
        if self._l0 is None or self._fill is None:
            raise ValueError("index lacks level-0/fill arrays (pre-v4 "
                             "cache or direct construction) — rebuild "
                             "the overlay")
        steps = [step for name, prog in self._stage_steps()
                 if name != "expand" for step in prog]
        dev = self.device
        nc = self.n_contracted
        ell_s, ell_w, ell_t, ell_r = self._d_l0_ell
        m, W = ell_s.shape
        ell_s_flat = ell_s.reshape(-1)
        d_expand = self._d_expand
        d_fill_node = self._d_fill_node
        d_fill_w = self._d_fill_w
        d_fill_last = self._d_fill_last
        d_fill_dir = self._d_fill_dir
        d_seed_node = self._d_seed_node_full
        d_seed_w = self._d_seed_w_full
        d_seed_last = self._d_seed_last
        n_dirs, kmax = self._n_dirs, self._dir_kmax

        def closer(val, start, cur, cur_start):
            finite = val < 1e37
            close_ = torch.abs(val - cur) <= 4e-7 * val + 1e-6
            return finite & torch.where(close_, start < cur_start, val < cur)

        def finish(carry: Dict) -> Dict:
            src_full = carry["src_full"]
            dist_c = carry["ovl"]                    # (S, n_contracted)
            S = dist_c.shape[0]
            rows = torch.arange(S, device=dev)
            r_idx = ell_r.expand(S, -1)

            def lanes(x):                            # (S, m, W) at senders
                return x.index_select(1, ell_s_flat).view(S, m, W)

            def at_receivers(x):                     # (S, m, 1)
                return x.index_select(1, ell_r)[:, :, None]

            def seg_min_rows(vals, init):
                return init.scatter_reduce(1, r_idx, vals, "amin",
                                           include_self=True)

            # Polish + tight-edge recovery over the ELL minirows: the
            # same math as :func:`polish`/:func:`tight_edges`, with the
            # reductions over E/8 minirows instead of E edges. Lane
            # tags ARE the original entering edges.
            for _ in range(n_sweeps):
                prop = (lanes(dist_c) + ell_w[None]).amin(dim=2)
                dist_c = seg_min_rows(prop, dist_c)
            empty = torch.full((S, nc), float("inf"), dtype=torch.float32,
                               device=dev)
            d_s3 = lanes(dist_c)
            slack3 = (d_s3 + ell_w[None]) - at_receivers(dist_c)
            min_slack = seg_min_rows(slack3.amin(dim=2), empty)
            tight3 = slack3 <= at_receivers(min_slack) + 1e-2
            # Min-sender-dist disambiguation (see tight_edges).
            sd3 = torch.where(tight3, d_s3, _INF)
            best_sd = seg_min_rows(sd3.amin(dim=2), empty)
            pick3 = tight3 & (sd3 <= at_receivers(best_sd))
            ids3 = torch.where(pick3, ell_t[None], -1)
            pred_c = torch.full((S, nc), -1, dtype=torch.int64,
                                device=dev).scatter_reduce(
                1, r_idx, ids3.amax(dim=2), "amax", include_self=True)
            dist_pad = torch.cat([dist_c, _inf((S, 1), dev)], dim=1)
            pred_pad = torch.cat([pred_c, torch.full(
                (S, 1), -1, dtype=torch.int64, device=dev)], dim=1)
            # Interior-source seed endpoints still carrying their seed
            # assignment: encode the chain's last hop as -2 - edge so
            # synthesis can tell it from a contracted edge id.
            sn = d_seed_node[src_full]               # (S, 2), pad = nc
            sw = d_seed_w[src_full]
            sl = d_seed_last[src_full]
            for j in (0, 1):
                cur = pred_pad[rows, sn[:, j]]
                cond = ((sl[:, j] >= 0)
                        & (dist_pad[rows, sn[:, j]] >= sw[:, j]))
                pred_pad[rows, sn[:, j]] = torch.where(cond, -2 - sl[:, j],
                                                       cur)
            # Synthesis: kept gather + fill fold. Direction choice is
            # ulp-TOLERANT with a smaller-START-distance tie-break, so
            # every within-chain walk step is monotone toward a kept
            # node (no predecessor 2-cycles through zero-length hops).
            base = dist_pad.index_select(1, d_expand)
            pc = pred_pad.index_select(1, d_expand)
            bpred_k = torch.where(pc <= -2, -2 - pc, pc)
            start0 = dist_pad.index_select(1, d_fill_node[:, 0])
            val0 = start0 + d_fill_w[None, :, 0]
            start1 = dist_pad.index_select(1, d_fill_node[:, 1])
            val1 = start1 + d_fill_w[None, :, 1]
            close = torch.abs(val0 - val1) <= 4e-7 * val0 + 1e-6
            pick1 = torch.where(close, start1 < start0, val1 < val0)
            fval = torch.where(pick1, val1, val0)
            fstart = torch.where(pick1, start1, start0)
            fpred = torch.where(pick1, d_fill_last[None, :, 1],
                                d_fill_last[None, :, 0])
            take = (fval < 1e37) & (fval < base)
            n_full = base.shape[1]
            # One extra (dump) column: the direction tables' pad node id
            # is n_full, and writes there are dropped by slicing it off.
            best = torch.cat([torch.where(take, fval, base),
                              _inf((S, 1), dev)], dim=1)
            best_start = torch.cat([
                torch.where(take, fstart, float("-inf")),
                torch.full((S, 1), float("-inf"), device=dev)], dim=1)
            bpred = torch.cat([torch.where(take, fpred, bpred_k),
                               torch.full((S, 1), -1, dtype=torch.int64,
                                          device=dev)], dim=1)
            # Same-direction along-chain candidates for interior
            # sources — the one path family that never touches a kept
            # node; their "start" is the source itself (distance 0, so
            # they win every tie).
            sdir = d_fill_dir[src_full]              # (S, 2)
            sfw = d_fill_w[src_full]
            zero = torch.zeros(S, dtype=torch.float32, device=dev)
            for i in (0, 1):
                ok_dir = sdir[:, i] >= 0
                d = torch.where(ok_dir, sdir[:, i], n_dirs)
                for k in range(kmax):
                    v = self._d_dir_nodes[d, k]          # (S,), pad = N
                    off = self._d_dir_w[d, k] - sfw[:, i]
                    ok = ok_dir & (off >= 0)
                    val = torch.where(ok, off, _INF)
                    v_safe = torch.clamp_max(v, n_full - 1)
                    cur = best[rows, v_safe]
                    curp = bpred[rows, v_safe]
                    cur_start = best_start[rows, v_safe]
                    take = ok & closer(val, zero, cur, cur_start)
                    bpred[rows, v] = torch.where(
                        take, self._d_dir_last[d, k], curp)
                    best[rows, v] = torch.where(take, val, cur)
                    best_start[rows, v] = torch.where(take, zero, cur_start)
            best = torch.clamp_max(best[:, :n_full], _INF)
            bpred = bpred[:, :n_full]
            # Device-side values: a Python scalar here would be staged
            # on the host and copied in, which a captured solve refuses.
            best[rows, src_full] = zero
            bpred[rows, src_full] = torch.full((S,), -1, dtype=torch.int64,
                                               device=dev)
            return {"dist": best, "pred": bpred}

        return steps + [finish]

    def timed_query(self, sources: np.ndarray
                    ) -> Tuple[np.ndarray, Dict[str, float]]:
        """(S, N) distances + per-stage wall milliseconds, the device
        synchronized around each stage (bench instrumentation — serving
        runs the same stages without the syncs)."""
        p_cells, seed_pos, seed_val = self.prep_sources(np.asarray(sources))
        carry = {"p_cells": p_cells, "seed_pos": seed_pos,
                 "seed_val": seed_val}
        phases: Dict[str, float] = {}
        for name, fn in self._stages():
            self._sync()
            t0 = time.perf_counter()
            carry = fn(carry)
            self._sync()
            phases[name] = 1000 * (time.perf_counter() - t0)
        return carry["ovl"].cpu().numpy(), phases

    def prep_sources(self, sources: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(S,) global source nodes → the ``query_fn`` argument triple on
        the index's device: (L, S) per-level cell ids of each source's
        PRIMARY seed, plus (L+1, S, 2) seed positions / values. The ONE
        place the source encoding lives — every query goes through it.

        A contracted (kept) source is one zero-weight seed in its own
        level-1 cell. A chain-interior source becomes ≤2 (endpoint,
        along-chain offset) seeds; each enters the query at the FIRST
        level whose cell contains both it and the primary — nesting
        guarantees a seed that differs below level k is a level-k
        boundary node, so the entry position always exists (the top
        row of ``seed_pos`` holds raw overlay ids)."""
        p_cells, seed_pos, seed_val = self.prep_sources_np(sources)
        dev = self.device
        return (_dev_i64(p_cells, dev), _dev_i64(seed_pos, dev),
                _dev_f32(seed_val, dev))

    def prep_sources_np(self, sources: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """:meth:`prep_sources` on the host: (int64 (L, S), int64 (L+1,
        S, 2), float32 (L+1, S, 2)) numpy arrays — what a captured
        solve copies into its static inputs."""
        sources = np.asarray(sources, np.int64)
        S = len(sources)
        L = self.n_levels
        sn = self._seed_node[sources]            # (S, 2) contracted ids
        sw = self._seed_w[sources]               # (S, 2)
        primary = np.maximum(sn[:, 0], 0)
        p_cells = np.stack([lvl.src_cell[primary].astype(np.int64)
                            for lvl in self.levels])
        seed_pos = np.empty((L + 1, S, 2), np.int64)
        seed_val = np.full((L + 1, S, 2), _INF_NP, np.float32)
        for k, lvl in enumerate(self.levels):
            seed_pos[k] = lvl.c_max              # dump slot
        seed_pos[L] = self.n_top
        for j in (0, 1):
            cv = sn[:, j]
            cvs = np.maximum(cv, 0)
            remaining = cv >= 0
            for k, lvl in enumerate(self.levels):
                g = self._gk[k][cvs]
                ok = (remaining & (lvl.src_cell[cvs] == p_cells[k])
                      & (g >= 0))
                pos = lvl.local_of_node[np.maximum(g, 0)]
                seed_pos[k][ok, j] = pos[ok]
                seed_val[k][ok, j] = sw[ok, j]
                remaining &= ~ok
            g = self._gk[L][cvs]
            ok = remaining & (g >= 0)
            seed_pos[L][ok, j] = g[ok]
            seed_val[L][ok, j] = sw[ok, j]
        return p_cells, seed_pos, seed_val


def build_params() -> Dict:
    """The env-tunable knobs that change a BUILT overlay's content for
    the same graph — part of the cache key, so flipping a knob can
    never serve a payload built under the old one."""
    try:
        # 0 = auto (4 with labels, 16 without) — see _level_targets.
        ratio = int(os.environ.get("ROUTEST_HIER_RATIO", "0") or 0)
    except ValueError:
        ratio = 0
    try:
        max_levels = int(os.environ.get("ROUTEST_HIER_MAX_LEVELS", "0") or 0)
    except ValueError:
        max_levels = 0
    try:
        cell_target = int(
            os.environ.get("ROUTEST_HIER_CELL_TARGET", "0") or 0)
    except ValueError:
        cell_target = 0
    return {"prune_slack": _prune_slack(), "ratio": ratio,
            "max_levels": max_levels, "cell_target": cell_target,
            "contract": _contract_interior(), "labels": _labels_max()}


def _fingerprint_digest(fingerprint: Dict) -> str:
    """Short stable content hash of the graph fingerprint AND the
    build knobs — the cache FILENAME key, so ``ls`` on the cache dir
    maps files to graphs and a changed extract (or changed build
    parameters) changes the name (the embedded copy still guards
    against collisions/tampering by content)."""
    blob = json.dumps({"fp": fingerprint, "params": build_params()},
                      sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=10).hexdigest()


def hier_cache_path(fingerprint: Dict) -> Optional[str]:
    """Where this graph's overlay payload caches, or None when caching
    is off (``ROUTEST_HIER_CACHE=0``; a path value overrides the
    per-user secure default). Keyed by a content hash of the same graph
    fingerprint that gates learned leg models, so a changed extract can
    never be served a stale overlay — and the payload format is npz
    with pickling disabled, so a poisoned cache can at worst fail to
    load (callers rebuild)."""
    knob = os.environ.get("ROUTEST_HIER_CACHE", "")
    if knob.lower() in ("0", "off", "false", "no"):
        return None
    if knob:
        base = knob
        try:
            os.makedirs(base, exist_ok=True)
        except OSError:
            return None
    else:
        from routest_tpu_torch.utils.paths import secure_user_cache_dir

        base = secure_user_cache_dir("routest-hier")
        if base is None:
            return None
    key = _fingerprint_digest(fingerprint)
    return os.path.join(base, f"hier-v{_CACHE_VERSION}-{key}.npz")


def hier_min_nodes() -> int:
    """Graphs at or above this node count route through the overlay
    (``ROUTEST_HIER_MIN_NODES`` overrides; 0 disables entirely), as in
    the JAX package. Below it the flat sweep's ~O(sqrt(N)) iterations
    are already cheap and skipping the precompute keeps router
    construction instant."""
    try:
        return int(os.environ.get("ROUTEST_HIER_MIN_NODES", "4096"))
    except ValueError:
        return 4096
