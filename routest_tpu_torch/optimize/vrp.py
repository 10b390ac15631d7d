"""Capacity- and range-constrained greedy VRP, its refiners and the
dispatch core, as batched tensor code on the device.

The counterpart of ``routest_tpu/optimize/vrp.py``, with the same
observable semantics (reference solver ``Flaskr/utils.py:111-139``):
origin-sorted candidate scan, capacity and ``trip + leg + return <=
maximum_distance`` acceptance where only the leg accumulates, multi-trip
spill, individually infeasible stops reported as unroutable; then the
2-opt, relocate, swap and Or-opt-2/3 local searches; and the dispatch
core behind ``/api/dispatch``: the same scan under a global clock with
time windows, and a penalty lane for the stops that spill.

Every solver works on a batch: ``dist (B, N+1, N+1)``, ``demands (B,
N)``, ``capacity``/``max_distance (B,)``, ``order``/``trip_ids (B, N)``
int64 with -1 padding. The batch is the parallel axis, as in the JAX
package's ``vmap``; the single-problem functions are batches of one.
Each JAX ``while_loop`` becomes a Python loop over batched tensor ops
whose condition is read on the host once per iteration (one device
sync), and a problem that has converged is frozen by a mask while the
others iterate, as a ``vmap``-ed ``while_loop`` freezes it. Each ``scan``
becomes an unrolled loop with no sync. Arithmetic runs in float32 in the
JAX expressions' order; sums that the JAX code reduces with ``sum`` are
taken left to right, as XLA's CPU reduction takes them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from routest_tpu_torch.core.config import resolve_device

_INF = float("inf")
_STOP = -1e-3  # a move must gain more than this to be taken


class VRPSolution(NamedTuple):
    order: torch.Tensor      # (B, N) destination indices in visit order, -1 padded
    trip_ids: torch.Tensor   # (B, N) trip index per position in ``order``, -1 padded
    n_trips: torch.Tensor    # (B,)
    n_routed: torch.Tensor   # (B,) how many stops were placed
    unroutable: torch.Tensor  # (B, N) bool — individually infeasible stops


class _RelocateOut(NamedTuple):
    order: torch.Tensor
    trip_ids: torch.Tensor


def _at(dist: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dist[batch, a, b]`` for index tensors ``a``/``b`` whose leading
    axis is the batch (broadcast together): the batched form of the JAX
    code's ``dist[a, b]`` gathers."""
    a, b = torch.broadcast_tensors(a, b)
    rows = torch.arange(dist.shape[0], device=dist.device).view(
        (-1,) + (1,) * (a.dim() - 1))
    return dist[rows, a, b]


def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (XLA's CPU order), so float
    sums agree with the JAX package's bit for bit."""
    out = x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c]
    return out


def _shift(a: torch.Tensor, by: int) -> torch.Tensor:
    """Shift left along the position axis by ``by``, zero-filled."""
    if not by:
        return a
    return torch.cat([a[:, by:], torch.zeros_like(a[:, :by])], dim=1)


def _prepend_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


def _append_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)


# ── greedy construction ───────────────────────────────────────────────


def greedy_vrp_batch(dist: torch.Tensor, demands: torch.Tensor,
                     capacity: torch.Tensor,
                     max_distance: torch.Tensor) -> VRPSolution:
    """Greedy multi-trip construction for a batch of problems.

    Trips are the outer loop (one host check per trip: are stops left?),
    the origin-sorted scan the inner one. A stop's state is kept in scan
    order, and the stops a trip accepts get the key ``trip * N + scan
    step``; sorting the keys gives the visit order, in which a stop's
    place is its trip, then its place in the scan — the order the JAX
    scatter at ``pos`` builds.
    """
    b, n = demands.shape
    demands = demands.to(dist.dtype)
    cap = capacity.to(dist.dtype)
    maxd = max_distance.to(dist.dtype)
    roundtrip = dist[:, 0, 1:] + dist[:, 1:, 0]
    unroutable = (demands > cap[:, None]) | (roundtrip > maxd[:, None])
    # Stable, like jnp.argsort: duplicate stops and batch pads tie.
    scan = torch.argsort(dist[:, 0, 1:], dim=1, stable=True)
    node_s = scan + 1
    dem_s = demands.gather(1, scan)
    back_s = dist[:, 1:, 0].gather(1, scan)
    visited = unroutable.gather(1, scan)
    never = n * (n + 1)
    key = torch.full((b, n), never, dtype=torch.int64, device=dist.device)
    trip = torch.zeros(b, dtype=torch.int64, device=dist.device)
    rows = torch.arange(b, device=dist.device)
    # Every trip over stops that are left places at least one of them,
    # so N trips always suffice.
    for _ in range(n):
        if bool(visited.all()):
            break
        current = torch.zeros(b, dtype=torch.int64, device=dist.device)
        load = torch.zeros(b, dtype=dist.dtype, device=dist.device)
        trip_dist = torch.zeros_like(load)
        accepted_any = torch.zeros(b, dtype=torch.bool, device=dist.device)
        for s in range(n):
            node = node_s[:, s]
            leg = dist[rows, current, node]
            accept = (~visited[:, s]
                      & (load + dem_s[:, s] <= cap)
                      & (trip_dist + leg + back_s[:, s] <= maxd))
            visited[:, s] |= accept
            key[:, s] = torch.where(accept, trip * n + s, key[:, s])
            current = torch.where(accept, node, current)
            load = load + torch.where(accept, dem_s[:, s], 0.0)
            trip_dist = trip_dist + torch.where(accept, leg, 0.0)
            accepted_any |= accept
        trip = trip + accepted_any.to(torch.int64)
    placed = torch.argsort(key, dim=1, stable=True)
    key_sorted = key.gather(1, placed)
    routed = key_sorted < never
    order = torch.where(routed, scan.gather(1, placed), -1)
    trip_ids = torch.where(routed, key_sorted // max(n, 1), -1)
    return VRPSolution(order=order, trip_ids=trip_ids, n_trips=trip,
                       n_routed=routed.sum(dim=1), unroutable=unroutable)


def _one(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar constraint as a batch of one on ``like``'s device."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).reshape(1)


def greedy_vrp(dist, demands, capacity, max_distance) -> VRPSolution:
    """One problem: ``dist (N+1, N+1)``, ``demands (N,)``, scalar
    constraints → a solution whose fields have no batch axis."""
    sol = greedy_vrp_batch(dist[None], demands[None], _one(capacity, dist),
                           _one(max_distance, dist))
    return VRPSolution(*(f[0] for f in sol))


# ── the local searches ───────────────────────────────────────────────


def _converge(analyze, apply, state, best, n: int):
    """The batched ``while_loop`` of every refiner: while some problem's
    best move improves (``best < -1e-3``) and fewer than ``n * n`` moves
    were made, apply each improving problem's move and re-analyze; the
    others stay frozen. One host sync per iteration."""
    it = 0
    while it < n * n:
        improving = best[0] < _STOP
        if not bool(improving.any()):
            break
        moved = apply(state, best)
        state = tuple(torch.where(improving[:, None], new, old)
                      for new, old in zip(moved, state))
        best = analyze(*state)
        it += 1
    return state


def refine_2opt_batch(dist: torch.Tensor, order: torch.Tensor,
                      trip_ids: torch.Tensor) -> torch.Tensor:
    """2-opt inside each trip, to fixpoint: repeatedly reverse the
    segment whose reversal shortens its trip most (symmetric ``dist``).
    ``trip_ids`` do not change; returns the refined ``order``."""
    b, n = order.shape
    pos = torch.arange(n, device=order.device)
    same_prev = torch.cat([torch.zeros_like(trip_ids[:, :1], dtype=torch.bool),
                           trip_ids[:, 1:] == trip_ids[:, :-1]], dim=1)
    same_next = torch.cat([trip_ids[:, :-1] == trip_ids[:, 1:],
                           torch.zeros_like(trip_ids[:, :1], dtype=torch.bool)],
                          dim=1)
    valid = ((pos[:, None] < pos[None, :])
             & (trip_ids[:, :, None] == trip_ids[:, None, :])
             & (trip_ids >= 0)[:, :, None])

    def analyze(order):
        nodes = torch.where(order >= 0, order + 1, 0)
        prev = torch.where(same_prev, _prepend_zero(nodes), 0)
        nxt = torch.where(same_next, _append_zero(nodes), 0)
        # delta(i, j) = cost of reversing positions i..j within one trip
        d = (_at(dist, prev[:, :, None], nodes[:, None, :])
             + _at(dist, nodes[:, :, None], nxt[:, None, :])
             - _at(dist, prev, nodes)[:, :, None]
             - _at(dist, nodes, nxt)[:, None, :])
        d = torch.where(valid, d, _INF).reshape(b, -1)
        flat = d.argmin(dim=1)
        return d.gather(1, flat[:, None])[:, 0], flat

    def apply(state, best):
        (order,) = state
        i, j = (best[1] // n)[:, None], (best[1] % n)[:, None]
        perm = torch.where((pos >= i) & (pos <= j), i + j - pos, pos)
        return (order.gather(1, perm),)

    (order,) = _converge(analyze, apply, (order,), analyze(order), n)
    return order


class _TourViews(NamedTuple):
    """Per-position views over a (order, trip_ids) tour — the shared
    analysis prologue of the cross-trip refiners. Padded positions are
    zeroed via the masks."""

    active: torch.Tensor     # (B, N) position holds a stop
    nodes: torch.Tensor      # (B, N) all_points index of the stop (0 if pad)
    dem: torch.Tensor        # (B, N) demand at the position
    same_prev: torch.Tensor  # (B, N) previous position is same trip
    prev: torch.Tensor       # (B, N) previous node along the trip (0 = origin)
    same_next: torch.Tensor  # (B, N) next position is same trip
    nxt: torch.Tensor        # (B, N) next node along the trip (0 = origin)
    loads: torch.Tensor      # (B, T=N) per-trip load
    tripdist: torch.Tensor   # (B, T=N) per-trip closed-tour distance


def _tour_views(dist: torch.Tensor, demands: torch.Tensor,
                order: torch.Tensor, trip_ids: torch.Tensor) -> _TourViews:
    n = order.shape[1]
    pos = torch.arange(n, device=order.device)
    active = order >= 0
    nodes = torch.where(active, order + 1, 0)
    dem = torch.where(active, demands.gather(1, order.clamp(min=0)), 0.0)
    same_prev = torch.cat(
        [torch.zeros_like(active[:, :1]),
         (trip_ids[:, 1:] == trip_ids[:, :-1]) & (trip_ids[:, 1:] >= 0)], dim=1)
    prev = torch.where(same_prev, _prepend_zero(nodes), 0)
    same_next = torch.cat(
        [(trip_ids[:, :-1] == trip_ids[:, 1:]) & (trip_ids[:, :-1] >= 0),
         torch.zeros_like(active[:, :1])], dim=1)
    nxt = torch.where(same_next, _append_zero(nodes), 0)
    # Per-trip load and closed-tour distance (one-hot segment sums;
    # T = N upper-bounds the trip count).
    tid_oh = ((trip_ids[:, None, :] == pos[None, :, None])
              & active[:, None, :]).to(dist.dtype)
    loads = _rowsum(tid_oh * dem[:, None, :])
    leg_in = torch.where(active, _at(dist, prev, nodes), 0.0)
    ret = torch.where(active & ~same_next, _at(dist, nodes, torch.zeros_like(nodes)),
                      0.0)
    tripdist = _rowsum(tid_oh * (leg_in + ret)[:, None, :])
    return _TourViews(active, nodes, dem, same_prev, prev, same_next, nxt,
                      loads, tripdist)


def _best_of(scored: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten each problem's move scores → (best delta, flat index);
    ties go to the lowest index, as with ``jnp.argmin``."""
    flat = scored.reshape(scored.shape[0], -1)
    idx = flat.argmin(dim=1)
    return flat.gather(1, idx[:, None])[:, 0], idx


def _segment_refiner(dist, demands, capacity, max_distance, order, trip_ids,
                     seg_len: int) -> _RelocateOut:
    """Move a run of ``seg_len`` adjacent stops as one unit — within its
    trip or into another — while that shortens the tour and stays
    feasible. ``seg_len`` 1 is the JAX package's ``refine_relocate``
    (Or-opt-1), 2 and 3 its ``_refine_oropt_impl``; the two share every
    formula once ``k = seg_len - 1`` is 0 (the segment's end is its
    start, no internal legs, the 1-stop target positions)."""
    b, n = order.shape
    k = seg_len - 1
    pos = torch.arange(n, device=order.device)
    demands = demands.to(dist.dtype)
    cap = capacity.to(dist.dtype)[:, None, None]
    limit = (max_distance.to(dist.dtype) + 1e-3)[:, None, None, None]

    def analyze(order, trip_ids):
        v = _tour_views(dist, demands, order, trip_ids)
        active, nodes, dem = v.active, v.nodes, v.dem
        prev, nxt = v.prev, v.nxt
        # Segment [i, i+k]: lane i carries the whole segment.
        s_end = _shift(nodes, k)
        nxt_end = _shift(nxt, k)
        seg_ok = active
        seg_dem = dem
        internal = None
        if k:
            edge = torch.where(v.same_next,
                               _at(dist, nodes, _shift(nodes, 1)), 0.0)
            internal = torch.zeros_like(edge)
            for step in range(k):
                seg_ok = seg_ok & _shift(v.same_next, step)
                seg_dem = seg_dem + _shift(dem, step + 1)
                internal = internal + _shift(edge, step)
            internal = torch.where(seg_ok, internal, 0.0)

        # Removal gain of the segment (internal legs travel with it).
        gain = (_at(dist, prev, nodes) + _at(dist, s_end, nxt_end)
                - _at(dist, prev, nxt_end))
        # Insertion [i, j]: segment i after stop j, or before the head
        # of j's trip.
        from_origin = dist[:, 0, :].gather(1, nodes)
        ins_after = (_at(dist, nodes[:, None, :], nodes[:, :, None])
                     + _at(dist, s_end[:, :, None], nxt[:, None, :])
                     - _at(dist, nodes, nxt)[:, None, :])
        ins_head = (from_origin[:, :, None]
                    + _at(dist, s_end[:, :, None], nodes[:, None, :])
                    - from_origin[:, None, :])
        costs = torch.stack([ins_after, ins_head], dim=1)      # (B, 2, N, N)

        tids = trip_ids.clamp(min=0)
        same_trip = trip_ids[:, :, None] == trip_ids[:, None, :]
        delta = costs - gain[:, None, :, None]
        loads_j = v.loads.gather(1, tids)[:, None, :]
        cap_ok = same_trip | (loads_j + seg_dem[:, :, None] <= cap)
        trip_i = v.tripdist.gather(1, tids)
        trip_j = trip_i[:, None, None, :]
        across = trip_j + costs
        if internal is not None:
            # Cross-trip, the segment's internal legs move into the
            # target trip too (same-trip they cancel inside gain).
            across = across + internal[:, None, :, None]
        newdist = torch.where(same_trip[:, None],
                              trip_i[:, None, :, None] + costs
                              - gain[:, None, :, None],
                              across)
        dist_ok = newdist <= limit

        # j must lie outside the segment's own positions [i, i+k].
        outside = ((pos[None, :] < pos[:, None])
                   | (pos[None, :] > pos[:, None] + k))
        base = seg_ok[:, :, None] & active[:, None, :] & outside
        # after-mode no-op: back after the segment's own predecessor
        after_noop = same_trip & (pos[None, :] == pos[:, None] - 1)
        head_j = active & ~v.same_prev
        valid = (torch.stack([base & ~after_noop, base & head_j[:, None, :]],
                             dim=1)
                 & cap_ok[:, None] & dist_ok)
        best, flat = _best_of(torch.where(valid, delta, _INF))
        mode = flat // (n * n)
        i, j = (flat % (n * n)) // n, flat % n
        # Final START position of the moved block.
        t_after = torch.where(i < j, j - k, j + 1)
        t_head = torch.where(i < j, j - seg_len, j)
        target = torch.where(mode == 0, t_after, t_head)
        return best, i, target, trip_ids.gather(1, j[:, None])[:, 0]

    def apply(state, best):
        order, trip_ids = state
        _, i, t, tgt_trip = (x[:, None] for x in best)
        fwd = (pos >= i) & (pos < t)                 # block moved forward
        bwd = (pos > t + k) & (pos <= i + k)         # block moved backward
        perm = torch.where(fwd, pos + seg_len,
                           torch.where(bwd, pos - seg_len, pos))
        in_block = (pos >= t) & (pos <= t + k)
        # Frozen problems may carry an out-of-range no-move; clamp so the
        # gather stays in bounds (their result is masked off).
        perm = torch.where(in_block, i + (pos - t), perm).clamp(0, n - 1)
        return (order.gather(1, perm),
                torch.where(in_block, tgt_trip, trip_ids.gather(1, perm)))

    state = (order, trip_ids)
    order, trip_ids = _converge(analyze, apply, state, analyze(*state), n)
    return _RelocateOut(order=order, trip_ids=trip_ids)


def refine_relocate_batch(dist, demands, capacity, max_distance, order,
                          trip_ids) -> _RelocateOut:
    """Cross-trip relocate (Or-opt-1): move one stop anywhere — including
    into another trip — while that shortens the tour and stays feasible.
    Emptied trips vanish (ids stay; ``solve_host`` compacts)."""
    return _segment_refiner(dist, demands, capacity, max_distance, order,
                            trip_ids, 1)


def refine_oropt_batch(dist, demands, capacity, max_distance, order,
                       trip_ids, *, seg_len: int = 2) -> _RelocateOut:
    """Or-opt-L: relocate an adjacent segment of ``seg_len`` stops as
    one unit, orientation preserved."""
    return _segment_refiner(dist, demands, capacity, max_distance, order,
                            trip_ids, int(seg_len))


def refine_swap_batch(dist, demands, capacity, max_distance, order,
                      trip_ids) -> torch.Tensor:
    """Cross-trip swap: trade one stop between two trips (loads change by
    the demand difference only). ``trip_ids`` do not change; returns the
    refined ``order``."""
    b, n = order.shape
    pos = torch.arange(n, device=order.device)
    demands = demands.to(dist.dtype)
    cap = capacity.to(dist.dtype)[:, None, None]
    limit = (max_distance.to(dist.dtype) + 1e-3)[:, None, None]
    tids = trip_ids.clamp(min=0)
    before = pos[:, None] < pos[None, :]

    def analyze(order):
        v = _tour_views(dist, demands, order, trip_ids)
        nodes, prev, nxt = v.nodes, v.prev, v.nxt
        # replace_cost[i, j] = new edge cost at position i if node_j sat
        # there; its diagonal is the current cost
        rc = (_at(dist, prev[:, :, None], nodes[:, None, :])
              + _at(dist, nodes[:, None, :], nxt[:, :, None]))
        cur = _at(dist, prev, nodes) + _at(dist, nodes, nxt)
        delta_at = rc - cur[:, :, None]      # [i, j]: put j's node at i
        delta_t = delta_at.transpose(1, 2)
        delta = delta_at + delta_t           # full swap of positions i, j

        diff_trip = ((trip_ids[:, :, None] != trip_ids[:, None, :])
                     & v.active[:, :, None] & v.active[:, None, :])
        dd = v.dem[:, :, None] - v.dem[:, None, :]   # load change at j's trip
        load = v.loads.gather(1, tids)
        cap_ok = ((load[:, :, None] - dd <= cap)
                  & (load[:, None, :] + dd <= cap))
        trip = v.tripdist.gather(1, tids)
        dist_ok = ((trip[:, :, None] + delta_at <= limit)
                   & (trip[:, None, :] + delta_t <= limit))
        best, flat = _best_of(torch.where(
            diff_trip & cap_ok & dist_ok & before, delta, _INF))
        return best, flat // n, flat % n

    def apply(state, best):
        (order,) = state
        i, j = best[1][:, None], best[2][:, None]
        oi, oj = order.gather(1, i), order.gather(1, j)
        order = torch.where(pos == i, oj, order)
        return (torch.where(pos == j, oi, order),)

    (order,) = _converge(analyze, apply, (order,), analyze(order), n)
    return order


def _single(fn, dist, demands, capacity, max_distance, order, trip_ids,
            **kw):
    out = fn(dist[None], demands[None], _one(capacity, dist),
             _one(max_distance, dist), order[None], trip_ids[None], **kw)
    if isinstance(out, _RelocateOut):
        return _RelocateOut(out.order[0], out.trip_ids[0])
    return out[0]


def refine_2opt(dist, order, trip_ids) -> torch.Tensor:
    return refine_2opt_batch(dist[None], order[None], trip_ids[None])[0]


def refine_relocate(dist, demands, capacity, max_distance, order,
                    trip_ids) -> _RelocateOut:
    return _single(refine_relocate_batch, dist, demands, capacity,
                   max_distance, order, trip_ids)


def refine_swap(dist, demands, capacity, max_distance, order,
                trip_ids) -> torch.Tensor:
    return _single(refine_swap_batch, dist, demands, capacity, max_distance,
                   order, trip_ids)


def refine_oropt(dist, demands, capacity, max_distance, order, trip_ids,
                 *, seg_len: int = 2) -> _RelocateOut:
    return _single(refine_oropt_batch, dist, demands, capacity, max_distance,
                   order, trip_ids, seg_len=seg_len)


def refine_oropt2(dist, demands, capacity, max_distance, order, trip_ids):
    return refine_oropt(dist, demands, capacity, max_distance, order,
                        trip_ids, seg_len=2)


def refine_oropt3(dist, demands, capacity, max_distance, order, trip_ids):
    return refine_oropt(dist, demands, capacity, max_distance, order,
                        trip_ids, seg_len=3)


def _refine_round(dist, dem, cap, maxd, order, trips):
    """One round of every refiner, in the JAX package's order: 2-opt →
    relocate → swap → Or-opt-2 → Or-opt-3."""
    order = refine_2opt_batch(dist, order, trips)
    order, trips = refine_relocate_batch(dist, dem, cap, maxd, order, trips)
    order = refine_swap_batch(dist, dem, cap, maxd, order, trips)
    order, trips = refine_oropt_batch(dist, dem, cap, maxd, order, trips,
                                      seg_len=2)
    return refine_oropt_batch(dist, dem, cap, maxd, order, trips, seg_len=3)


# ── host wrappers ─────────────────────────────────────────────────────


def trips_cost(dist: np.ndarray, trips) -> float:
    """Host-side total closed-tour distance of a trips-list (the
    ``solve_host`` output form): Σ over trips of origin → stops → origin.
    The single cost oracle shared by benchmarks and tests so they score
    exactly the objective the refiners minimize."""
    total = 0.0
    for trip in trips:
        if not trip:
            continue
        total += float(dist[0, trip[0] + 1])
        for a, b in zip(trip[:-1], trip[1:]):
            total += float(dist[a + 1, b + 1])
        total += float(dist[trip[-1] + 1, 0])
    return total


def tour_cost(dist: np.ndarray, order: np.ndarray,
              trip_ids: np.ndarray) -> float:
    """(order, trip_ids)-form view of :func:`trips_cost` — converts the
    padded solver arrays to a trips-list and delegates, so there is one
    cost oracle, not two."""
    trips: list = []
    last_tid = None
    for o, t in zip(order, trip_ids):
        if o < 0:
            break
        if t != last_tid:
            trips.append([])
            last_tid = t
        trips[-1].append(int(o))
    return trips_cost(dist, trips)


def _unpack_solution(order: np.ndarray, trip_ids: np.ndarray,
                     n_routed: int, unroutable: np.ndarray,
                     n_real: int) -> dict:
    """Padded solver arrays → host dict (shared by single and batch).
    ``n_real`` masks batch padding out of the unroutable report."""
    trips: list = []
    for pos in range(n_routed):
        tid = int(trip_ids[pos])
        while len(trips) <= tid:
            trips.append([])
        trips[tid].append(int(order[pos]))
    # relocate may empty a trip entirely; compact so trip counts stay dense
    trips = [t for t in trips if t]
    return {
        "trips": trips,
        "optimized_order": [int(i) for i in order[:n_routed]],
        "n_trips": len(trips),
        "unroutable": [int(i) for i in np.flatnonzero(unroutable[:n_real])],
    }


def _fetch(sol: VRPSolution, order: torch.Tensor,
           trip_ids: torch.Tensor) -> List[np.ndarray]:
    """One device→host copy of a solved batch: order, trip ids,
    placed count and the unroutable mask, per problem."""
    n = order.shape[1]
    host = torch.cat([order, trip_ids, sol.n_routed[:, None],
                      sol.unroutable.to(torch.int64)], dim=1).cpu().numpy()
    return [host[:, :n], host[:, n:2 * n], host[:, 2 * n],
            host[:, 2 * n + 1:].astype(bool)]


def _constraints(demands: np.ndarray, caps: np.ndarray, maxds: np.ndarray,
                 device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Demands (B, N) and the per-problem constraints in one host→device
    copy."""
    b = demands.shape[0]
    packed = torch.from_numpy(np.concatenate(
        [demands, caps[:, None], maxds[:, None]], axis=1).astype(np.float32))
    packed = packed.to(device)
    return packed[:, :-2], packed[:, -2], packed[:, -1]


def solve_host_batch(dists: Sequence, demands: Sequence, capacities,
                     max_distances, refine: bool = False,
                     max_refine_rounds: int = 4, device=None) -> list:
    """Solve MANY VRPs in one batched device program.

    Inputs are per-problem lists (matrices of varying size); problems
    pad to the batch's max stop count rounded up to a power of two, and
    the batch to a power of two, as in the JAX package (whose compiled
    programs are keyed on these shapes). Padded stops get infinite
    demand and a ``1e30`` origin round trip, so they are unroutable under
    any finite constraints; padded problems are all padding.

    ``refine=True`` runs ``max_refine_rounds`` fixed rounds of 2-opt →
    relocate → swap → Or-opt-2 → Or-opt-3 across the batch (every move
    strictly improves, so extra rounds are no-ops for converged
    problems).
    """
    b = len(dists)
    if b == 0:
        return []
    caps_np = np.asarray(capacities, np.float32)
    maxd_np = np.asarray(max_distances, np.float32)
    # Non-finite constraints make the feasibility mask vacuous (NaN
    # compares False both ways; inf capacity lets padded stops through).
    if not (np.isfinite(caps_np).all() and np.isfinite(maxd_np).all()):
        raise ValueError("solve_host_batch: capacity/max_distance must be "
                         "finite")
    dev = resolve_device(device)
    n_real = [np.shape(d)[0] - 1 for d in dists]
    p = 1 << max(0, (max(n_real) - 1)).bit_length()  # padded stop count
    b_pad = 1 << max(0, (b - 1)).bit_length()

    far = np.float32(1e30)
    dist_b = np.full((b_pad, p + 1, p + 1), far, np.float32)
    dem_b = np.full((b_pad, p), np.inf, np.float32)
    for i, (d, dem, n) in enumerate(zip(dists, demands, n_real)):
        dist_b[i, : n + 1, : n + 1] = np.asarray(d, np.float32)
        dem_b[i, :n] = dem
    pad_ones = np.ones(b_pad - b, np.float32)
    dem_t, cap_t, maxd_t = _constraints(
        dem_b, np.concatenate([caps_np, pad_ones]),
        np.concatenate([maxd_np, pad_ones]), dev)
    dist_t = torch.from_numpy(dist_b).to(dev)

    sol = greedy_vrp_batch(dist_t, dem_t, cap_t, maxd_t)
    order, trips = sol.order, sol.trip_ids
    if refine:
        for _ in range(max_refine_rounds):
            order, trips = _refine_round(dist_t, dem_t, cap_t, maxd_t,
                                         order, trips)
    order, trip_ids, n_routed, unroutable = _fetch(sol, order, trips)
    return [
        _unpack_solution(order[i], trip_ids[i], int(n_routed[i]),
                         unroutable[i], n_real[i])
        for i in range(b)
    ]


def solve_host(dist, demands: np.ndarray, capacity: float,
               max_distance: float, refine: bool = False,
               max_refine_rounds: int = 4, device=None) -> dict:
    """One problem, plain Python out (trips as lists).

    ``dist`` is a float32 tensor (solved on its device) or an array
    (moved to ``device``). ``refine=True`` runs rounds of 2-opt →
    relocate → swap → Or-opt-2 → Or-opt-3 until a round no longer
    shortens the tour by 1e-3 (the cost read on the host, in float64
    from the float32 matrix, as the JAX package reads it)."""
    if isinstance(dist, torch.Tensor):
        dist_t = dist.to(torch.float32)
    else:
        dist_t = torch.tensor(np.asarray(dist, np.float32),
                              device=resolve_device(device))
    dem_t, cap_t, maxd_t = _constraints(
        np.asarray(demands, np.float32)[None],
        np.asarray([capacity], np.float32),
        np.asarray([max_distance], np.float32), dist_t.device)
    dist_t = dist_t[None]
    sol = greedy_vrp_batch(dist_t, dem_t, cap_t, maxd_t)
    order, trips = sol.order, sol.trip_ids
    if refine:
        dist_np = dist_t[0].cpu().numpy()

        def cost_of(order, trips):
            host = torch.cat([order, trips]).cpu().numpy()
            return tour_cost(dist_np, host[0], host[1])

        cost = cost_of(order, trips)
        for _ in range(max_refine_rounds):
            order, trips = _refine_round(dist_t, dem_t, cap_t, maxd_t,
                                         order, trips)
            new_cost = cost_of(order, trips)
            if new_cost >= cost - 1e-3:
                break
            cost = new_cost
    order, trip_ids, n_routed, unroutable = _fetch(sol, order, trips)
    return _unpack_solution(order[0], trip_ids[0], int(n_routed[0]),
                            unroutable[0], len(demands))


# ── dispatch: time windows and the spill lane ─────────────────────────
#
# The dispatch core (JAX ``vrp.py:791-1094``): the greedy scan under a
# global clock ``t`` that runs through every trip, return legs included;
# a candidate's arrival is ``max(t + leg, tw_open)`` (an early arrival
# waits) and it must not pass ``tw_close``. Stops the real trips cannot
# take (window closed, or demand over capacity while still reachable)
# spill into ONE penalty-lane trip after the real trips, where their
# lateness past the window adds up to ``penalty``. Only stops whose
# origin round trip exceeds the budget are unroutable.

# Finite "no deadline" sentinel (not inf: the lateness term subtracts
# it), far beyond any real clock and float32-safe (2e30 << float32 max).
NO_WINDOW = 1e30
# Batch padding: a padded stop's legs and demand (unreachable under any
# finite budget below 2e30).
_FAR = 1e30


class DispatchSolution(NamedTuple):
    order: torch.Tensor       # (B, N) stop indices in visit order, -1 padded;
    #                           [0, n_routed) the real trips, then
    #                           [n_routed, n_routed + n_spilled) the lane
    trip_ids: torch.Tensor    # (B, N) trip per position (lane = n_trips)
    n_trips: torch.Tensor     # (B,) real trips, the lane excluded
    n_routed: torch.Tensor    # (B,) stops placed in real trips
    n_spilled: torch.Tensor   # (B,) stops placed in the penalty lane
    unroutable: torch.Tensor  # (B, N) bool — physically unservable stops
    spilled: torch.Tensor     # (B, N) bool — reachable but infeasible stops
    penalty: torch.Tensor     # (B,) total window lateness in the lane


def greedy_vrp_dispatch_batch(dist: torch.Tensor, demands: torch.Tensor,
                              capacity: torch.Tensor,
                              max_distance: torch.Tensor,
                              tw_open: torch.Tensor,
                              tw_close: torch.Tensor) -> DispatchSolution:
    """Greedy VRP with time windows and a demand-spillover penalty lane,
    for a batch: ``dist (B, N+1, N+1)`` (row/col 0 the depot), ``demands``
    / ``tw_open`` / ``tw_close (B, N)``, ``capacity`` / ``max_distance
    (B,)``.

    Trips are a Python loop with one host check per round (does some
    problem still have stops left and did its last trip take one?). A
    problem whose answer is no is frozen — every update of the round is
    masked off for it, the clock's return leg included — as the JAX
    package's ``vmap``-ed ``while_loop`` keeps its state. The scan and
    the penalty lane are unrolled with no sync. A placed stop gets the
    key ``trip * N + scan step`` (the lane's stops the trip after the
    last real one), so sorting the keys gives the JAX scatter-at-``pos``
    order without indexing at ``pos``.
    """
    b, n = demands.shape
    dev = dist.device
    demands = demands.to(dist.dtype)
    tw_open = tw_open.to(dist.dtype)
    tw_close = tw_close.to(dist.dtype)
    cap = capacity.to(dist.dtype)
    maxd = max_distance.to(dist.dtype)

    roundtrip = dist[:, 0, 1:] + dist[:, 1:, 0]
    unreachable = roundtrip > maxd[:, None]
    over_cap = (demands > cap[:, None]) & ~unreachable
    # Stable, like jnp.argsort: batch pads and integer costs tie.
    scan = torch.argsort(dist[:, 0, 1:], dim=1, stable=True)
    node_s = scan + 1
    dem_s = demands.gather(1, scan)
    back_s = dist[:, 1:, 0].gather(1, scan)
    open_s = tw_open.gather(1, scan)
    close_s = tw_close.gather(1, scan)
    # over-capacity stops skip the real trips (they go to the lane);
    # unreachable stops are dropped
    visited = (unreachable | over_cap).gather(1, scan)
    never = n * (n + 1)
    key = torch.full((b, n), never, dtype=torch.int64, device=dev)
    trip = torch.zeros(b, dtype=torch.int64, device=dev)
    t = torch.zeros(b, dtype=dist.dtype, device=dev)
    progress = torch.ones(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    # Every round but a problem's last places at least one stop, so N + 1
    # rounds always suffice.
    for _ in range(n + 1):
        live = ~visited.all(dim=1) & progress
        if not bool(live.any()):
            break
        current = torch.zeros(b, dtype=torch.int64, device=dev)
        load = torch.zeros(b, dtype=dist.dtype, device=dev)
        trip_dist = torch.zeros_like(load)
        accepted_any = torch.zeros(b, dtype=torch.bool, device=dev)
        for s in range(n):
            node = node_s[:, s]
            leg = dist[rows, current, node]
            arrive = torch.maximum(t + leg, open_s[:, s])
            accept = (live & ~visited[:, s]
                      & (load + dem_s[:, s] <= cap)
                      & (trip_dist + leg + back_s[:, s] <= maxd)
                      & (arrive <= close_s[:, s]))
            visited[:, s] |= accept
            key[:, s] = torch.where(accept, trip * n + s, key[:, s])
            t = torch.where(accept, arrive, t)
            current = torch.where(accept, node, current)
            load = load + torch.where(accept, dem_s[:, s], 0.0)
            trip_dist = trip_dist + torch.where(accept, leg, 0.0)
            accepted_any |= accept
        trip = trip + accepted_any.to(torch.int64)
        # the clock pays the return leg (dist[0, 0] on an empty trip)
        t = torch.where(live, t + dist[rows, current, 0], t)
        progress = torch.where(live, accepted_any, progress)

    # The penalty lane: everything reachable the real trips could not
    # take, visited in scan order on the same clock. Batch padding never
    # lands here (padded stops are unreachable).
    spilled_s = ~unreachable.gather(1, scan) & (over_cap.gather(1, scan)
                                                 | ~visited)
    current = torch.zeros(b, dtype=torch.int64, device=dev)
    penalty = torch.zeros(b, dtype=dist.dtype, device=dev)
    zero = torch.zeros((), dtype=dist.dtype, device=dev)
    for s in range(n):
        take = spilled_s[:, s]
        node = node_s[:, s]
        arrive = torch.maximum(t + dist[rows, current, node], open_s[:, s])
        late = torch.maximum(arrive - close_s[:, s], zero)
        key[:, s] = torch.where(take, trip * n + s, key[:, s])
        current = torch.where(take, node, current)
        t = torch.where(take, arrive, t)
        penalty = penalty + torch.where(take, late, 0.0)

    placed = torch.argsort(key, dim=1, stable=True)
    key_sorted = key.gather(1, placed)
    in_plan = key_sorted < never
    spilled = torch.zeros_like(spilled_s).scatter_(1, scan, spilled_s)
    return DispatchSolution(
        order=torch.where(in_plan, scan.gather(1, placed), -1),
        trip_ids=torch.where(in_plan, key_sorted // max(n, 1), -1),
        n_trips=trip,
        n_routed=(key < (trip * n)[:, None]).sum(dim=1),
        n_spilled=spilled_s.sum(dim=1),
        unroutable=unreachable,
        spilled=spilled,
        penalty=penalty)


def greedy_vrp_dispatch(dist, demands, capacity, max_distance, tw_open,
                        tw_close) -> DispatchSolution:
    """One problem: ``dist (N+1, N+1)``, ``demands`` / ``tw_open`` /
    ``tw_close (N,)``, scalar constraints → a solution whose fields have
    no batch axis."""
    sol = greedy_vrp_dispatch_batch(
        dist[None], demands[None], _one(capacity, dist),
        _one(max_distance, dist), tw_open[None], tw_close[None])
    return DispatchSolution(*(f[0] for f in sol))


def greedy_vrp_tw(dist, demands, capacity, max_distance, tw_open,
                  tw_close) -> DispatchSolution:
    """Time-window variant (naming alias of the dispatch core)."""
    return greedy_vrp_dispatch(dist, demands, capacity, max_distance,
                               tw_open, tw_close)


def greedy_vrp_spill(dist, demands, capacity,
                     max_distance) -> DispatchSolution:
    """Pure demand-spillover variant: no windows (all open from clock 0,
    closing at ``NO_WINDOW``), so the only spill source is demand over
    capacity on reachable stops."""
    n = dist.shape[0] - 1
    return greedy_vrp_dispatch(
        dist, demands, capacity, max_distance,
        torch.zeros(n, dtype=dist.dtype, device=dist.device),
        torch.full((n,), NO_WINDOW, dtype=dist.dtype, device=dist.device))


def _unpack_dispatch(order: np.ndarray, trip_ids: np.ndarray, n_routed: int,
                     n_spilled: int, unroutable: np.ndarray,
                     spilled: np.ndarray, penalty: np.float32,
                     n_real: int) -> dict:
    """One problem's solver arrays → host dict (shared by single and
    batch); ``n_real`` masks batch padding out of the stop masks."""
    trips: list = []
    for pos in range(n_routed):
        tid = int(trip_ids[pos])
        while len(trips) <= tid:
            trips.append([])
        trips[tid].append(int(order[pos]))
    trips = [t for t in trips if t]
    return {
        "trips": trips,
        "optimized_order": [int(i) for i in order[:n_routed]],
        "n_trips": len(trips),
        "spill_lane": [int(i) for i in
                       order[n_routed:n_routed + n_spilled]],
        "spilled": [int(i) for i in np.flatnonzero(spilled[:n_real])],
        "penalty": float(penalty),
        "unroutable": [int(i) for i in np.flatnonzero(unroutable[:n_real])],
    }


def _solve_dispatch(dist_b: np.ndarray, dem_b: np.ndarray,
                    open_b: np.ndarray, close_b: np.ndarray,
                    caps: np.ndarray, maxds: np.ndarray, n_real: List[int],
                    device) -> list:
    """Padded host arrays → the plans of the first ``len(n_real)``
    problems: one host→device copy of every input, the batched solve,
    one device→host copy of every output (the penalty rides as its
    float32 bits)."""
    b, p = dem_b.shape
    host = np.concatenate([dist_b.reshape(b, -1), dem_b, open_b, close_b,
                           caps[:, None], maxds[:, None]], axis=1)
    packed = torch.from_numpy(host.astype(np.float32)).to(device)
    k = (p + 1) * (p + 1)
    cols = [packed[:, k + i * p:k + (i + 1) * p] for i in range(3)]
    sol = greedy_vrp_dispatch_batch(
        packed[:, :k].reshape(b, p + 1, p + 1), cols[0],
        packed[:, -2], packed[:, -1], cols[1], cols[2])
    out = torch.cat([sol.order, sol.trip_ids, sol.n_routed[:, None],
                     sol.n_spilled[:, None], sol.unroutable.to(torch.int64),
                     sol.spilled.to(torch.int64),
                     sol.penalty.view(torch.int32).to(torch.int64)[:, None]],
                    dim=1).cpu().numpy()
    penalty = out[:, -1].astype(np.int32).view(np.float32)
    return [
        _unpack_dispatch(out[i, :p], out[i, p:2 * p], int(out[i, 2 * p]),
                         int(out[i, 2 * p + 1]),
                         out[i, 2 * p + 2:3 * p + 2].astype(bool),
                         out[i, 3 * p + 2:4 * p + 2].astype(bool),
                         penalty[i], n)
        for i, n in enumerate(n_real)
    ]


def solve_host_dispatch(dist: np.ndarray, demands: np.ndarray,
                        capacity: float, max_distance: float,
                        tw_open=None, tw_close=None, device=None) -> dict:
    """One dispatch problem on ``device`` (``cuda`` unless the caller
    asks for the CPU): numpy in, plain Python out. ``tw_open`` /
    ``tw_close`` default to the no-window problem (spillover only); for
    window-free problems whose demands all fit the vehicle, the real
    trips equal :func:`solve_host`'s."""
    n = len(demands)
    if not (np.isfinite(np.float32(capacity))
            and np.isfinite(np.float32(max_distance))):
        raise ValueError("solve_host_dispatch: capacity/max_distance "
                         "must be finite")
    dev = resolve_device(device, "solve_host_dispatch")
    opens = (np.zeros(n, np.float32) if tw_open is None
             else np.asarray(tw_open, np.float32))
    closes = (np.full(n, NO_WINDOW, np.float32) if tw_close is None
              else np.asarray(tw_close, np.float32))
    return _solve_dispatch(
        np.asarray(dist, np.float32)[None],
        np.asarray(demands, np.float32)[None], opens[None], closes[None],
        np.asarray([capacity], np.float32),
        np.asarray([max_distance], np.float32), [n], dev)[0]


def solve_host_dispatch_batch(dists, demands, capacities, max_distances,
                              tw_opens=None, tw_closes=None,
                              device=None) -> list:
    """Many dispatch problems in one batched solve on ``device`` — the
    program behind the dispatch batcher. The JAX package's padding
    recipe: stops pad to the batch's largest count rounded up to a power
    of two, the batch to a power of two, padded stops are ``_FAR`` (so
    unreachable, reported in ``unroutable`` and cut by ``n_real``, never
    in the lane), window pads open from 0 and never close."""
    b = len(dists)
    if b == 0:
        return []
    caps_np = np.asarray(capacities, np.float32)
    maxd_np = np.asarray(max_distances, np.float32)
    if not (np.isfinite(caps_np).all() and np.isfinite(maxd_np).all()):
        raise ValueError("solve_host_dispatch_batch: capacity/"
                         "max_distance must be finite")
    dev = resolve_device(device, "solve_host_dispatch_batch")
    n_real = [np.shape(d)[0] - 1 for d in dists]
    p = 1 << max(0, (max(n_real) - 1)).bit_length()
    b_pad = 1 << max(0, (b - 1)).bit_length()

    far = np.float32(_FAR)
    dist_b = np.full((b_pad, p + 1, p + 1), far, np.float32)
    dem_b = np.full((b_pad, p), far, np.float32)
    open_b = np.zeros((b_pad, p), np.float32)
    close_b = np.full((b_pad, p), np.float32(NO_WINDOW), np.float32)
    for i, (d, dem, n) in enumerate(zip(dists, demands, n_real)):
        dist_b[i, : n + 1, : n + 1] = d
        dem_b[i, :n] = dem
        if tw_opens is not None and tw_opens[i] is not None:
            open_b[i, :n] = np.asarray(tw_opens[i], np.float32)
        if tw_closes is not None and tw_closes[i] is not None:
            close_b[i, :n] = np.asarray(tw_closes[i], np.float32)
    pad_ones = np.ones(b_pad - b, np.float32)
    return _solve_dispatch(dist_b, dem_b, open_b, close_b,
                           np.concatenate([caps_np, pad_ones]),
                           np.concatenate([maxd_np, pad_ones]), n_real, dev)
