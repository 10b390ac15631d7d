"""Synthetic Metro Manila road graph, host numpy.

The counterpart of ``routest_tpu/data/road_graph.py``, copied with its
imports pointed at the port's ``data/locations.py``: the same seed gives
bitwise the same arrays, so the serving graph's fingerprint (which the
learned leg-cost artifacts are bound to) is the same in both packages.

- intersection nodes sampled over the Metro Manila bounding box, with
  density clustered around the 21 seed sites (``data/locations.py``);
- edges from k-nearest-neighbor connection (symmetrized);
- per-edge length (haversine × 1.2), road class, speed limit, and an
  observed travel time from a ground-truth congestion model with
  log-normal noise (the GNN's training target).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from routest_tpu_torch.data.locations import coords_array

# Metro Manila bounding box (covers all 21 seed sites with margin).
LAT_RANGE = (14.38, 14.70)
LON_RANGE = (120.94, 121.12)

ROAD_CLASSES = ("arterial", "collector", "local")
_CLASS_SPEED_MPS = np.asarray([11.1, 8.3, 5.6])   # 40 / 30 / 20 km/h
_CLASS_RUSH_SENSITIVITY = np.asarray([0.8, 0.5, 0.25])


def haversine_np(lat1, lon1, lat2, lon2):
    """Great-circle meters, vectorized numpy (the road router's snap and
    first/last-mile charge build on it)."""
    r = 6_371_008.8
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return 2 * r * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


_haversine_np = haversine_np  # internal alias (existing call sites)


def true_edge_time_s(length_m: np.ndarray, road_class: np.ndarray,
                     hour: np.ndarray) -> np.ndarray:
    """Ground-truth travel time per edge (no noise)."""
    base = length_m / _CLASS_SPEED_MPS[road_class]
    h = hour.astype(np.float64)
    rush = (np.exp(-0.5 * ((h - 8.0) / 1.6) ** 2)
            + np.exp(-0.5 * ((h - 18.0) / 1.8) ** 2))
    congestion = 1.0 + _CLASS_RUSH_SENSITIVITY[road_class] * rush
    night = np.where((h >= 22) | (h <= 5), 0.85, 1.0)
    return base * congestion * night + 4.0  # signalized-intersection overhead


def knn_neighbors(coords: np.ndarray, k: int) -> np.ndarray:
    """(N, 2) → (N, k) nearest-neighbor indices.

    Brute force up to 8,192 nodes — EXACT and byte-stable, which the
    serving graph's fingerprint depends on (2,048-node default). Above
    that, a cell-hashed search: the O(N²) distance matrix would need
    20 GB at 50k nodes (the metro-scale benchmark regime), while cells
    sized for ~2 points each make the search O(N·k). The cell pass is
    exact too (rings expand until k candidates can't be beaten), just
    not guaranteed byte-identical in tie order — fine for new graphs,
    which fingerprint whatever they get.
    """
    n = len(coords)
    if n <= 8192:
        d2 = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        return np.argsort(d2, axis=1)[:, :k]

    lat_min, lon_min = coords.min(axis=0)
    lat_max, lon_max = coords.max(axis=0)
    # ~2 points per cell on average
    n_cells = max(1, int(np.sqrt(n / 2.0)))
    cw_lat = (lat_max - lat_min) / n_cells + 1e-9
    cw_lon = (lon_max - lon_min) / n_cells + 1e-9
    ix = np.minimum(((coords[:, 0] - lat_min) / cw_lat).astype(np.int64),
                    n_cells - 1)
    iy = np.minimum(((coords[:, 1] - lon_min) / cw_lon).astype(np.int64),
                    n_cells - 1)
    cell = ix * n_cells + iy
    order = np.argsort(cell, kind="stable")
    sorted_cell = cell[order]
    starts = np.searchsorted(sorted_cell, np.arange(n_cells * n_cells))
    ends = np.searchsorted(sorted_cell, np.arange(n_cells * n_cells), "right")

    out = np.empty((n, k), np.int64)
    for i in range(n):
        r = 1
        while True:
            x0, x1 = max(ix[i] - r, 0), min(ix[i] + r, n_cells - 1)
            y0, y1 = max(iy[i] - r, 0), min(iy[i] + r, n_cells - 1)
            # order[] is cell-sorted, so within row cx the cells y0..y1
            # are one contiguous slice
            cand = np.concatenate([
                order[starts[cx * n_cells + y0]: ends[cx * n_cells + y1]]
                for cx in range(x0, x1 + 1)
            ])
            cand = cand[cand != i]
            if len(cand) >= k:
                d2 = ((coords[cand] - coords[i]) ** 2).sum(axis=1)
                kth = np.sqrt(np.partition(d2, k - 1)[k - 1])
                # Exactness: the window is guaranteed to cover at least
                # (r-1)·cell_width around the point (it may sit at its
                # cell's edge); accept only when the kth neighbor lies
                # within that covered radius — otherwise a nearer point
                # could hide one ring further out.
                if kth <= (r - 1) * min(cw_lat, cw_lon) or r >= n_cells:
                    out[i] = cand[np.argsort(d2, kind="stable")[:k]]
                    break
            elif r >= n_cells:  # degenerate: take what exists, pad w/ self
                d2 = ((coords[cand] - coords[i]) ** 2).sum(axis=1)
                top = cand[np.argsort(d2, kind="stable")]
                out[i] = np.concatenate(
                    [top, np.full(k - len(top), i, np.int64)])[:k]
                break
            r += 1
    return out


def add_congestion_observations(graph: Dict[str, np.ndarray], seed: int = 0,
                                noise_sigma: float = 0.06,
                                samples_per_edge: int = 1) -> Dict[str, np.ndarray]:
    """Congestion-overlay training targets for ANY road graph.

    Takes a topology-only graph dict (``senders``/``length_m``/
    ``road_class`` — e.g. an OSM extract from ``data/osm.py``, which
    carries no travel-time labels) and adds the per-edge observation
    columns the GNN trains on: a sampled observation ``hour``, the
    ground-truth congestion-model time (``true_edge_time_s`` — rush-hour
    peaks, class sensitivity, night discount), and log-normally noised
    observed time. In production these columns would come from fleet
    telemetry; the overlay is the stand-in that makes learned leg costs
    trainable on arbitrary real road networks, not only on the synthetic
    generator whose observations are baked in (the round-2 gap: OSM
    ingest and GNN serving were mutually exclusive).

    ``samples_per_edge > 1`` tiles the edge arrays, drawing an
    independent observation hour per copy — small extracts need several
    observations per edge to expose the congestion curve's shape. The
    serving fingerprint must be computed from the UN-tiled graph (the
    topology serving aggregates over), so pass the base dict to
    ``save_gnn`` and the tiled one only to the training batch.
    """
    rng = np.random.default_rng(seed)
    out = dict(graph)
    if samples_per_edge > 1:
        for key in ("senders", "receivers", "length_m", "road_class",
                    "speed_limit"):
            if key in out:
                out[key] = np.tile(np.asarray(out[key]), samples_per_edge)
    n_edges = len(out["senders"])
    road_class = np.asarray(out["road_class"], np.int32)
    length_m = np.asarray(out["length_m"], np.float32)
    hour = rng.integers(0, 24, size=n_edges).astype(np.int32)
    t_true = true_edge_time_s(length_m, road_class, hour)
    time_s = (t_true * rng.lognormal(0.0, noise_sigma, n_edges)).astype(np.float32)
    out["hour"] = hour
    out["time_s"] = time_s
    out["time_true_s"] = t_true.astype(np.float32)
    return out


def subdivide_graph(graph: Dict[str, np.ndarray], bends_per_edge: int = 2,
                    jitter: float = 0.08, oneway_frac: float = 0.0,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Intersection graph → OSM-extract *topology*: every street gains
    ``bends_per_edge`` degree-2 geometry nodes (the defining shape of a
    real extract, where ``load_osm`` keeps every ``<nd>`` bend as a
    vertex — 70-85% of a real city's nodes are degree-2 chain
    vertices), with perpendicular jitter so chains curve like streets,
    and ``oneway_frac`` of streets keeping only their forward
    direction. Chain vertices multiply the hop diameter by
    ``bends_per_edge + 1``, which is exactly the regime that breaks
    diameter-bound relaxation and that the partition overlay
    (``optimize/hierarchy.py``) is built for.

    Returns a topology-only graph dict (no congestion columns — pipe
    through :func:`add_congestion_observations` for training data).
    """
    rng = np.random.default_rng(seed)
    coords = np.asarray(graph["node_coords"], np.float64)
    senders = np.asarray(graph["senders"], np.int64)
    receivers = np.asarray(graph["receivers"], np.int64)
    road_class = np.asarray(graph["road_class"], np.int32)
    speed_limit = np.asarray(
        graph.get("speed_limit", _CLASS_SPEED_MPS[road_class]), np.float32)
    n = len(coords)
    k = int(bends_per_edge)

    # Unique undirected streets; attrs from each street's first edge.
    key = np.minimum(senders, receivers) * n + np.maximum(senders, receivers)
    _, first = np.unique(key, return_index=True)
    a, b = senders[first], receivers[first]
    u = len(a)
    cls_u, spd_u = road_class[first], speed_limit[first]

    # Bend coordinates: linear interpolation + perpendicular jitter.
    t = ((np.arange(k) + 1) / (k + 1))[None, :, None]         # (1, k, 1)
    bends = coords[a][:, None, :] * (1 - t) + coords[b][:, None, :] * t
    d = coords[b] - coords[a]
    norm = np.sqrt((d ** 2).sum(axis=1, keepdims=True)) + 1e-12
    perp = np.stack([-d[:, 1], d[:, 0]], axis=1) / norm
    amp = norm[:, :1] * jitter
    bends += perp[:, None, :] * (rng.standard_normal((u, k, 1)) * amp[:, None])
    new_coords = np.concatenate(
        [coords, bends.reshape(-1, 2)]).astype(np.float32)

    # Chains: a → bend_0 → … → bend_{k-1} → b (and back, unless oneway).
    bend_ids = n + (np.arange(u)[:, None] * k + np.arange(k)[None, :])
    seq = np.concatenate([a[:, None], bend_ids, b[:, None]], axis=1)
    fwd_s, fwd_r = seq[:, :-1], seq[:, 1:]                    # (U, k+1)
    keep_rev = rng.random(u) >= oneway_frac
    new_s = np.concatenate([fwd_s.reshape(-1), fwd_r[keep_rev].reshape(-1)])
    new_r = np.concatenate([fwd_r.reshape(-1), fwd_s[keep_rev].reshape(-1)])
    reps = np.concatenate([np.repeat(np.arange(u), k + 1),
                           np.repeat(np.arange(u)[keep_rev], k + 1)])
    length = haversine_np(new_coords[new_s, 0], new_coords[new_s, 1],
                          new_coords[new_r, 0], new_coords[new_r, 1])
    return {
        "node_coords": new_coords,
        "senders": new_s.astype(np.int32),
        "receivers": new_r.astype(np.int32),
        "length_m": length.astype(np.float32),
        "road_class": cls_u[reps],
        "speed_limit": spd_u[reps],
    }


def generate_road_graph(n_nodes: int = 4096, k: int = 4, seed: int = 0,
                        noise_sigma: float = 0.06) -> Dict[str, np.ndarray]:
    """Graph dict: node_coords (N,2), senders/receivers (E,), edge feature
    arrays, observed times, plus a train-time ``hour`` per edge sample."""
    rng = np.random.default_rng(seed)

    # Node positions: 70% clustered around seed sites, 30% uniform fill.
    sites = coords_array()
    n_cluster = int(n_nodes * 0.7)
    centers = sites[rng.integers(0, len(sites), n_cluster)]
    cluster = centers + rng.normal(0, 0.012, size=(n_cluster, 2))
    uniform = np.stack([
        rng.uniform(*LAT_RANGE, n_nodes - n_cluster),
        rng.uniform(*LON_RANGE, n_nodes - n_cluster),
    ], axis=1)
    coords = np.concatenate([cluster, uniform]).astype(np.float32)
    coords[:, 0] = np.clip(coords[:, 0], *LAT_RANGE)
    coords[:, 1] = np.clip(coords[:, 1], *LON_RANGE)

    nbrs = knn_neighbors(coords, k)
    senders = np.repeat(np.arange(n_nodes), k)
    receivers = nbrs.reshape(-1)
    # symmetrize + dedupe
    pairs = np.stack([np.minimum(senders, receivers),
                      np.maximum(senders, receivers)], axis=1)
    pairs = np.unique(pairs, axis=0)
    senders = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int32)
    receivers = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int32)

    length_m = _haversine_np(
        coords[senders, 0], coords[senders, 1],
        coords[receivers, 0], coords[receivers, 1],
    ).astype(np.float32) * 1.2  # street grid vs straight line

    n_edges = len(senders)
    road_class = rng.choice(len(ROAD_CLASSES), size=n_edges,
                            p=[0.2, 0.35, 0.45]).astype(np.int32)
    speed_limit = _CLASS_SPEED_MPS[road_class].astype(np.float32)
    hour = rng.integers(0, 24, size=n_edges).astype(np.int32)

    t_true = true_edge_time_s(length_m, road_class, hour)
    time_s = (t_true * rng.lognormal(0.0, noise_sigma, n_edges)).astype(np.float32)

    return {
        "node_coords": coords,
        "senders": senders,
        "receivers": receivers,
        "length_m": length_m,
        "road_class": road_class,
        "speed_limit": speed_limit,
        "hour": hour,
        "time_s": time_s,
        "time_true_s": t_true.astype(np.float32),
    }
