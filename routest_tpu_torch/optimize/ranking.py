"""Top-k candidate-route ranking, on the device.

The counterpart of ``routest_tpu/optimize/ranking.py``: materialize many
candidate visit orders (exhaustive for small N, perturbed-greedy plus a
uniform tail otherwise), score them all at once (path distance via
gathers, or the ETA model over the 12-feature encoding) and keep the
best k. The candidate generator draws its noise from
:mod:`routest_tpu_torch.core.prng`, the same threefry bits as
``jax.random``, so the candidate sets are the JAX package's.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from routest_tpu_torch.core import prng, smap
from routest_tpu_torch.core.config import resolve_device
from routest_tpu_torch.core.mesh import pad_to_multiple
from routest_tpu_torch.core.smap import P, shard_map
from routest_tpu_torch.data.features import encode_features
from routest_tpu_torch.models.eta_mlp import EtaMLP


class RankedRoutes(NamedTuple):
    orders: np.ndarray      # (k, N) visit orders, best first
    distances_m: np.ndarray  # (k,)
    etas_min: np.ndarray     # (k,) model ETA per candidate (nan if no model)


def _on_device(dist, device) -> torch.Tensor:
    """A float32 matrix on its own device (tensor) or on ``device``."""
    if isinstance(dist, torch.Tensor):
        return dist.to(torch.float32)
    return torch.tensor(np.asarray(dist, np.float32),
                        device=resolve_device(device))


def perturbed_greedy_orders(dist, k: int, seed: int = 0,
                            strength: float = 0.35,
                            device=None) -> np.ndarray:
    """(K, N) nearest-neighbor tours under multiplicatively noised costs.

    Each candidate is a greedy nearest-neighbor construction on
    ``dist * (1 + strength·U[0,1))``, ``U`` drawn per candidate from
    ``split(PRNGKey(seed), K)``; candidate 0 uses zero noise, i.e. the
    plain greedy-NN tour. All K tours are built at once: the candidate
    axis is the parallel axis, the N construction steps a loop with no
    host sync.
    """
    dist_t = _on_device(dist, device)
    keys = prng.split(prng.prng_key(seed, dist_t.device), k)
    # candidate 0 unperturbed; built on the device (a Python scalar
    # written into a device tensor would be a host copy and a sync)
    scale = torch.where(torch.arange(k, device=dist_t.device) == 0, 0.0,
                        strength).to(torch.float32)
    return _perturbed_greedy(dist_t, keys, scale).cpu().numpy().astype(
        np.int32)


def _perturbed_greedy(dist: torch.Tensor, keys: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    n = dist.shape[0] - 1
    k = keys.shape[0]
    noisy = dist * (1.0 + scale[:, None, None]
                    * prng.uniform(keys, dist.shape))
    rows = torch.arange(k, device=dist.device)
    current = torch.zeros(k, dtype=torch.int64, device=dist.device)
    visited = torch.zeros((k, n), dtype=torch.bool, device=dist.device)
    orders = torch.empty((k, n), dtype=torch.int64, device=dist.device)
    for step in range(n):
        cand = torch.where(visited, float("inf"), noisy[rows, current, 1:])
        j = cand.argmin(dim=1)   # first minimum, like jnp.argmin
        orders[:, step] = j
        visited.scatter_(1, j[:, None], True)
        current = j + 1
    return orders


def candidate_permutations(n_stops: int, max_candidates: int = 4096,
                           seed: int = 0,
                           greedy_order: Optional[np.ndarray] = None,
                           dist=None, device=None) -> np.ndarray:
    """(K, N) candidate visit orders, deduplicated (host numpy, sorted by
    ``np.unique`` as in the JAX package).

    Exhaustive when N! fits the budget. Otherwise, with a distance
    matrix: perturbed-greedy construction plus a 25% uniform-random
    tail; without one, uniform sampling. ``greedy_order`` (e.g. the VRP
    engine's order) is always included when given.
    """
    if math.factorial(n_stops) <= max_candidates:
        return np.asarray(list(itertools.permutations(range(n_stops))),
                          dtype=np.int32)
    rng = np.random.default_rng(seed)
    if dist is not None:
        n_uniform = max_candidates // 4  # may be 0 at tiny budgets
        informed = perturbed_greedy_orders(
            dist, max_candidates - n_uniform, seed=seed, device=device)
        tail = (np.stack([rng.permutation(n_stops)
                          for _ in range(n_uniform)]).astype(np.int32)
                if n_uniform else np.empty((0, n_stops), np.int32))
        perms = np.concatenate([informed, tail])
    else:
        perms = np.stack(
            [rng.permutation(n_stops) for _ in range(max_candidates)]
        ).astype(np.int32)
    if greedy_order is not None and len(greedy_order) == n_stops:
        perms[-1] = np.asarray(greedy_order, np.int32)
    # duplicates (perturbed greedy converges on good tours) waste score
    # slots and would surface twice in the top-k
    return np.unique(perms, axis=0)


def path_distances(dist: torch.Tensor, perms: torch.Tensor,
                   return_to_origin: bool = True) -> torch.Tensor:
    """(N+1, N+1) matrix, (K, N) perms (destination indices) → (K,)
    meters: one gather over the whole candidate set, legs summed left to
    right (the JAX package's float order)."""
    nodes = perms.to(torch.int64) + 1                 # all_points indexing
    origin = torch.zeros_like(nodes[:, :1])
    seq = torch.cat([origin, nodes] + ([origin] if return_to_origin else []),
                    dim=1)
    legs = dist[seq[:, :-1], seq[:, 1:]]
    total = legs[:, 0]
    for c in range(1, legs.shape[1]):
        total = total + legs[:, c]
    return total


def rank_routes(
    dist,
    k: int = 5,
    *,
    model: Optional[EtaMLP] = None,
    context: Optional[Dict] = None,
    speed_mps: float = 8.3,
    max_candidates: int = 4096,
    greedy_order: Optional[np.ndarray] = None,
    return_to_origin: bool = True,
    device=None,
    runtime=None,
) -> RankedRoutes:
    """Score candidates and return the k best.

    Ranking key: model ETA when ``model`` (the port's ``EtaMLP`` on the
    matrix's device; it carries its weights, the JAX ``params``
    argument) is given, else path
    duration at profile speed. ``context`` carries the weather/traffic/
    weekday/hour/driver_age the 12-feature encoding needs. Ties go to the
    lower candidate index, as with ``lax.top_k``.

    With a ``MeshRuntime`` the candidate axis is split over the mesh's
    ``data`` axis (``core/smap.py``): each shard gathers its candidates'
    distances and scores them; the candidate count is padded to a
    multiple of the shards with copies of the first candidate whose
    scores carry +3.4e38, so a padded candidate never surfaces. The
    matrix then lives on the mesh's first device.
    """
    if runtime is not None:
        device = runtime.device
    dist_t = _on_device(dist, device)
    n = dist_t.shape[0] - 1
    perms = candidate_permutations(n, max_candidates,
                                   greedy_order=greedy_order, dist=dist_t)
    n_real = perms.shape[0]

    def score_fn(dist_s, perms_s, penalty_s):
        d = path_distances(dist_s, perms_s, return_to_origin)
        if model is None:
            etas = torch.full_like(d, float("nan"))
            return d, etas, d / speed_mps + penalty_s
        ctx = context or {}
        kk = perms_s.shape[0]

        def col(value, dtype):
            return torch.full((kk,), value, dtype=dtype, device=d.device)

        feats = encode_features(
            col(int(ctx.get("weather_idx", 2)), torch.int64),
            col(int(ctx.get("traffic_idx", 2)), torch.int64),
            col(int(ctx.get("weekday", 0)), torch.int64),
            col(int(ctx.get("hour", 12)), torch.int64),
            d / 1000.0,
            col(float(ctx.get("driver_age", 30.0)), torch.float32),
        )
        with torch.no_grad():
            scorer = model if runtime is None \
                else smap.replica_on(model, d.device)
            etas = scorer(feats).float()
        return d, etas, etas + penalty_s

    penalty = np.zeros(n_real, np.float32)
    if runtime is not None:
        padded = pad_to_multiple(n_real, runtime.n_data)
        if padded != n_real:
            perms = np.concatenate(
                [perms, np.repeat(perms[:1], padded - n_real, axis=0)])
            penalty = np.zeros(padded, np.float32)
            penalty[n_real:] = np.float32(3.4e38)
        rows = P(runtime.data_axis)
        score_fn = shard_map(score_fn, runtime.mesh, (P(), rows, rows),
                             (rows, rows, rows))
    d, etas, score = score_fn(
        dist_t, torch.from_numpy(perms).to(dist_t.device),
        torch.from_numpy(penalty).to(dist_t.device))
    k = min(k, n_real)
    best = torch.argsort(score, stable=True)[:k]
    # one device→host copy: indices, distances and ETAs (all exact in
    # float64)
    host = torch.stack([best.double(), d[best].double(),
                        etas[best].double()]).cpu().numpy()
    return RankedRoutes(orders=perms[host[0].astype(np.int64)],
                        distances_m=host[1].astype(np.float32),
                        etas_min=host[2].astype(np.float32))
