"""Flat shortest-path primitives: Bellman-Ford sweeps and tight-edge
predecessor recovery, as PyTorch ops on the router's device.

The counterpart of the shared primitives at the top of
``routest_tpu/optimize/hierarchy.py`` (``relax_from``, ``tight_edges``,
``tight_pred``, ``hier_min_nodes``). The rest of that file — the
multi-level partition overlay and its hub labels — waits for Queue A
item 11; until then the port routes flat at every graph size.

A sweep is ``min(dist, segment_min(dist[:, senders] + w))`` over the
edges sorted by receiver. ``segment_min`` becomes a ``scatter_reduce``
with ``"amin"`` into a copy of ``dist`` (``include_self``): min and one
float32 add are exact, and JAX's empty-segment ``+inf`` is absorbed by
the ``min`` with ``dist`` either way, so the table is bitwise the JAX
one on any device. The edge order still matters: predecessor recovery
breaks ties by the largest SORTED edge id, as the JAX package does.

Each convergence check (``any(new < dist)`` after ``_K_SWEEPS`` sweeps)
is one host sync; ``relax_from.calls``, ``.sweeps`` and ``.checks`` count
solves, sweeps and checks for ``chip_smoke.py``.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

_INF = 3e38
# Sweeps between host checks: the check is a device sync, which
# dominates small graphs (the JAX package's constant).
_K_SWEEPS = 4


def _seg_min(values: torch.Tensor, index: torch.Tensor,
             init: torch.Tensor) -> torch.Tensor:
    """``min(init, segment_min(values))`` per row: (S, E) values folded
    by receiver ``index`` (E,) into a copy of the (S, N) ``init``."""
    idx = index.expand(values.shape[0], -1)
    return init.scatter_reduce(1, idx, values, "amin", include_self=True)


def relax_from(senders: torch.Tensor, receivers: torch.Tensor,
               w: torch.Tensor, dist0: torch.Tensor, *, max_iters: int
               ) -> Tuple[torch.Tensor, bool]:
    """Bellman-Ford sweeps from the (S, N) table ``dist0`` over
    receiver-sorted edges → (relaxed table, converged): converged is
    True iff a round of sweeps changed nothing, False when
    ``max_iters`` was reached first (the distances are then partial)."""
    relax_from.calls += 1
    dist = dist0
    it = 0
    changed = True
    while changed and it < max_iters:
        new = dist
        for _ in range(_K_SWEEPS):
            proposals = new.index_select(1, senders) + w[None, :]
            new = _seg_min(proposals, receivers, new)
        relax_from.sweeps += _K_SWEEPS
        relax_from.checks += 1
        changed = bool((new < dist).any())
        dist = new
        it += _K_SWEEPS
    return dist, not changed


relax_from.calls = 0
relax_from.sweeps = 0
relax_from.checks = 0


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


def hier_min_nodes() -> int:
    """The graph size at which the JAX package switches to its partition
    overlay (``ROUTEST_HIER_MIN_NODES``; 0 disables). The port has no
    overlay yet and routes flat at every size; the router logs when a
    graph reaches this size."""
    try:
        return int(os.environ.get("ROUTEST_HIER_MIN_NODES", "4096"))
    except ValueError:
        return 4096
