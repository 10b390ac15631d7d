"""Road-graph GNN: learned per-edge travel seconds by message passing.

The counterpart of ``routest_tpu/models/gnn.py`` on one device
(``RoadGNN.apply``, ``init`` and ``loss``): node embeddings from
coordinates, then
``n_rounds`` rounds of edge messages (an MLP over sender state, receiver
state and edge features) mean-aggregated at each receiver, a residual
node update and a parameter-free layer norm, then a per-edge readout
decomposed as ``freeflow · softplus(a) + softplus(b)``.

``segment_sum`` becomes ``index_add_``, which on CUDA uses atomics, so
the card's sums are not bitwise repeatable: GNN outputs are held to a
tolerance. Matmuls, bias adds and gelu (tanh form, as ``jax.nn.gelu``)
run in the policy's compute dtype; the layer norm takes the population
variance, as ``jnp.var`` does.

Training keeps the JAX split between messages and loss: the batch's
``weights`` mask the MESSAGES (padding injects nothing), and
``loss_weights`` (default: the same mask) choose which edges the loss
reads — the live trainer labels only probed edges while every real
edge still carries messages. Autograd differentiates the same forward
the router serves; :meth:`RoadGNN.init` draws the JAX ``init``'s weights
from the port's threefry. :meth:`RoadGNN.make_sharded_loss` and
:meth:`RoadGNN.make_sharded_train_step` split the edges over a mesh's
``data`` axis (``core/smap.py``): node states stay whole on every shard,
and one ``psum`` per round (and one for the degrees) combines the
shards' neighbourhood aggregations, as the JAX package's do.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from routest_tpu_torch.core.config import resolve_device
from routest_tpu_torch.core.dtypes import DEFAULT_POLICY, Policy
from routest_tpu_torch.models.eta_mlp import (init_layers, layers_to_numpy,
                                              softplus)

_N_CLASSES = 3
_N_HOUR_FEATURES = 8  # four Fourier harmonics of hour-of-day
# [log_length, speed_limit/10] + class one-hot + cyclical hour
N_EDGE_FEATURES = 2 + _N_CLASSES + _N_HOUR_FEATURES


def _hour_features(hour: np.ndarray) -> np.ndarray:
    """(E,) hour-of-day → (E, 8) Fourier features (sin, cos of four
    harmonics), host numpy as in the JAX package."""
    ang = np.asarray(hour, np.float32) * np.float32(2.0 * np.pi / 24.0)
    return np.stack([np.sin(k * ang) if trig == "s" else np.cos(k * ang)
                     for k in (1, 2, 3, 4) for trig in ("s", "c")], axis=-1)


def edge_feature_array(length_m: np.ndarray, speed_limit: np.ndarray,
                       road_class: np.ndarray, hour) -> np.ndarray:
    """(E, 13) edge features from raw arrays; ``hour`` is scalar or
    (E,). Bitwise the JAX package's."""
    e = len(length_m)
    out = np.zeros((e, N_EDGE_FEATURES), np.float32)
    out[:, 0] = np.log1p(length_m)
    out[:, 1] = speed_limit / 10.0
    out[np.arange(e), 2 + road_class] = 1.0
    out[:, 2 + _N_CLASSES:] = _hour_features(np.broadcast_to(hour, (e,)))
    return out


def edge_features(graph: Dict[str, np.ndarray]) -> np.ndarray:
    return edge_feature_array(graph["length_m"], graph["speed_limit"],
                              graph["road_class"], graph["hour"])


class GraphBatch(NamedTuple):
    senders: torch.Tensor      # (E,) int64
    receivers: torch.Tensor    # (E,) int64
    edge_feats: torch.Tensor   # (E, F)
    length_m: torch.Tensor     # (E,)
    speed_limit: torch.Tensor  # (E,) m/s
    targets: torch.Tensor      # (E,) observed seconds
    weights: torch.Tensor      # (E,) 0/1 (padding mask)


def graph_batch(graph: Dict[str, np.ndarray], pad_to: int = 0,
                device=None) -> GraphBatch:
    """A road-graph dict (with ``hour`` and ``time_s``) as a GraphBatch
    on ``device``, optionally padded so the edge count is a multiple of
    ``pad_to``. Padded edges self-loop node 0 with zero weight."""
    dev = resolve_device(device, "graph_batch")
    e = len(graph["senders"])
    target_e = max(e, pad_to) if pad_to else e
    if pad_to and target_e % pad_to:
        target_e = ((target_e + pad_to - 1) // pad_to) * pad_to

    def pad(x, dtype, fill=0):
        x = np.asarray(x, dtype)
        if len(x) < target_e:
            x = np.concatenate([x, np.full((target_e - len(x),) + x.shape[1:],
                                           fill, dtype)])
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return GraphBatch(
        senders=pad(graph["senders"], np.int64),
        receivers=pad(graph["receivers"], np.int64),
        edge_feats=pad(edge_features(graph), np.float32),
        length_m=pad(graph["length_m"], np.float32),
        speed_limit=pad(graph["speed_limit"], np.float32, 1.0),
        targets=pad(graph["time_s"], np.float32),
        weights=pad(np.ones(e, np.float32), np.float32))


def copy_layers(linears, layers: List[Dict]) -> None:
    """JAX ``[{"w": (in, out), "b": (out,)}, ...]`` into ``linears``."""
    if len(layers) != len(linears):
        raise ValueError(f"params carry {len(layers)} layers, the module "
                         f"has {len(linears)}")
    with torch.no_grad():
        for linear, layer in zip(linears, layers):
            w = torch.from_numpy(np.array(layer["w"], np.float32))
            if tuple(w.shape) != (linear.in_features, linear.out_features):
                raise ValueError(
                    f"layer weight {tuple(w.shape)} does not fit "
                    f"({linear.in_features}, {linear.out_features})")
            linear.weight.copy_(w.T)
            linear.bias.copy_(torch.from_numpy(np.array(layer["b"],
                                                        np.float32)))


def _identity(x):
    return x


def mlp(linears: nn.ModuleList, x: torch.Tensor,
        compute: torch.dtype) -> torch.Tensor:
    """The JAX ``_mlp``: tanh-gelu between layers, none after the last,
    every product and bias add in ``compute``."""
    for i, linear in enumerate(linears):
        x = x @ linear.weight.to(compute).T + linear.bias.to(compute)
        if i < len(linears) - 1:
            x = F.gelu(x, approximate="tanh")
    return x


class RoadGNN(nn.Module):
    """``forward`` is the JAX ``RoadGNN.apply``: (N, 2) node lat/lon and
    the (E,) edge arrays → (E,) predicted seconds, float32."""

    def __init__(self, n_nodes: int, hidden: int = 64, n_rounds: int = 2,
                 policy: Policy = DEFAULT_POLICY) -> None:
        super().__init__()
        self.n_nodes = int(n_nodes)
        self.hidden = int(hidden)
        self.n_rounds = int(n_rounds)
        self.policy = policy
        h, f = self.hidden, N_EDGE_FEATURES
        dims = {"embed": (2, h), "msg": (2 * h + f, h, h), "upd": (2 * h, h),
                "readout": (2 * h + f, h, 2)}
        self.mlps = nn.ModuleDict({
            name: nn.ModuleList(nn.Linear(a, b, dtype=policy.param_dtype)
                                for a, b in zip(d[:-1], d[1:]))
            for name, d in dims.items()})

    @classmethod
    def from_numpy(cls, params: Dict, n_nodes: int, hidden: int,
                   n_rounds: int, policy: Policy = DEFAULT_POLICY
                   ) -> "RoadGNN":
        """The weight carry-over: the JAX params pytree (numpy leaves)
        → a module computing the same function."""
        model = cls(n_nodes, hidden, n_rounds, policy)
        for name, linears in model.mlps.items():
            copy_layers(linears, params[name])
        return model

    def init(self, key: torch.Tensor) -> "RoadGNN":
        """The JAX ``RoadGNN.init`` in place: embed, msg, upd, readout,
        one key chain."""
        key = key.cpu()
        for name in ("embed", "msg", "upd", "readout"):
            key = init_layers(self.mlps[name], key)
        return self

    def to_numpy(self) -> Dict:
        """The JAX params pytree (numpy leaves): the inverse of
        :meth:`from_numpy`."""
        return {name: layers_to_numpy(linears)
                for name, linears in self.mlps.items()}

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.mlps[name], x, self.policy.compute_dtype)

    @torch.no_grad()
    def forward(self, node_coords: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_feats: torch.Tensor,
                length_m: torch.Tensor,
                speed_limit: torch.Tensor) -> torch.Tensor:
        return self.predict(node_coords, senders, receivers, edge_feats,
                            length_m, speed_limit)

    def predict(self, node_coords: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, edge_feats: torch.Tensor,
                length_m: torch.Tensor, speed_limit: torch.Tensor,
                weights: Optional[torch.Tensor] = None,
                combine=_identity) -> torch.Tensor:
        """The differentiable forward: (E,) predicted seconds. Edges of
        weight 0 (padding) send no message and count in no degree.
        ``combine`` merges per-shard node aggregations (the identity on
        one device; a ``psum`` in a sharded program)."""
        c = self.policy.compute_dtype
        center = torch.tensor([14.54, 121.03], dtype=node_coords.dtype,
                              device=node_coords.device)
        coords_n = ((node_coords - center) * 50.0).to(c)
        h = F.gelu(self._mlp("embed", coords_n), approximate="tanh")
        ef = edge_feats.to(c)
        w = (torch.ones(senders.shape[0], dtype=c, device=ef.device)
             if weights is None else weights.to(c))
        degree = combine(torch.zeros(self.n_nodes, dtype=c, device=ef.device
                                     ).index_add(0, receivers, w))
        inv_deg = (1.0 / torch.clamp(degree, min=1.0))[:, None]
        for _ in range(self.n_rounds):
            m_in = torch.cat([h[senders], h[receivers], ef], dim=-1)
            messages = self._mlp("msg", m_in)
            if weights is not None:
                messages = messages * w[:, None]
            agg = torch.zeros((self.n_nodes, messages.shape[1]), dtype=c,
                              device=ef.device).index_add(0, receivers,
                                                          messages)
            agg = combine(agg) * inv_deg
            h = h + F.gelu(self._mlp("upd", torch.cat([h, agg], dim=-1)),
                           approximate="tanh")
            h = ((h - h.mean(-1, keepdim=True))
                 / torch.sqrt(h.var(-1, keepdim=True, correction=0) + 1e-6))
        r_in = torch.cat([h[senders], h[receivers], ef], dim=-1)
        out = self._mlp("readout", r_in).to(self.policy.output_dtype)
        freeflow = length_m / torch.clamp(speed_limit, min=0.1)
        return freeflow * softplus(out[..., 0]) + softplus(out[..., 1])

    def loss(self, node_coords: torch.Tensor, batch: GraphBatch,
             loss_weights: Optional[torch.Tensor] = None,
             combine=_identity, reduce=_identity) -> torch.Tensor:
        """Weighted MSE over the edges ``loss_weights`` selects (default:
        the batch's message mask); ``combine`` as in :meth:`predict`,
        ``reduce`` sums the per-shard error and count."""
        pred = self.predict(node_coords, batch.senders, batch.receivers,
                            batch.edge_feats, batch.length_m,
                            batch.speed_limit, weights=batch.weights,
                            combine=combine)
        lw = batch.weights if loss_weights is None else loss_weights
        err = (pred - batch.targets) ** 2 * lw
        return reduce(err.sum()) / torch.clamp_min(reduce(lw.sum()), 1.0)

    # ── mesh-parallel build ────────────────────────────────────────────

    def make_sharded_loss(self, mesh, data_axis: str = "data"):
        """(node_coords, batch) → the loss with the batch's edges split
        over ``data_axis`` (their count must divide by it: pad with
        ``graph_batch(pad_to=...)``), node states whole on every shard,
        one ``psum`` per round combining the aggregations. The model's
        parameters reach every shard (``core/smap.replica_on``)."""
        from routest_tpu_torch.core import smap
        from routest_tpu_torch.core.smap import P, shard_map

        combine = functools.partial(smap.psum, axis_name=data_axis)

        def sharded_loss(node_coords, batch):
            model = smap.replica_on(self, node_coords.device)
            return model.loss(node_coords, batch, combine=combine,
                              reduce=combine)

        return shard_map(sharded_loss, mesh,
                         (P(), GraphBatch(*([P(data_axis)] * 7))), P())

    def make_sharded_train_step(self, mesh, optimizer,
                                data_axis: str = "data"):
        """(node_coords, batch) → loss: one edge-sharded training step.
        ``optimizer`` holds this module's parameters (the port's AdamW,
        or anything with its ``params``/``step(grads)`` interface) and
        steps them in place."""
        loss_fn = self.make_sharded_loss(mesh, data_axis)

        def step(node_coords, batch):
            loss = loss_fn(node_coords, batch)
            grads = torch.autograd.grad(loss, optimizer.params)
            optimizer.step(grads)
            return loss.detach()

        return step
