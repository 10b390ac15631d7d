"""Route-sequence transformer: per-leg travel seconds with route context.

The counterpart of ``routest_tpu/models/route_transformer.py`` on one
device (``RouteTransformer.apply``, ``init``, ``loss`` and
``sample_route_sequences``), float32 throughout as there: per-edge features (``models/gnn.py::edge_feature_array``) plus
a sinusoidal position encoding, ``n_layers`` pre-LN encoder blocks
(multi-head self-attention, tanh-gelu MLP), and a head that scales the
free-flow time by ``softplus(w·h + b + 1)``.

Attention is a private copy of the JAX package's single-device
``full_attention`` (``routest_tpu/parallel/ring.py:36-58``), op for op:
masked scores filled with a finite ``-1e30``, softmax, re-masked,
renormalized with a ``1e-30`` floor, and fully masked rows zeroed.
``scaled_dot_product_attention`` would treat a fully masked row
differently. Training differentiates the same forward with autograd;
:func:`sample_route_sequences` is host numpy, bitwise the JAX package's.
The sequence-parallel flavours (ring, Ulysses: ``make_sp_apply``,
``make_sp_train_step``) wait for Queue A item 9.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from routest_tpu_torch.core import prng
from routest_tpu_torch.models.eta_mlp import (host_array, layers_to_numpy,
                                              softplus)
from routest_tpu_torch.models.gnn import (N_EDGE_FEATURES, copy_layers,
                                          edge_feature_array)

_NEG = -1e30


def positional_encoding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(S,) integer positions → (S, d_model) sinusoidal encoding."""
    half = d_model // 2
    step = torch.log(torch.tensor(10000.0)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, device=positions.device)
                      * step.to(positions.device))
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, H, D) → (B, S, H, D), masked by ``key_mask`` (B, S) with
    1.0 = a real token."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(s.shape[-1], dtype=torch.bool,
                      device=s.device)[None, None, None, :]
    if key_mask is not None:
        mask = mask & (key_mask[:, None, None, :] > 0)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1) * mask
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    p = p / denom * torch.clamp(mask.sum(-1, keepdim=True), 0, 1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The JAX ``_ln``: population variance, ``rsqrt(var + 1e-6)``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * norm.weight + norm.bias


class _Block(nn.Module):
    def __init__(self, d: int, d_mlp: int) -> None:
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.ln2 = nn.LayerNorm(d)
        self.proj = nn.ModuleDict({name: nn.Linear(d, d)
                                   for name in ("q", "k", "v", "o")})
        self.mlp1 = nn.Linear(d, d_mlp)
        self.mlp2 = nn.Linear(d_mlp, d)


def _dense(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with the JAX (in, out) weight layout's order."""
    return x @ linear.weight.T + linear.bias


class RouteTransformer(nn.Module):
    """``forward`` is the JAX ``RouteTransformer.apply`` with
    ``full_attention``: (B, S, F) features, (B, S) free-flow seconds,
    (S,) positions, (B, S) key mask → (B, S) predicted leg seconds."""

    n_features = N_EDGE_FEATURES

    def __init__(self, d_model: int = 64, n_heads: int = 4,
                 n_layers: int = 2, d_mlp: int = 128) -> None:
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.n_layers, self.d_mlp = n_layers, d_mlp
        self.embed = nn.Linear(N_EDGE_FEATURES, d_model)
        self.blocks = nn.ModuleList(_Block(d_model, d_mlp)
                                    for _ in range(n_layers))
        self.head = nn.Linear(d_model, 1)

    @classmethod
    def from_numpy(cls, params: Dict, d_model: int, n_heads: int,
                   n_layers: int, d_mlp: int) -> "RouteTransformer":
        """The weight carry-over: the JAX params pytree (numpy leaves)
        → a module computing the same function."""
        model = cls(d_model, n_heads, n_layers, d_mlp)
        copy_layers([model.embed], [params["embed"]])
        copy_layers([model.head], [params["head"]])
        if len(params["layers"]) != n_layers:
            raise ValueError(f"params carry {len(params['layers'])} layers, "
                             f"n_layers={n_layers}")
        with torch.no_grad():
            for block, layer in zip(model.blocks, params["layers"]):
                for name in ("ln1", "ln2"):
                    norm = getattr(block, name)
                    norm.weight.copy_(torch.from_numpy(
                        np.array(layer[name]["g"], np.float32)))
                    norm.bias.copy_(torch.from_numpy(
                        np.array(layer[name]["b"], np.float32)))
                copy_layers([block.proj[n] for n in ("q", "k", "v", "o")],
                             [layer[n] for n in ("q", "k", "v", "o")])
                copy_layers([block.mlp1, block.mlp2],
                             [layer["mlp1"], layer["mlp2"]])
        return model

    def _dense_layers(self):
        """Every ``nn.Linear`` in the JAX init's draw order."""
        out = [self.embed]
        for block in self.blocks:
            out += [block.proj[n] for n in ("q", "k", "v", "o")]
            out += [block.mlp1, block.mlp2]
        return out + [self.head]

    @torch.no_grad()
    def init(self, key: torch.Tensor) -> "RouteTransformer":
        """The JAX ``RouteTransformer.init`` in place: per dense layer
        ``k1, key = split(key)``, ``w = normal(k1, (d_in, d_out)) /
        sqrt(d_in)``, zero bias; layer norms at gain 1, bias 0."""
        key = key.cpu()
        for linear in self._dense_layers():
            k1, key = prng.split(key, 2)
            d_in = linear.in_features
            w = prng.normal(k1, (d_in, linear.out_features)) \
                / torch.tensor(np.sqrt(np.float32(d_in)))
            linear.weight.copy_(w.T)
            linear.bias.zero_()
        for block in self.blocks:
            for norm in (block.ln1, block.ln2):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
        return self

    def to_numpy(self) -> Dict:
        """The JAX params pytree (numpy leaves): the inverse of
        :meth:`from_numpy`."""
        def dense(linear):
            return layers_to_numpy([linear])[0]

        def norm(ln):
            return {"b": host_array(ln.bias), "g": host_array(ln.weight)}

        return {
            "embed": dense(self.embed),
            "head": dense(self.head),
            "layers": [dict({n: dense(block.proj[n])
                             for n in ("q", "k", "v", "o")},
                            ln1=norm(block.ln1), ln2=norm(block.ln2),
                            mlp1=dense(block.mlp1), mlp2=dense(block.mlp2))
                       for block in self.blocks],
        }

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, freeflow_s: torch.Tensor,
                positions: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.predict(feats, freeflow_s, positions, key_mask)

    def predict(self, feats: torch.Tensor, freeflow_s: torch.Tensor,
                positions: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The differentiable forward: (B, S) predicted leg seconds."""
        b, s, _ = feats.shape
        dh = self.d_model // self.n_heads
        h = _dense(self.embed, feats)
        h = h + positional_encoding(positions, self.d_model)[None, :, :]
        for block in self.blocks:
            z = _ln(block.ln1, h)
            q, k, v = (_dense(block.proj[n], z).reshape(b, s, self.n_heads,
                                                        dh)
                       for n in ("q", "k", "v"))
            out = full_attention(q, k, v, key_mask=key_mask)
            h = h + out.reshape(b, s, self.d_model) @ block.proj["o"].weight.T \
                + block.proj["o"].bias
            z = _ln(block.ln2, h)
            h = h + F.gelu(_dense(block.mlp1, z), approximate="tanh") \
                @ block.mlp2.weight.T + block.mlp2.bias
        mult = softplus(_dense(self.head, h)[..., 0] + 1.0)
        return freeflow_s * mult

    @staticmethod
    def squared_residual(pred: torch.Tensor, targets: torch.Tensor,
                         freeflow_s: torch.Tensor, mask: torch.Tensor,
                         relative: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(masked Σ residual², valid count), the training objective. With
        ``relative`` (the training default) the residual is measured in
        multiplier space, ``(pred − target) / freeflow``, so long legs do
        not dominate; ``relative=False`` is seconds² (evaluation)."""
        w = mask.to(pred.dtype)
        resid = pred - targets
        if relative:
            resid = resid / torch.clamp_min(freeflow_s, 1.0)
        return torch.sum(w * resid ** 2), w.sum()

    def loss(self, feats: torch.Tensor, freeflow_s: torch.Tensor,
             positions: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor, relative: bool = True) -> torch.Tensor:
        """Masked mean of :meth:`squared_residual` over valid legs."""
        pred = self.predict(feats, freeflow_s, positions, key_mask=mask)
        sq, cnt = self.squared_residual(pred, targets, freeflow_s, mask,
                                        relative)
        return sq / torch.clamp_min(cnt, 1.0)


# ── training data: routes sampled from the road graph ────────────────────


def sample_route_sequences(graph: Dict[str, np.ndarray], n_routes: int,
                           seq_len: int, seed: int = 0,
                           noise_sigma: float = 0.06,
                           return_hours: bool = False,
                           return_true: bool = False) -> Tuple[np.ndarray, ...]:
    """Random-walk routes over a road graph → padded training arrays,
    host numpy, bitwise the JAX package's: (feats (R, L, F), freeflow_s
    (R, L), targets (R, L), mask (R, L)), plus hours (R,) with
    ``return_hours`` and noise-free times (R, L) with ``return_true``.
    One observation hour per route; targets from the congestion overlay
    the GNN trains on (``data/road_graph.py``)."""
    from routest_tpu_torch.data.road_graph import true_edge_time_s

    rng = np.random.default_rng(seed)
    senders = np.asarray(graph["senders"])
    receivers = np.asarray(graph["receivers"])
    n_nodes = len(graph["node_coords"])
    # adjacency: out-edge ids per node
    order = np.argsort(senders, kind="stable")
    sorted_senders = senders[order]
    starts = np.searchsorted(sorted_senders, np.arange(n_nodes))
    ends = np.searchsorted(sorted_senders, np.arange(n_nodes), "right")

    feats = np.zeros((n_routes, seq_len, N_EDGE_FEATURES), np.float32)
    freeflow = np.zeros((n_routes, seq_len), np.float32)
    targets = np.zeros((n_routes, seq_len), np.float32)
    targets_true = np.zeros((n_routes, seq_len), np.float32)
    mask = np.zeros((n_routes, seq_len), np.float32)

    length = np.asarray(graph["length_m"], np.float32)
    speed = np.asarray(graph["speed_limit"], np.float32)
    rclass = np.asarray(graph["road_class"], np.int32)

    hours = np.zeros((n_routes,), np.int32)
    for r in range(n_routes):
        hour = int(rng.integers(0, 24))
        hours[r] = hour
        node = int(rng.integers(0, n_nodes))
        n_legs = int(rng.integers(seq_len // 2, seq_len + 1))
        edge_ids = []
        for _ in range(n_legs):
            lo, hi = starts[node], ends[node]
            if hi <= lo:  # dead end: restart elsewhere
                node = int(rng.integers(0, n_nodes))
                lo, hi = starts[node], ends[node]
                if hi <= lo:
                    break
            e = int(order[rng.integers(lo, hi)])
            edge_ids.append(e)
            node = int(receivers[e])
        if not edge_ids:
            continue
        e_ids = np.asarray(edge_ids)
        k = len(e_ids)
        feats[r, :k] = edge_feature_array(
            length[e_ids], speed[e_ids], rclass[e_ids], hour)
        freeflow[r, :k] = length[e_ids] / np.maximum(speed[e_ids], 0.1) + 4.0
        t_true = true_edge_time_s(length[e_ids], rclass[e_ids],
                                  np.full(k, hour))
        targets[r, :k] = t_true * rng.lognormal(0.0, noise_sigma, k)
        targets_true[r, :k] = t_true
        mask[r, :k] = 1.0
    out = [feats, freeflow, targets, mask]
    if return_hours:
        out.append(hours)
    if return_true:
        out.append(targets_true)
    return tuple(out)

