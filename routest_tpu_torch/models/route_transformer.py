"""Route-sequence transformer: per-leg travel seconds with route context.

The counterpart of ``routest_tpu/models/route_transformer.py``'s
single-device forward (``RouteTransformer.apply``), float32 throughout
as there: per-edge features (``models/gnn.py::edge_feature_array``) plus
a sinusoidal position encoding, ``n_layers`` pre-LN encoder blocks
(multi-head self-attention, tanh-gelu MLP), and a head that scales the
free-flow time by ``softplus(w·h + b + 1)``.

Attention is a private copy of the JAX package's single-device
``full_attention`` (``routest_tpu/parallel/ring.py:36-58``), op for op:
masked scores filled with a finite ``-1e30``, softmax, re-masked,
renormalized with a ``1e-30`` floor, and fully masked rows zeroed.
``scaled_dot_product_attention`` would treat a fully masked row
differently. The sequence-parallel flavours (ring, Ulysses) wait for
Queue A item 16.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from routest_tpu_torch.models.eta_mlp import softplus
from routest_tpu_torch.models.gnn import N_EDGE_FEATURES, copy_layers

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

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, freeflow_s: torch.Tensor,
                positions: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
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

