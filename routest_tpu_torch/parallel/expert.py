"""Expert parallelism: a Switch-style MoE layer over an ``expert`` axis.

The counterpart of ``routest_tpu/parallel/expert.py``. Per-expert MLPs
live on their own shards; tokens travel to their expert and back by
``all_to_all``. Top-1 routing, capacity-bounded (the Switch
Transformer recipe):

1. tokens are split over the ``expert`` axis (it doubles as the token
   batch's data axis);
2. each shard routes its tokens (``argmax`` over the router logits; a
   tie goes to the first expert, as in JAX) and packs, per destination
   expert, up to ``capacity = max(1, int(capacity_factor · b_local /
   n_experts))`` tokens into an (E, C, D) dispatch buffer — a token's
   slot is its ``cumsum`` rank among the shard's tokens for that
   expert, and a token past capacity is dropped (its output is zero);
3. one ``all_to_all`` hands every expert's shard the tokens routed to
   it; the local expert MLP runs on that (E·C, D) slab;
4. a second ``all_to_all`` returns the outputs, which scatter back into
   token order scaled by the router gate.

The pack is ``index_put`` with accumulation (the JAX ``.at[].add``);
a dropped token adds zeros. The Switch load-balance loss and the
dropped fraction are averaged over every shard.
:func:`init_moe_params` draws the JAX ``init_moe_params``' weights from
the port's threefry (``core/prng.py``) bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from routest_tpu_torch.core import prng, smap
from routest_tpu_torch.core.smap import P, shard_map

Params = Dict


def init_moe_params(key: torch.Tensor, n_experts: int, d_model: int,
                    d_hidden: int) -> Params:
    """Router + stacked expert FFNs (leading axis = expert), float32 on
    the key's device."""
    kr, k1, k2 = prng.split(key, 3)
    s1 = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d_model)),
                      device=key.device)
    s2 = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d_hidden)),
                      device=key.device)
    return {
        "router": prng.normal(kr, (d_model, n_experts)) * s1,
        "w1": prng.normal(k1, (n_experts, d_model, d_hidden)) * s1,
        "b1": torch.zeros((n_experts, d_hidden), device=key.device),
        "w2": prng.normal(k2, (n_experts, d_hidden, d_model)) * s2,
        "b2": torch.zeros((n_experts, d_model), device=key.device),
    }


def moe_params_from_numpy(params: Params, device="cpu") -> Params:
    """The JAX MoE params (numpy leaves) as float32 tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params.items()}


def shard_moe_params(params: Params, mesh,
                     expert_axis: str = "expert") -> Params:
    """The MoE params laid out for :func:`make_moe_apply`: the experts'
    leading axis must be the expert-axis size; leaves on the mesh's
    first device, taking gradients (the router is replicated by the
    program's spec)."""
    n = mesh.shape[expert_axis]
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(v)
        if k != "router" and t.shape[0] != n:
            raise ValueError(f"{k} holds {t.shape[0]} experts, the "
                             f"{expert_axis!r} axis {n}")
        out[k] = t.detach().to(mesh.lead_device).clone().requires_grad_(True)
    return out


def _expert_ffn(w1, b1, w2, b2, x):
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def moe_apply_dense(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Single-device oracle: every token through its argmax expert, no
    capacity limit. The EP layer matches it wherever no token
    overflowed."""
    logits = tokens @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    choice = torch.argmax(logits, dim=-1)                       # (B,)
    outs = torch.stack([
        _expert_ffn(params["w1"][e], params["b1"][e], params["w2"][e],
                    params["b2"][e], tokens)
        for e in range(params["w1"].shape[0])])                 # (E, B, D)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    picked = outs[choice, rows]                                 # (B, D)
    gate = gates.gather(1, choice[:, None])
    return picked * gate


def make_moe_apply(mesh, expert_axis: str = "expert",
                   capacity_factor: float = 2.0):
    """(params, tokens) → (outputs, aux) with experts and tokens split
    over ``expert_axis``. ``aux``: ``load_balance_loss`` and
    ``dropped_frac`` (the fraction of tokens past capacity, whose output
    is zero), both over every shard."""
    n_exp = mesh.shape[expert_axis]
    ex = P(expert_axis)

    def run(params, tokens):
        b_local, d = tokens.shape
        capacity = max(1, int(capacity_factor * b_local / n_exp))

        logits = tokens @ params["router"]                   # (b, E)
        gates = torch.softmax(logits, dim=-1)
        choice = torch.argmax(logits, dim=-1)                # (b,)
        gate = gates.gather(1, choice[:, None])[:, 0]

        # each token's slot within its expert's capacity window
        one_hot = F.one_hot(choice, n_exp).to(torch.int32)   # (b, E)
        pos_in_expert = (torch.cumsum(one_hot, dim=0) - 1) * one_hot
        slot = pos_in_expert.sum(dim=1)                      # (b,)
        keep = slot < capacity                               # overflow drops

        # pack: dispatch[e, c] = the token routed to expert e at slot c
        src = torch.where(keep, choice, torch.zeros_like(choice))
        slot_c = torch.clamp(slot, 0, capacity - 1).to(torch.int64)
        dispatch = torch.zeros((n_exp, capacity, d), dtype=tokens.dtype,
                               device=tokens.device).index_put(
            (src, slot_c), tokens * keep[:, None].to(tokens.dtype),
            accumulate=True)

        # (dest_expert, C, D) → every shard receives its expert's slab
        # from all source shards: (n_source, C, D)
        arriving = smap.all_to_all(dispatch, expert_axis, split_axis=0,
                                   concat_axis=0)
        out = _expert_ffn(params["w1"][0], params["b1"][0],
                          params["w2"][0], params["b2"][0],
                          arriving.reshape(-1, d))
        out = out.reshape(n_exp, capacity, d)
        returned = smap.all_to_all(out, expert_axis, split_axis=0,
                                   concat_axis=0)

        # unpack: token i's output sits at returned[choice[i], slot[i]]
        gathered = returned[src, slot_c]                     # (b, D)
        y = gathered * (gate * keep.to(gate.dtype))[:, None]

        # Switch load-balance loss: E · Σ_e (frac to e)(mean prob of e),
        # averaged over the shards so each reports the global value
        frac = one_hot.to(torch.float32).mean(dim=0)
        prob = gates.mean(dim=0)
        lbl = n_exp * torch.sum(smap.pmean(frac, expert_axis)
                                * smap.pmean(prob, expert_axis))
        dropped = smap.pmean(1.0 - keep.to(torch.float32).mean(),
                             expert_axis)
        return y, {"load_balance_loss": lbl, "dropped_frac": dropped}

    return shard_map(
        run, mesh,
        ({"router": P(), "w1": ex, "b1": ex, "w2": ex, "b2": ex}, ex),
        (ex, P()))
