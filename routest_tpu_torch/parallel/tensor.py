"""Tensor parallelism: the ETA trunk sharded over the mesh ``model`` axis.

The counterpart of ``routest_tpu/parallel/tensor.py``: Megatron-style
sharding of ``EtaMLP``'s weight matrices, alternating column and row
parallelism with one ``psum`` per pair:

- even matmuls are **column-parallel**: ``W (d_in, d_out)`` splits along
  ``d_out``; each shard computes its activation slice locally (the bias
  is split with it, gelu is elementwise);
- odd matmuls are **row-parallel**: ``W`` splits along ``d_in``, matching
  the split activation; the partial products meet in one ``psum`` over
  the model axis and the (replicated) bias is added after;
- a final layer whose input arrives whole runs replicated (``rep``).

Parameters travel as the JAX params tree of tensors, ``w`` as
``(in, out)`` (:func:`tp_params_from_module`, :func:`shard_tp_params`;
:func:`tp_params_to_numpy` is the way back, and ``EtaMLP.from_numpy``
rebuilds a module from it). Gradients flow back through the collectives
with autograd, so :func:`make_tp_train_step` trains under the same
layout with the port's AdamW (``train/loop.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from routest_tpu_torch.core import smap
from routest_tpu_torch.core.smap import P, shard_map
from routest_tpu_torch.models.eta_mlp import (EtaMLP, expand_features,
                                              quantile_heads_unfused,
                                              softplus)

Params = Dict


def _layer_modes(n_layers: int) -> list:
    """Per-layer schedule: "col" (shard outputs), "row" (shard inputs +
    psum), or "rep" (replicated — only for a final layer whose input
    arrives unsharded)."""
    modes = []
    sharded = False  # is the activation entering this layer sharded?
    for i in range(n_layers):
        if sharded:
            modes.append("row")
            sharded = False
        elif i == n_layers - 1:
            modes.append("rep")
        else:
            modes.append("col")
            sharded = True
    return modes


_MODE_SPECS = {
    "col": lambda ax: {"w": P(None, ax), "b": P(ax)},
    "row": lambda ax: {"w": P(ax, None), "b": P()},
    "rep": lambda ax: {"w": P(), "b": P()},
}


def tp_param_specs(model: EtaMLP, data_axis: str = "data",
                   model_axis: str = "model") -> Params:
    """The spec tree matching the EtaMLP params tree."""
    modes = _layer_modes(len(model.hidden) + 1)
    return {"layers": [_MODE_SPECS[m](model_axis) for m in modes],
            "norm": {"mean": P(), "std": P()}}


def _validate(model: EtaMLP, tp: int) -> None:
    dims = tuple(model.hidden) + (model.n_heads,)
    modes = _layer_modes(len(dims))
    for i, (mode, d_out) in enumerate(zip(modes, dims)):
        if mode == "col" and d_out % tp:
            raise ValueError(
                f"column-parallel layer {i} output width {d_out} is not "
                f"divisible by model-axis size {tp}")
        if mode == "row" and dims[i - 1] % tp:
            raise ValueError(
                f"row-parallel layer {i} input width {dims[i - 1]} is not "
                f"divisible by model-axis size {tp}")


def tp_params_from_module(model: EtaMLP) -> Params:
    """An ``EtaMLP`` module's weights as the JAX params tree of tensors
    (``w`` as ``(in, out)``), fresh copies on the module's device."""
    return {"layers": [{"b": lin.bias.detach().clone(),
                        "w": lin.weight.detach().T.contiguous()}
                       for lin in model.layers],
            "norm": {"mean": model.norm_mean.detach().clone(),
                     "std": model.norm_std.detach().clone()}}


def tp_params_to_numpy(params: Params) -> Params:
    """The params tree as float32 numpy (the JAX package's layout)."""
    return smap.tree_map(
        lambda t: t.detach().to("cpu", torch.float32).numpy().copy(), params)


def shard_tp_params(params: Params, model: EtaMLP, mesh,
                    data_axis: str = "data",
                    model_axis: str = "model") -> Params:
    """The params tree (numpy or tensors) laid out for
    :func:`make_tp_apply`: validated against the model axis, held on the
    mesh's first device, the layers' ``w`` and ``b`` as leaves that take
    gradients (the normalizer takes none, as the JAX ``stop_gradient``
    gives it)."""
    _validate(model, mesh.shape[model_axis])
    specs = tp_param_specs(model, data_axis, model_axis)
    if len(params["layers"]) != len(specs["layers"]):
        raise ValueError(f"params carry {len(params['layers'])} layers, "
                         f"the model {len(specs['layers'])}")
    device = mesh.lead_device

    def put(x, trainable):
        t = x.detach() if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.array(x, np.float32))
        return t.to(device).clone().requires_grad_(trainable)

    return {"layers": [{"b": put(layer["b"], True),
                        "w": put(layer["w"], True)}
                       for layer in params["layers"]],
            "norm": {"mean": put(params["norm"]["mean"], False),
                     "std": put(params["norm"]["std"], False)}}


def tp_trainable(params: Params) -> Tuple[List[torch.Tensor], List[bool]]:
    """The trainable leaves (per layer ``b`` then ``w``, the JAX leaf
    order) and their decay flags (weights only), for the port's AdamW."""
    leaves, decay = [], []
    for layer in params["layers"]:
        leaves += [layer["b"], layer["w"]]
        decay += [False, True]
    return leaves, decay


def make_tp_apply(model: EtaMLP, mesh, data_axis: str = "data",
                  model_axis: str = "model"):
    """(params, x) → (B,) ETA minutes — (B, Q) for a quantile model —
    with weights sharded over ``model_axis`` and the batch over
    ``data_axis``. Matches ``EtaMLP`` up to the row-parallel sum's
    order. Params as :func:`shard_tp_params` lays them out."""
    tp = mesh.shape[model_axis]
    _validate(model, tp)
    param_specs = tp_param_specs(model, data_axis, model_axis)
    n_layers = len(model.hidden) + 1
    modes = _layer_modes(n_layers)
    c = model.policy.compute_dtype
    out_dtype = model.policy.output_dtype
    n_q = len(model.quantiles)

    def tp_forward(params, x):
        feats, dist_km = expand_features(x, params["norm"]["mean"],
                                         params["norm"]["std"])
        h = feats.to(c)
        for i, (mode, layer) in enumerate(zip(modes, params["layers"])):
            w = layer["w"].to(c)
            b = layer["b"].to(c)
            if mode == "row":
                h = smap.psum(h @ w, model_axis) + b  # combine the pair
            else:  # "col": the local slice; "rep": the whole (tiny) head
                h = h @ w + b
            if i < n_layers - 1:
                h = F.gelu(h, approximate="tanh")
        out = h.to(out_dtype)
        d = dist_km.to(out_dtype)
        if n_q:
            # the head is whole on every shard here (a row-parallel last
            # layer psums, a replicated one never split): the JAX
            # cumulative epilogue, (B, Q)
            return quantile_heads_unfused(out, d, n_q)
        return softplus(out[..., 0]) * d + softplus(out[..., 1])

    return shard_map(tp_forward, mesh, (param_specs, P(data_axis)),
                     P(data_axis))


def make_tp_loss(model: EtaMLP, mesh, data_axis: str = "data",
                 model_axis: str = "model"):
    """(params, x, y) → scalar MSE under the TP layout, differentiable
    through the collectives. Point models only (the quantile objective
    is pinball; TP serving of quantile models is :func:`make_tp_apply`)."""
    if model.quantiles:
        raise ValueError("TP training implements the point-model MSE "
                         "objective; train quantile models data-parallel")
    tp_apply = make_tp_apply(model, mesh, data_axis, model_axis)

    def loss(params, x, y):
        pred = tp_apply(params, x)
        return torch.mean((pred - y.to(pred.device)) ** 2)

    return loss


def make_tp_train_step(model: EtaMLP, optimizer, mesh,
                       data_axis: str = "data", model_axis: str = "model"):
    """(params, x, y) → (params, loss): one tensor-parallel training
    step. ``optimizer`` holds the trainable leaves of ``params``
    (:func:`tp_trainable`) and steps them in place — the port's AdamW
    or anything with its ``params``/``step(grads)`` interface."""
    loss_fn = make_tp_loss(model, mesh, data_axis, model_axis)

    def step(params, x, y):
        loss = loss_fn(params, x, y)
        grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step(grads)
        return params, loss.detach()

    return step
