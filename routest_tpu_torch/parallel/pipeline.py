"""Pipeline parallelism: model stages mapped onto a mesh axis.

The counterpart of ``routest_tpu/parallel/pipeline.py``: a GPipe-style
fill-drain schedule as one per-shard program over a ``stage`` axis.

- a *stage* is any shape-preserving ``stage_fn(stage_params, x) -> x``,
  the same callable on every shard;
- per-stage parameters are STACKED along a leading axis of size
  ``n_stages`` and split ``P(stage_axis)``, so shard *s* holds stage
  *s*'s weights;
- tick *t* feeds microbatch *t* into stage 0, every stage transforms the
  activation it holds, and one ``ppermute`` per tick shifts activations
  forward; after ``n_stages + n_micro - 1`` ticks every microbatch has
  drained through the last stage, whose outputs a ``psum`` replicates.

Every stage runs ``stage_fn`` at every tick (past the fill window on
zeros that are never recorded), as the JAX scan does. Gradients
counter-rotate through the hops with autograd, so
:func:`make_pipeline_train_step` trains through the pipe. Bubble
fraction is the classic (S-1)/(S+M-1).
"""

from __future__ import annotations

from typing import Callable

import torch

from routest_tpu_torch.core import smap
from routest_tpu_torch.core.smap import P, shard_map, tree_map


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] (numpy or tensors) → one tree of
    tensors with a leading stage axis (leaf shapes must match)."""
    def stack(*leaves):
        return torch.stack([torch.as_tensor(leaf) for leaf in leaves])

    return tree_map(stack, per_stage_params[0], *per_stage_params[1:])


def shard_stage_params(stacked, mesh, stage_axis: str = "stage"):
    """The stacked tree laid out for the pipeline: its leading axis must
    be the stage count; leaves on the mesh's first device, taking
    gradients."""
    n = mesh.shape[stage_axis]

    def put(x):
        t = torch.as_tensor(x)
        if t.shape[0] != n:
            raise ValueError(f"stacked leading axis {t.shape[0]} is not "
                             f"the {n} stages of {stage_axis!r}")
        return t.detach().to(mesh.lead_device).clone().requires_grad_(True)

    return tree_map(put, stacked)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) → (M, B/M, ...) microbatch stack."""
    if x.shape[0] % n_micro:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


def make_pipeline_apply(stage_fn: Callable, mesh,
                        stage_axis: str = "stage"):
    """(stacked_params, xs) → ys. ``xs``: (M, b, ...) microbatches
    (:func:`microbatch`), whole on every shard; ``stacked_params``: the
    leading stage axis split over ``stage_axis``
    (:func:`shard_stage_params`). Returns (M, b, ...) outputs — the
    sequential application of the stages (:func:`sequential_apply`)."""
    n_stages = mesh.shape[stage_axis]

    def run(stacked_local, xs):
        local = tree_map(lambda a: a[0], stacked_local)
        s = smap.axis_index(stage_axis)
        m_total = xs.shape[0]
        zero = torch.zeros_like(xs[0])
        fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        buf = zero
        outs = [zero] * m_total
        for t in range(n_stages + m_total - 1):
            # stage 0 ingests microbatch t (past the fill window it
            # processes zeros that are never recorded)
            if s == 0:
                buf = xs[t] if t < m_total else zero
            y = stage_fn(local, buf)
            # the LAST stage emits microbatch m = t - (n_stages - 1)
            m = t - (n_stages - 1)
            if s == n_stages - 1 and 0 <= m < m_total:
                outs[m] = y
            # one hop forward per tick; stage 0's wrap-around input is
            # overwritten by the next ingest
            buf = smap.ppermute(y, stage_axis, fwd)
        # outputs live on the last stage only; psum replicates them
        # (every other stage contributes zeros)
        return smap.psum(torch.stack(outs), stage_axis)

    return shard_map(run, mesh, (P(stage_axis), P()), P())


def sequential_apply(stage_fn: Callable, per_stage_params: list,
                     x: torch.Tensor) -> torch.Tensor:
    """The single-device oracle the pipeline must match."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x


def make_pipeline_train_step(stage_fn: Callable, optimizer, mesh,
                             stage_axis: str = "stage"):
    """(stacked_params, xs, ys) → (stacked_params, loss): train THROUGH
    the pipeline (MSE). ``optimizer`` holds the stacked leaves
    (``tree_leaves(stacked)``) and steps them in place."""
    apply_fn = make_pipeline_apply(stage_fn, mesh, stage_axis)

    def step(stacked, xs, ys):
        preds = apply_fn(stacked, xs)
        loss = torch.mean((preds - ys.to(preds.device)) ** 2)
        grads = torch.autograd.grad(loss, optimizer.params)
        optimizer.step(grads)
        return stacked, loss.detach()

    return step
