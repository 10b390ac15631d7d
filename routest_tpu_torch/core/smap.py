"""Per-shard programs over a mesh, and the collectives they call.

The port's counterpart of the ``shard_map`` shim
(``routest_tpu/core/smap.py``). :func:`shard_map` splits each global
input by its :class:`P` spec, runs ``f`` once per shard of the mesh —
each shard on its own thread, on its own device, in lock-step — and
assembles the outputs by ``out_specs``. Inside ``f`` the collectives
carry ``lax``'s names: :func:`psum`, :func:`pmean`, :func:`all_gather`,
:func:`ppermute`, :func:`all_to_all` and :func:`axis_index`.

A collective is a rendezvous: every shard of the mesh posts its tensor,
waits on one barrier, and builds its result from its peers' tensors
with ordinary differentiable ops (``.to`` its device, sum, cat,
narrow). The autograd graph therefore spans the shards, and the
gradient of anything computed from the outputs is the true gradient
of the function ``shard_map`` computes: replicated inputs accumulate
their shards' cotangents, a replicated output read from the first
shard carries cotangents back through every peer it summed. Every
shard calls the same collectives in the same order (the SPMD contract
``shard_map`` programs keep), and each sums its peers in axis order,
so replicated results are identical on every shard.

Across processes (a mesh from ``core/distributed.py``) the first axis
also spans processes: ``psum`` and ``all_gather`` over it finish with
``torch.distributed`` (a sum's backward is the identity, for a
cotangent every process holds alike; callers sum parameter gradients
across processes with :func:`sum_across_processes`). ``ppermute`` and
``all_to_all`` over a cross-process axis are not supported.
"""

from __future__ import annotations

import copy
import functools
import threading
from typing import Callable, Sequence

import numpy as np
import torch

_BARRIER_TIMEOUT_S = 600.0


class P(tuple):
    """A partition spec: per array dimension, ``None`` (whole), a mesh
    axis name, or a tuple of axis names (split over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# ── pytrees (dicts, lists, tuples, named tuples; P is a leaf) ────────


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); dict keys in sorted order, as JAX flattens them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if _is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _map_specs(spec, tree, fn: Callable):
    """``fn(leaf_spec, leaf)`` where ``spec`` is a prefix of ``tree``:
    a :class:`P` applies to the whole subtree under it."""
    if isinstance(spec, P):
        return tree_map(lambda leaf: fn(spec, leaf), tree)
    if isinstance(spec, dict):
        return {k: _map_specs(spec[k], tree[k], fn) for k in sorted(tree)}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"spec {spec!r} does not fit a tree of "
                             f"{len(tree)} entries")
        items = [_map_specs(s, t, fn) for s, t in zip(spec, tree)]
        if _is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    if spec is None and tree is None:
        return None
    raise ValueError(f"unsupported spec entry {spec!r}")


# ── the per-shard context ────────────────────────────────────────────


class _Group:
    """One ``shard_map`` call's rendezvous among its local shards."""

    def __init__(self, mesh, shards) -> None:
        self.mesh = mesh
        self.shards = shards               # [(coords, device)]
        self.barrier = threading.Barrier(len(shards),
                                         timeout=_BARRIER_TIMEOUT_S)
        self.slots: dict = {}


class _Ctx:
    def __init__(self, group: _Group, index: int) -> None:
        self.group = group
        self.index = index
        self.coords, self.device = group.shards[index]
        self.seq = 0


_local = threading.local()


def _ctx() -> _Ctx:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("a collective was called outside a shard_map "
                           "program")
    return ctx


def _axes(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def _check_axes(mesh, axes) -> None:
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"unknown mesh axis {a!r} (mesh axes "
                             f"{tuple(mesh.shape)})")


def _crosses_processes(mesh, axes) -> bool:
    return mesh.processes > 1 and mesh.axis_names[0] in axes


def _exchange(x) -> list:
    """Every local shard's ``x``, in shard order (one barrier)."""
    ctx = _ctx()
    group = ctx.group
    if len(group.shards) == 1:
        return [x]
    key = ctx.seq
    ctx.seq += 1
    group.slots[(key, ctx.index)] = x
    group.barrier.wait()
    return [group.slots[(key, j)] for j in range(len(group.shards))]


def _peers(axes) -> list:
    """Indices of the local shards that share every coordinate but
    ``axes`` with this one, ordered by their combined index over
    ``axes`` (row-major)."""
    ctx = _ctx()
    mesh = ctx.group.mesh
    out = []
    for j, (coords, _) in enumerate(ctx.group.shards):
        if all(coords[a] == ctx.coords[a] for a in mesh.axis_names
               if a not in axes):
            out.append((_combined(mesh, coords, axes), j))
    return [j for _, j in sorted(out)]


def _combined(mesh, coords, axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def axis_index(axis_name) -> int:
    """This shard's coordinate along ``axis_name`` (a tuple: the
    row-major index over those axes)."""
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    return _combined(ctx.group.mesh, ctx.coords, axes)


def axis_size(axis_name) -> int:
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    return int(np.prod([ctx.group.mesh.shape[a] for a in axes]))


# ── collectives ──────────────────────────────────────────────────────


class _ProcessSum(torch.autograd.Function):
    """All-reduce (sum) over the processes; the backward passes the
    cotangent through, since every process holds the same one."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _ProcessGather(torch.autograd.Function):
    """All-gather over the processes, concatenated along ``dim`` in
    process order; the backward keeps this process's block."""

    @staticmethod
    def forward(ctx, x, dim):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.detach().contiguous())
        ctx.dim, ctx.rank, ctx.width = dim, dist.get_rank(), x.shape[dim]
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Sum of ``x`` over the shards along ``axis_name``, on every one."""
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    vals = _exchange(x)
    out = functools.reduce(
        torch.add, [vals[j].to(ctx.device) for j in _peers(axes)])
    if _crosses_processes(ctx.group.mesh, axes):
        out = _ProcessSum.apply(out)
    return out


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    return psum(x, axis_name) / axis_size(axis_name)


def all_gather(x: torch.Tensor, axis_name, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """The shards' ``x`` along ``axis_name``, stacked at ``axis`` (or
    concatenated there with ``tiled``), in axis order."""
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    vals = _exchange(x)
    parts = [vals[j].to(ctx.device) for j in _peers(axes)]
    out = torch.cat(parts, dim=axis) if tiled \
        else torch.stack(parts, dim=axis)
    if _crosses_processes(ctx.group.mesh, axes):
        out = _ProcessGather.apply(out, axis)
    return out


def _local_only(what: str, axes) -> None:
    if _crosses_processes(_ctx().group.mesh, axes):
        raise NotImplementedError(f"{what} over an axis that spans "
                                  f"processes")


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """``x`` from the shard that ``perm`` (pairs ``(source, dest)`` of
    axis coordinates) sends to this one; zeros where none does."""
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    _local_only("ppermute", axes)
    vals = _exchange(x)
    peers = _peers(axes)
    me = axis_index(axes)
    sources = [s for s, d in perm if d == me]
    if not sources:
        return torch.zeros_like(x)
    return vals[peers[sources[0]]].to(ctx.device)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """Each shard splits ``x`` into ``n`` chunks along ``split_axis``,
    sends chunk ``i`` to the shard at coordinate ``i``, and concatenates
    what it receives along ``concat_axis`` in axis order (``lax``'s
    tiled form)."""
    if not tiled:
        raise NotImplementedError("all_to_all supports tiled=True")
    ctx = _ctx()
    axes = _axes(axis_name)
    _check_axes(ctx.group.mesh, axes)
    _local_only("all_to_all", axes)
    n = axis_size(axes)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} not divisible by {n}")
    vals = _exchange(x)
    me = axis_index(axes)
    width = x.shape[split_axis] // n
    parts = [vals[j].narrow(split_axis, me * width, width).to(ctx.device)
             for j in _peers(axes)]
    return torch.cat(parts, dim=concat_axis)


def sum_across_processes(mesh, tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor summed over the processes of ``mesh`` (a replicated
    parameter's gradient: every process holds its data's part); the
    tensors themselves on a single-process mesh."""
    if mesh.processes == 1:
        return list(tensors)
    import torch.distributed as dist

    out = []
    for t in tensors:
        t = t.detach().clone()
        dist.all_reduce(t)
        out.append(t)
    return out


def barrier(mesh) -> None:
    """Wait for every process of ``mesh`` (nothing on one process)."""
    if mesh.processes > 1:
        import torch.distributed as dist

        dist.barrier()


# ── splitting and assembling ─────────────────────────────────────────


def _split(mesh, coords, device, spec: P, x):
    if not isinstance(x, torch.Tensor):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        else:
            return x
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more entries than the "
                         f"{x.ndim} dims of its input")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        _check_axes(mesh, axes)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if x.shape[dim] % n:
            raise ValueError(
                f"shard_map: dim {dim} of size {x.shape[dim]} is not "
                f"divisible by {n} ({entry!r})")
        width = x.shape[dim] // n
        x = x.narrow(dim, _combined(mesh, coords, axes) * width, width)
    return x.to(device)


def _assemble(mesh, target, spec: P, pieces: list):
    """One output leaf from every local shard's piece
    (``[(coords, value)]``) by ``spec``."""
    first = pieces[0][1]
    if not isinstance(first, torch.Tensor):
        return first
    dims = [(d, _axes(e)) for d, e in enumerate(spec) if e is not None]
    mentioned = {a for _, axes in dims for a in axes}
    chosen: dict = {}
    for coords, value in pieces:
        key = tuple(coords[a] for a in mesh.axis_names if a in mentioned)
        chosen.setdefault(key, value)   # first local shard: lowest coords

    def build(i: int, fixed: dict) -> torch.Tensor:
        if i == len(dims):
            key = tuple(fixed[a] for a in mesh.axis_names
                        if a in mentioned)
            return chosen[key].to(target)
        dim, axes = dims[i]
        local = axes[0] == mesh.axis_names[0] and mesh.processes > 1
        parts = []
        for combo in np.ndindex(*[mesh.shape[a] for a in axes]):
            coords = dict(zip(axes, combo))
            if local and (coords[axes[0]] // mesh.devices.shape[0]
                          != mesh.process_index):
                continue
            parts.append(build(i + 1, {**fixed, **coords}))
        out = torch.cat(parts, dim=dim)
        if local:
            out = _ProcessGather.apply(out, dim)
        return out

    return build(0, {})


def shard_map(f: Callable, mesh, in_specs, out_specs,
              check: bool = False) -> Callable:
    """``f`` as a per-shard program over ``mesh``: the returned function
    takes global inputs (tensors or numpy arrays, split per
    ``in_specs``, one spec prefix per argument) and returns global
    outputs on the mesh's first device, assembled per ``out_specs``
    (an axis a spec leaves out is replicated: its first shard's value
    is read)."""
    del check
    if isinstance(in_specs, P):
        in_specs = (in_specs,)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map program takes {len(in_specs)} "
                            f"arguments, got {len(args)}")
        shards = mesh.local_shards()
        per_shard = [
            tuple(_map_specs(spec, arg, functools.partial(
                _split, mesh, coords, device))
                for spec, arg in zip(in_specs, args))
            for coords, device in shards]
        outs = _run_spmd(f, mesh, shards, per_shard)
        structure = outs[0]
        flat = [tree_leaves(o) for o in outs]
        leaves = iter(range(len(flat[0])))

        def one(spec, _leaf):
            i = next(leaves)
            return _assemble(mesh, mesh.lead_device, spec,
                             [(coords, flat[s][i])
                              for s, (coords, _) in enumerate(shards)])

        return _map_specs(out_specs, structure, one)

    return run


def _run_spmd(f: Callable, mesh, shards, per_shard_args) -> list:
    group = _Group(mesh, shards)
    grad = torch.is_grad_enabled()
    # a "cuda" without an index means the caller's current card
    caller_card = (torch.cuda.current_device()
                   if any(d.type == "cuda" and d.index is None
                          for _, d in shards) else None)
    results: list = [None] * len(shards)
    errors: list = [None] * len(shards)

    def body(i: int) -> None:
        prev = getattr(_local, "ctx", None)
        _local.ctx = _Ctx(group, i)
        try:
            device = shards[i][1]
            if device.type == "cuda" and len(shards) > 1:
                # a fresh thread has no current CUDA context of its own
                torch.cuda.set_device(device.index if device.index
                                      is not None else caller_card)
            with torch.set_grad_enabled(grad):
                results[i] = f(*per_shard_args[i])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e
            group.barrier.abort()
        finally:
            _local.ctx = prev

    if len(shards) == 1:
        body(0)
    else:
        threads = [threading.Thread(target=body, args=(i,),
                                    name=f"shard-{i}", daemon=True)
                   for i in range(len(shards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    # a shard's own error first: its peers only saw the broken barrier
    failed = sorted((e for e in errors if e is not None),
                    key=lambda e: isinstance(e, threading.BrokenBarrierError))
    if failed:
        raise failed[0]
    return results


# ── modules on a shard's device ──────────────────────────────────────


def replica_on(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` for a per-shard program on ``device``: the module
    itself when its parameters live there, else a shallow copy whose
    parameters and buffers are ``.to(device)`` of the module's, so
    gradients reach the module's own parameters. Call it inside the
    shard's program: each shard then holds its own copy."""
    first = next(iter(module.parameters()), None)
    if first is None or first.device == torch.device(device):
        return module
    return _copy_to(module, torch.device(device))


def _copy_to(module: torch.nn.Module, device) -> torch.nn.Module:
    replica = copy.copy(module)
    replica._parameters = {}
    replica._buffers = {name: None if b is None else b.to(device)
                        for name, b in module._buffers.items()}
    replica._modules = {name: None if child is None
                        else _copy_to(child, device)
                        for name, child in module._modules.items()}
    for name, p in module._parameters.items():
        object.__setattr__(replica, name,
                           None if p is None else p.to(device))
    return replica
