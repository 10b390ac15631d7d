"""Device-mesh runtime: one place that owns the mesh and its layouts.

The counterpart of ``routest_tpu/core/mesh.py``. OD-pair batches shard
over the ``data`` axis and the ``model`` axis carries tensor-parallel
weights. The JAX mesh is single-controller, and so is this one: one
process drives every local shard, a :class:`Mesh` is a grid of
``torch.device``s, and ``core/smap.py`` runs one per-shard program on
each grid point in lock-step, its collectives exchanging tensors
between the shards (``.to`` of each shard's device, sums, concatenations)
so that autograd differentiates through them.

Devices repeat only where the caller passes them:
``MeshRuntime.create(cfg, devices=[torch.device("cpu")] * 8)`` is the
tests' stand-in for JAX's eight virtual CPU devices, and
``devices=[torch.device("cuda:0")] * 4`` hosts a four-shard mesh on one
card. The default device list counts the real devices
(:func:`default_devices`), and a mesh that needs more fails as JAX's
does. Across processes (``core/distributed.py``) the ``data`` axis
spans every process's local shards; its cross-process factor reduces
through ``torch.distributed``.

A global value — a batch, a parameter tree — is held as ordinary
tensors on the mesh's first device (:attr:`MeshRuntime.device`); a
per-shard program receives its slice on its own device.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from routest_tpu_torch.core.config import MeshConfig


def default_devices(device_type: Optional[str] = None) -> list:
    """The real devices of this process: every CUDA device when there is
    a card (or ``device_type="cuda"``), else the one CPU. Asking for
    ``cuda`` without a card raises: a mesh never quietly builds on the
    CPU."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cpu":
        return [torch.device("cpu")]
    if device_type != "cuda":
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("mesh: CUDA is not available and no CPU was "
                           "asked for")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of devices.

    ``devices``: a (nested) sequence or object array of devices, one
    per grid point of this process; ``axis_names``: one name per grid
    dimension. ``processes`` > 1 splits the FIRST axis over that many
    processes, this one holding block ``process_index``: ``shape``
    gives the global sizes, :attr:`devices` the local grid."""

    def __init__(self, devices, axis_names: Sequence[str],
                 processes: int = 1, process_index: int = 0) -> None:
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        grid = np.empty(len(flat), dtype=object)
        grid[:] = [torch.device(d) for d in flat]
        self.devices = grid.reshape(np.shape(np.asarray(devices,
                                                        dtype=object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh grid has {self.devices.ndim} axes, "
                             f"names {self.axis_names}")
        if processes < 1 or not 0 <= process_index < processes:
            raise ValueError(f"process {process_index} of {processes}")
        self.processes = int(processes)
        self.process_index = int(process_index)
        sizes = list(self.devices.shape)
        sizes[0] *= self.processes
        self.shape = OrderedDict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def lead_device(self) -> torch.device:
        """Where the mesh's global values live: its first device."""
        return self.devices.flat[0]

    def local_shards(self) -> list:
        """This process's grid points in row-major order:
        ``[(global coordinates by axis name, device), ...]``."""
        out = []
        offset = self.process_index * self.devices.shape[0]
        for idx in np.ndindex(*self.devices.shape):
            coords = dict(zip(self.axis_names, idx))
            coords[self.axis_names[0]] += offset
            out.append((coords, self.devices[idx]))
        return out

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"processes={self.processes})")


def create_mesh(cfg: Optional[MeshConfig] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: the real ones);
    ``cfg.data = -1`` takes every device the model axis leaves."""
    cfg = cfg or MeshConfig()
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else max(1, n // model)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n}")
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[: data * model]
    return Mesh(grid.reshape(data, model), cfg.axis_names)


@dataclasses.dataclass(frozen=True)
class MeshRuntime:
    """Mesh + the layouts every layer above needs."""

    mesh: Mesh

    @classmethod
    def create(cls, cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> "MeshRuntime":
        return cls(mesh=create_mesh(cfg, devices))

    @property
    def data_axis(self) -> str:
        return self.mesh.axis_names[0]

    @property
    def model_axis(self) -> str:
        return self.mesh.axis_names[1]

    @property
    def n_data(self) -> int:
        return self.mesh.shape[self.data_axis]

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where global values are held."""
        return self.mesh.lead_device

    @property
    def is_primary(self) -> bool:
        """Whether this process writes what every process shares (a
        checkpoint): process 0."""
        return self.mesh.process_index == 0

    def batch_sharding(self):
        """Rows sharded over the data axis; feature dim replicated."""
        from routest_tpu_torch.core.smap import P

        return P(self.data_axis)

    def replicated(self):
        from routest_tpu_torch.core.smap import P

        return P()

    def shard_batch(self, tree):
        """A pytree of host arrays or tensors as global tensors on the
        mesh's first device, rows to be split over the data axis: their
        count must divide by ``n_data``, as JAX's ``device_put`` with
        the batch sharding requires."""
        from routest_tpu_torch.core.smap import tree_map

        def put(x):
            t = _as_tensor(x, self.device)
            if t.ndim == 0 or t.shape[0] % self.n_data:
                raise ValueError(
                    f"batch of {tuple(t.shape)} rows is not divisible by "
                    f"the data axis ({self.n_data} shards)")
            return t

        return tree_map(put, tree)

    def replicate(self, tree):
        """A pytree as tensors on the mesh's first device, whole on
        every shard."""
        from routest_tpu_torch.core.smap import tree_map

        return tree_map(lambda x: _as_tensor(x, self.device), tree)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (and m >= multiple)."""
    if multiple <= 0:
        return n
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def pad_rows(array: np.ndarray, target_rows: int) -> np.ndarray:
    """Zero-pad axis 0 up to target_rows (bucketed shapes)."""
    n = array.shape[0]
    if n == target_rows:
        return array
    if n > target_rows:
        raise ValueError(f"cannot pad {n} rows down to {target_rows}")
    pad_widths = [(0, target_rows - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_widths)
