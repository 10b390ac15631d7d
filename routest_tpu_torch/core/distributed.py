"""Multi-process runtime: ``torch.distributed`` init + a data axis that
spans processes.

The counterpart of ``routest_tpu/core/distributed.py``. There the same
program spans hosts once ``jax.distributed`` is initialized and the mesh
keeps its fast-changing axes inside a slice. Here each process drives
its local shards (``core/mesh.py``) and the ``data`` axis of
:func:`hybrid_mesh` factors as (processes × local shards): a ``psum``
over it reduces among the local shards, then across the processes
through ``torch.distributed`` (``core/smap.py``).

- :func:`initialize` — idempotent ``init_process_group``. Precedence:
  explicit kwargs → ``RTPU_COORDINATOR`` (``host:port``) /
  ``RTPU_NUM_PROCESSES`` / ``RTPU_PROCESS_ID`` → torch's own ``env://``
  (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, as
  ``torchrun`` sets them). The backend is ``nccl`` with a card and
  ``gloo`` on the CPU. NCCL refuses two ranks on one device, so one
  card runs this at world size 1; two-process runs are gloo on the CPU.
- :func:`hybrid_mesh` — the (data, model) mesh whose data axis is
  ``dcn_data × ici_data``. One process gets a plain local mesh with the
  same axis names.
- :func:`multihost_runtime` — both in one call: the program prologue
  that leaves the training and serving code unchanged.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from routest_tpu_torch.core.mesh import Mesh, MeshRuntime, default_devices

_initialized = False
_local_device_ids: Optional[tuple] = None


def is_initialized() -> bool:
    return _initialized


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group`` with env
    fallbacks (the module docstring); ``local_device_ids`` names the
    CUDA devices this process owns (default: every visible one)."""
    global _initialized, _local_device_ids
    if _initialized:
        return
    import torch.distributed as dist

    coordinator_address = coordinator_address \
        or os.environ.get("RTPU_COORDINATOR")
    num_processes = num_processes if num_processes is not None \
        else _env_int("RTPU_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else _env_int("RTPU_PROCESS_ID")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids is not None:
        _local_device_ids = tuple(int(i) for i in local_device_ids)
    if backend == "nccl":
        torch.cuda.set_device((_local_device_ids or (0,))[0])
    if coordinator_address and num_processes is not None \
            and process_id is not None:
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    _initialized = True


def shutdown() -> None:
    global _initialized, _local_device_ids
    if _initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
        _initialized = False
        _local_device_ids = None


def _process_layout() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _local_devices() -> list:
    if _local_device_ids is not None:
        return [torch.device("cuda", i) for i in _local_device_ids]
    return default_devices()


def hybrid_mesh(ici_data: int = -1, dcn_data: int = -1, model: int = 1,
                axis_names=("data", "model"),
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh for multi-process data parallelism: the ``data`` axis has
    size ``dcn_data × ici_data``, consecutive shards on one process.
    ``dcn_data`` defaults to the process count and ``ici_data`` to the
    local devices over ``model``; ``devices`` are this process's
    (default: its real devices)."""
    n_proc, rank = _process_layout()
    devices = list(devices if devices is not None else _local_devices())
    if dcn_data == -1:
        dcn_data = n_proc
    if ici_data == -1:
        ici_data = max(1, len(devices) // model)
    if dcn_data != n_proc:
        raise ValueError(f"the data axis's cross-process factor "
                         f"{dcn_data} must equal the process count "
                         f"{n_proc}")
    if ici_data * model > len(devices):
        raise ValueError(f"mesh {ici_data}x{model} needs "
                         f"{ici_data * model} devices, have {len(devices)}")
    grid = np.empty(ici_data * model, dtype=object)
    grid[:] = devices[: ici_data * model]
    return Mesh(grid.reshape(ici_data, model), axis_names,
                processes=n_proc, process_index=rank)


def multihost_runtime(model: int = 1,
                      devices: Optional[Sequence] = None) -> MeshRuntime:
    """One-call multi-process setup: initialize + hybrid mesh →
    MeshRuntime. The program prologue::

        from routest_tpu_torch.core import distributed
        runtime = distributed.multihost_runtime()
        # … the same training/serving code as on one process …
    """
    initialize()
    return MeshRuntime(mesh=hybrid_mesh(model=model, devices=devices))
