"""Training reports: where they go and the device they name.

Every trainer of the port writes its report as its own ``*_cuda.json``
file under ``artifacts/`` (never a JAX package's report), stamped with
the device that trained: the card's name and its power limit as
``nvidia-smi`` reads them, since a card set below its maximum power runs
slower under load.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def artifacts_path(name: str) -> str:
    return os.path.join(REPO, "artifacts", name)


def device_record(device: torch.device) -> Dict:
    """``{"device": "cuda"|"cpu", "name": ..., "power_limit": ...}``;
    name and limit are None where they cannot be read."""
    record: Dict[str, Optional[str]] = {"device": device.type, "name": None,
                                        "power_limit": None}
    if device.type != "cuda":
        return record
    record["name"] = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = smi.stdout.strip().splitlines()
        if smi.returncode == 0 and lines:
            record["power_limit"] = lines[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return record


def write_report(path: str, report: Dict) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


def is_jax_artifact(path: str) -> bool:
    """Whether ``path`` names an artifact the JAX package ships
    (``artifacts/road_gnn*.msgpack``,
    ``artifacts/route_transformer*.msgpack``, ``artifacts/eta_mlp*``)."""
    full = os.path.abspath(path)
    return (os.path.dirname(full) == os.path.join(REPO, "artifacts")
            and os.path.basename(full).startswith(
                ("road_gnn", "route_transformer", "eta_mlp")))


def refuse_jax_artifact(path: str) -> None:
    """The port's trainers never overwrite the artifacts the JAX package
    ships (``is_jax_artifact``)."""
    if is_jax_artifact(path):
        raise SystemExit(f"{path}: refusing to overwrite an artifact the "
                         f"JAX package ships; pass another --save path")
