"""Dtype policy: f32 parameters, bf16 compute, f32 outputs.

The counterpart of ``routest_tpu/core/dtypes.py``: bf16 operands with
f32 accumulation is the mixed-precision recipe of both the TPU's MXU and
Hopper's tensor cores. ETA targets are small magnitudes (minutes), so
f32 accumulation is plenty.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
# Full-f32 policy for CPU runs and parity tests.
F32_POLICY = Policy(compute_dtype=torch.float32)


def backend_compute_policy(policy: Policy, device) -> Policy:
    """Swap a bf16 compute dtype to f32 when serving on the CPU.

    bf16 compute on a CPU is emulated and only slower, so the JAX
    package serves bf16 artifacts in f32 on its CPU backend; the port
    does the same for an explicit CPU run. ``RTPU_CPU_COMPUTE=bf16``
    keeps the artifact's policy (to reproduce device numerics on a CPU
    host). On the card the artifact's policy stands."""
    if (torch.device(device).type == "cpu"
            and policy.compute_dtype == torch.bfloat16
            and os.environ.get("RTPU_CPU_COMPUTE", "").lower() != "bf16"):
        return dataclasses.replace(policy, compute_dtype=torch.float32)
    return policy
