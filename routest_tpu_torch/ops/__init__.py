"""Hand-written CUDA kernels for the port's hot ops.

Every kernel ports a Pallas kernel of ``routest_tpu/ops`` and keeps a
plain PyTorch version of the same function beside it: the wrapper runs
that version for CPU tensors and the kernel for CUDA tensors.
"""

from routest_tpu_torch.ops.fused_mlp import (  # noqa: F401
    fused_eta_forward,
    fused_eta_forward_plain,
    pack_eta_params,
    resolve_kernel_dtype,
)
