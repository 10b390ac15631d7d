"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/`` at the repository root,
under a name keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already there.
Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signature of the C entry ``rtpu_fused_eta_forward``: x, out,
# batch, weight / bias pointer arrays (f32), slab stream (bf16 / int8),
# dims, n_layers, n_q, variant, tile, stream. A pointer or stream passed without argtypes
# would be cut to 32 bits.
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
FUSED_ETA_ARGTYPES = (_PTR, _PTR, _I32, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                      _I32, _I32, _PTR)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on the PATH; raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
            "CUDA kernels build on the machine with the card")
    return found


def build(name: str = "fused_eta") -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists →
    (library path, compiler report: ``-Xptxas -v`` register, spill and
    shared-memory use). The report is kept beside the library
    (``….so.ptxas.txt``) and read back when the library was already
    built."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:16]}.so")
    report_path = f"{lib_path}.ptxas.txt"
    # the report lands before the library, so a library implies its report
    if os.path.exists(lib_path) and os.path.exists(report_path):
        with open(report_path) as f:
            return lib_path, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    with open(f"{report_path}.tmp{os.getpid()}", "w") as f:
        f.write(proc.stderr)
    # concurrent builders: last rename wins
    os.replace(f"{report_path}.tmp{os.getpid()}", report_path)
    os.replace(tmp, lib_path)
    return lib_path, proc.stderr


def load_library() -> ctypes.CDLL:
    """The fused-ETA kernel library, built on first call, with its
    ``argtypes`` declared (:data:`FUSED_ETA_ARGTYPES`)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build("fused_eta")[0])
            lib.rtpu_fused_eta_forward.argtypes = list(FUSED_ETA_ARGTYPES)
            lib.rtpu_fused_eta_forward.restype = _I32
            lib.rtpu_cuda_error_string.argtypes = [_I32]
            lib.rtpu_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
