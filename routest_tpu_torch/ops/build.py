"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``build/kernels/`` at the repository root
(``RTPU_KERNEL_CACHE`` names another directory: an operator's explicit
choice), under a name keyed by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads the library already
there. The key names the source, not the file, so the directory and the
library are checked before ``nvcc`` runs and before ``ctypes`` loads
anything (the policy of ``utils/paths.untrusted_reason``): a
directory that is a symlink, is not ours, or is group- or
world-writable, and a library that is not ours or is group- or
world-writable, raise :class:`UntrustedBuildPath` naming the path. There
is no fallback to the plain version: the kernel's caller sees the error.
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

from routest_tpu_torch.utils.paths import untrusted_reason

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


class UntrustedBuildPath(RuntimeError):
    """A kernel directory or library another local user could have
    planted: refused, never built into or loaded."""


def build_dir() -> str:
    """``RTPU_KERNEL_CACHE``, else :data:`BUILD_DIR`."""
    return os.environ.get("RTPU_KERNEL_CACHE") or BUILD_DIR


def _refuse_untrusted(path: str, want_dir: bool) -> None:
    """Raise :class:`UntrustedBuildPath` unless ``path`` is a real
    directory (``want_dir``) or regular file, owned by this user and
    writable by nobody else (``utils/paths.untrusted_reason``)."""
    why = untrusted_reason(path, want_dir)
    if why is not None:
        kind = "directory" if want_dir else "regular file"
        raise UntrustedBuildPath(f"refusing kernel {kind} {path}: it {why}")


def _trusted_dir() -> str:
    """The build directory, created ``0700`` when missing, checked."""
    path = build_dir()
    os.makedirs(path, mode=0o700, exist_ok=True)
    _refuse_untrusted(path, want_dir=True)
    return path


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
    directory = _trusted_dir()
    lib_path = os.path.join(directory,
                            f"lib{name}-{key.hexdigest()[:16]}.so")
    report_path = f"{lib_path}.ptxas.txt"
    # the report lands before the library, so a library implies its report
    if os.path.lexists(lib_path) and os.path.exists(report_path):
        _refuse_untrusted(lib_path, want_dir=False)
        with open(report_path) as f:
            return lib_path, f.read()
    tmp = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.chmod(tmp, 0o700)   # whatever the umask gave nvcc's output
    with open(f"{report_path}.tmp{os.getpid()}", "w") as f:
        f.write(proc.stderr)
    # concurrent builders: last rename wins
    os.replace(f"{report_path}.tmp{os.getpid()}", report_path)
    os.replace(tmp, lib_path)
    return lib_path, proc.stderr


def load_library() -> ctypes.CDLL:
    """The fused-ETA kernel library, built on first call, with its
    ``argtypes`` declared (:data:`FUSED_ETA_ARGTYPES`). The library is
    checked again just before it is loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build("fused_eta")[0]
            _refuse_untrusted(path, want_dir=False)
            lib = ctypes.CDLL(path)
            lib.rtpu_fused_eta_forward.argtypes = list(FUSED_ETA_ARGTYPES)
            lib.rtpu_fused_eta_forward.restype = _I32
            lib.rtpu_cuda_error_string.argtypes = [_I32]
            lib.rtpu_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
