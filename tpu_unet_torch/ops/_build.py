"""Build the port's CUDA kernels from ``tpu_unet_torch/csrc`` and bind them.

The sources are compiled on first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library lands in ``build/tpu_unet_torch/`` at the
repository root, named by a hash of the sources and flags, so an edited
source builds a new library. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "tpu_unet_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[str]:
    """The CUDA sources, sorted: every ``*.cu`` and ``*.cuh`` in csrc/."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    """Hash of the flags and of every source's name and content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libtpu_unet_torch_{source_hash()}.so")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpu_unet_torch build from source on first use")


def nvcc_command(nvcc: str, output: str) -> List[str]:
    cu = [s for s in sources() if s.endswith(".cu")]
    return [nvcc, *NVCC_FLAGS, "-o", output, *cu]


def build() -> str:
    """Compile the library unless this source hash is built; returns its
    path. Raises RuntimeError with nvcc's stderr when compilation fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(nvcc, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {path}:\n"
            f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface (once per process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("conv3x3_bias_relu_bf16", "conv3x3_bias_relu_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.tpu_unet_torch_cuda_error_string.argtypes = [i]
        lib.tpu_unet_torch_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def cuda_error_string(code: int) -> str:
    return load_library().tpu_unet_torch_cuda_error_string(code).decode()
