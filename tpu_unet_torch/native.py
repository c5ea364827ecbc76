"""ctypes binding of the native host kernel the port uses: ground-truth
preprocessing (``preprocess_gt`` of ``native/tpu_unet_native.cc``).

The C++ source is built with the system ``g++`` on first use into
``build/tpu_unet_torch/`` at the repository root, named by a hash of the
source and flags, and loaded with ctypes. Where there is no compiler, or the
build fails, `load` returns None and the caller takes its numpy version,
which gives the same result: this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO_DIR, "native", "tpu_unet_native.cc")
BUILD_DIR = os.path.join(REPO_DIR, "build", "tpu_unet_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpu_unet_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Build if needed and load the library (once per process); None when
    it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.preprocess_gt.argtypes = [i32, ctypes.c_int, ctypes.c_int, f32, f32]
        lib.preprocess_gt.restype = None
        _lib = lib
        return _lib


def preprocess_gt(instances: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """[H, W] instance ids -> (gt f32, edge f32) through the native kernel,
    or None when the library is not available."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(instances, np.int32)
    h, w = x.shape
    gt = np.empty((h, w), np.float32)
    edge = np.empty((h, w), np.float32)
    lib.preprocess_gt(x, h, w, gt, edge)
    return gt, edge
