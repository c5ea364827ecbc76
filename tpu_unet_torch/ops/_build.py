"""Build the port's CUDA kernels from ``tpu_unet_torch/csrc`` and bind them.

The sources are compiled on first use with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds): one ``nvcc -c`` per ``.cu`` file, all started
together, then one link. The library lands in ``build/tpu_unet_torch/`` at
the repository root, named by a hash of the sources and flags, so an edited
source builds a new library. Nothing here runs when the module is imported.

`launch` is the one launch path of every kernel wrapper: it calls a C entry
on the current stream of a tensor's device and raises on a refused launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "tpu_unet_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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


def compile_commands(nvcc: str, out_dir: str) -> List[List[str]]:
    """One ``nvcc -c`` per ``.cu`` source, each writing ``<name>.o`` into
    `out_dir`."""
    return [[nvcc, *NVCC_FLAGS, "-c", "-o",
             os.path.join(out_dir, os.path.basename(cu)[:-3] + ".o"), cu]
            for cu in sources() if cu.endswith(".cu")]


def link_command(nvcc: str, objects: List[str], output: str) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-shared", "-o", output, *objects]


def build() -> str:
    """Compile the library unless this source hash is built; returns its
    path. Raises RuntimeError with nvcc's stderr when a step fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    obj_dir = f"{path}.{os.getpid()}.objs"
    os.makedirs(obj_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        cmds = compile_commands(nvcc, obj_dir)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        errors = []
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{cmd[-1]} (exit {proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError(f"nvcc failed building {path}:\n" + "\n".join(errors))
        proc = subprocess.run(link_command(nvcc, [c[-2] for c in cmds], tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {path} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface (once per process;
    after that, the loaded library without taking the lock)."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_bias_relu_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.conv3x3_bias_relu_f32.restype = i
        lib.conv3x3_bias_relu_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.conv3x3_bias_relu_bf16.restype = i
        lib.conv3x3_bias_relu_sm90.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        lib.conv3x3_bias_relu_sm90.restype = i
        for name in ("conv3x3_fused_s8", "conv3x3_fused_bf16", "conv_kxk_fused_s8"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
            fn.restype = i
        for name in ("conv3x3_fused_sm90", "conv_kxk_fused_sm90"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
            fn.restype = i
        ll, f = ctypes.c_longlong, ctypes.c_float
        lib.edt_column_pass_f32.argtypes = [p, p, p, ll, i, i, i, i, p]
        lib.edt_column_pass_f32.restype = i
        lib.edt_column_pass_sm90.argtypes = [p, p, p, ll, i, i, i, i, p]
        lib.edt_column_pass_sm90.restype = i
        lib.enc0_chain.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
        lib.enc0_chain.restype = i
        lib.enc0_chain_sm90.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, ll, i, i, i, p]
        lib.enc0_chain_sm90.restype = i
        lib.concat_quantize.argtypes = [p, p, p, ll, ll, ll, ll, i, i, i, i, i, i, f, i, p]
        lib.concat_quantize.restype = i
        lib.interleave_copy.argtypes = [i, p, p, p, ll, ll, ll, ll, i, i, i, i, i, p]
        lib.interleave_copy.restype = i
        lib.row_gather_f32.argtypes = [p, p, i, p, ll, ll, i, ll, i, p]
        lib.row_gather_f32.restype = i
        lib.enc0_conv1_stage.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.enc0_conv1_stage.restype = i
        lib.enc0_conv2_stage.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.enc0_conv2_stage.restype = i
        lib.enc0_pool_quant_stage.argtypes = [p, p, p, i, i, i, i, i, i, f, i, p]
        lib.enc0_pool_quant_stage.restype = i
        lib.tpu_unet_torch_cuda_error_string.argtypes = [i]
        lib.tpu_unet_torch_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def cuda_error_string(code: int) -> str:
    return load_library().tpu_unet_torch_cuda_error_string(code).decode()


#: The handle of a device's current stream, from its index, without building
#: a `torch.cuda.Stream` object; and the current device's index. Bound to
#: torch's own functions (None in a build of torch without CUDA).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice", None)


def _describe(shapes: Sequence[Tuple[str, Any]]) -> str:
    return ", ".join(f"{label} {tuple(v.shape) if isinstance(v, torch.Tensor) else v}"
                     for label, v in shapes)


def launch(name: str, fn, device: int, *args, shapes: Sequence[Tuple[str, Any]] = ()) -> None:
    """Call the C entry `fn(*args, stream)` on the current stream of CUDA
    device `device` (an index, as `tensor.get_device()` gives it), making
    it the current device only when another one is.

    `fn` returns the launch's CUDA error code; when it is not 0, raises
    RuntimeError naming the kernel `name`, the CUDA error and `shapes`
    (pairs of a label and a tensor, whose shape is printed, or a value),
    which are formatted only then."""
    if device == _current_device():
        rc = fn(*args, _raw_stream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, _raw_stream(device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({cuda_error_string(rc)}) at {_describe(shapes)}")
