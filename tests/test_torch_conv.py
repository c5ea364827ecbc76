"""The port's fused 3x3 conv + bias + ReLU (tpu_unet_torch/ops/conv_pallas.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card, by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.ops.conv_pallas import conv3x3_bias_relu as jax_conv
from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.conv_pallas import (conv3x3_bias_relu,
                                            conv3x3_bias_relu_plain)

# The shapes of tests/test_conv_pallas.py, plus Cin = 1 (the U-Net's first
# conv, K = 9) and a ragged width.
SHAPES = [
    ((1, 18, 20, 8), 16),     # ho=16 multiple of the JAX block_rows
    ((2, 13, 16, 4), 8),      # ragged rows
    ((1, 10, 34, 16), 32),
    ((2, 12, 15, 1), 8),      # Cin = 1
    ((1, 9, 23, 3), 5),       # odd channels
]


def _inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_conv_matches_jax_pallas_f32(shape, cout):
    x, w, b = _inputs(shape, cout, 0)
    expected = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), interpret=True))
    got = conv3x3_bias_relu(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == expected.shape
    # f32 sums in another order than XLA's: rtol 1e-4 / atol 1e-5.
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,cout", SHAPES[:3])
def test_conv_matches_jax_pallas_bf16(shape, cout):
    x, w, b = _inputs(shape, cout, 2)
    cast = lambda a: jnp.asarray(a, jnp.bfloat16)
    expected = np.asarray(jax_conv(cast(x), cast(w), cast(b), interpret=True),
                          np.float32)
    to_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = conv3x3_bias_relu(to_bf16(x), to_bf16(w), to_bf16(b))
    assert got.dtype == torch.bfloat16
    # bf16 outputs round at 8 bits and the two sides accumulate differently:
    # 2e-2, as tests/test_conv_pallas.py holds the Pallas kernel.
    np.testing.assert_allclose(got.float().numpy(), expected,
                               rtol=2e-2, atol=2e-2)


def test_plain_out_dtype_and_launch_count():
    x, w, b = (torch.from_numpy(a) for a in _inputs((1, 6, 7, 4), 8, 3))
    before = conv3x3_bias_relu.launches
    y = conv3x3_bias_relu(x, w, b, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 4, 5, 8)
    assert y.is_contiguous()
    # the CPU runs the plain version, which launches no kernel
    assert conv3x3_bias_relu.launches == before
    np.testing.assert_array_equal(
        y.float().numpy(),
        conv3x3_bias_relu_plain(x, w, b).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("xs,ws,bs", [
    ((6, 7, 4), (3, 3, 4, 8), (8,)),          # x not 4-D
    ((1, 6, 7, 4), (3, 3, 5, 8), (8,)),       # Cin mismatch
    ((1, 6, 7, 4), (2, 2, 4, 8), (8,)),       # not a 3x3 kernel
    ((1, 6, 7, 4), (3, 3, 4, 8), (7,)),       # bias size
    ((1, 2, 7, 4), (3, 3, 4, 8), (8,)),       # too small for a valid conv
])
def test_wrapper_rejects_bad_shapes(xs, ws, bs):
    with pytest.raises(ValueError):
        conv3x3_bias_relu(torch.zeros(xs), torch.zeros(ws), torch.zeros(bs))


def test_wrapper_rejects_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        conv3x3_bias_relu(torch.zeros((1, 5, 5, 2), device=meta),
                          torch.zeros((3, 3, 2, 4), device=meta),
                          torch.zeros((4,), device=meta))


def test_build_names_library_by_source_hash():
    srcs = _build.sources()
    assert [os.path.basename(s) for s in srcs] == ["conv3x3_bias_relu.cu"]
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert _build.BUILD_DIR.endswith(os.path.join("build", "tpu_unet_torch"))
    assert _build.source_hash() in os.path.basename(path)
    cmd = _build.nvcc_command("nvcc", "out.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert {"-std=c++17", "-O3", "-shared", "-fPIC"} <= set(cmd)
    assert cmd[-1] == srcs[0]



def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic" >&2; exit 2\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert os.listdir(tmp_path / "build") == []      # no partial library


def test_build_compiles_once_per_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    calls = tmp_path / "calls"
    # a stand-in compiler: records its call and writes the `-o` output
    nvcc = _fake_nvcc(tmp_path, f'echo x >> {calls}\n'
                      'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    path = _build.build()
    assert path == _build.library_path() and os.path.exists(path)
    assert _build.build() == path
    assert calls.read_text().count("x") == 1


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
