"""The port's fused 3x3 conv + bias + ReLU (tpu_unet_torch/ops/conv_pallas.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card, by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.ops.conv_pallas import conv3x3_bias_relu as jax_conv
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.conv_pallas import (SM90_FLAT_BLOCKS, _check_kernel_args,
                                            conv3x3_bias_relu, conv3x3_bias_relu_plain,
                                            conv3x3_route, sm90_plan)

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


BF, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("dtypes,ok", [
    ((BF, BF, BF), True), ((F32, F32, F32), True),
    ((BF, BF, F32), True),                # the int8 tier's float layers
    ((F32, F32, BF), False), ((BF, F32, F32), False), ((F32, BF, F32), False),
    ((BF, BF, torch.float16), False), ((BF, BF, I8), False), ((I8, I8, I8), False),
    ((I8, I8, F32), False),
])
def test_kernel_takes_an_f32_bias_beside_bf16_only(dtypes, ok):
    """The kernel's argument check: x and w of one dtype, float32 or
    bfloat16, and b in x's dtype or, beside bfloat16, float32."""
    xd, wd, bd = dtypes
    args = (torch.zeros((1, 5, 5, 8), dtype=xd), torch.zeros((3, 3, 8, 8), dtype=wd),
            torch.zeros((8,), dtype=bd))
    if ok:
        _check_kernel_args(*args, None)
        with pytest.raises(TypeError, match="writes x's dtype"):
            _check_kernel_args(*args, torch.float16)
    else:
        with pytest.raises(TypeError):
            _check_kernel_args(*args, None)


def test_f32_bias_is_added_before_the_one_rounding():
    """relu(acc + b) rounds to bf16 once: with acc = 2^-8 and b = 1 + 2^-10,
    an f32 b gives 1 + 2^-7, a bf16-rounded b (1.0) the tie 1 + 2^-8, which
    rounds to 1.0."""
    x = torch.zeros((1, 4, 5, 8), dtype=BF)
    x[..., 0] = 1.0
    w = torch.zeros((3, 3, 8, 16), dtype=BF)
    w[1, 1, 0] = 2.0 ** -8
    b = torch.full((16,), 1 + 2.0 ** -10)
    y = conv3x3_bias_relu(x, w, b)
    assert y.dtype == BF and bool((y == 1 + 2.0 ** -7).all())
    assert bool((conv3x3_bias_relu(x, w, b.to(BF)) == 1.0).all())


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
    assert [os.path.basename(s) for s in srcs] == ["concat_quantize.cu",
                                                   "conv3x3_bias_relu.cu",
                                                   "conv3x3_fused.cu",
                                                   "conv3x3_sm90.cuh",
                                                   "conv_fused.cuh",
                                                   "conv_kxk_fused.cu",
                                                   "edt_column_pass.cu",
                                                   "enc0_chain.cu",
                                                   "enc0_conv1.cuh",
                                                   "enc0_stages.cu",
                                                   "interleave.cu",
                                                   "row_gather.cu"]
    path = _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert _build.BUILD_DIR.endswith(os.path.join("build", "tpu_unet_torch"))
    assert _build.source_hash() in os.path.basename(path)
    # one nvcc -c per .cu source (started together), then one link; the
    # header is hashed, not compiled alone
    cmds = _build.compile_commands("nvcc", "objs")
    assert [c[-1] for c in cmds] == [s for s in srcs if s.endswith(".cu")]
    for cmd in cmds:
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
        assert {"-std=c++17", "-O3", "-fPIC", "-c"} <= set(cmd)
        assert cmd[-3:-1] == ["-o", os.path.join("objs", os.path.basename(cmd[-1])[:-3] + ".o")]
    link = _build.link_command("nvcc", ["a.o", "b.o"], "out.so")
    assert {"-shared", "-fPIC"} <= set(link) and link[-3:] == ["out.so", "a.o", "b.o"]



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
    n_calls = sum(s.endswith(".cu") for s in _build.sources()) + 1   # a compile per .cu, one link
    assert calls.read_text().count("x") == n_calls
    assert _build.build() == path
    assert calls.read_text().count("x") == n_calls
    assert os.listdir(tmp_path / "build") == [os.path.basename(path)]


def test_find_nvcc_raises_without_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _full_width_convs():
    """(name, Cin, Cout) of the 18 3x3 convs of the full-width U-Net."""
    w, cin, out = ModelConfig(base_width=64).widths, 1, []
    for d in range(4):
        out += [(f"enc{d}_conv1", cin, w[d]), (f"enc{d}_conv2", w[d], w[d])]
        cin = w[d]
    out += [("bottleneck_conv1", cin, w[-1]), ("bottleneck_conv2", w[-1], w[-1])]
    for d in reversed(range(4)):
        out += [(f"dec{d}_conv1", 2 * w[d], w[d]), (f"dec{d}_conv2", w[d], w[d])]
    return out


@pytest.mark.parametrize("name,cin,cout", _full_width_convs())
def test_route_of_each_full_width_conv(name, cin, cout):
    """bf16: 17 of the 18 convs take the sm90 loop, enc0_conv1 (Cin 1) the
    simple kernel; f32 always the simple one."""
    x = torch.zeros((1, 3, 3, cin), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
    assert conv3x3_route(x, w) == ("simple" if name == "enc0_conv1" else "sm90")
    assert conv3x3_route(x.float(), w.float()) == "simple"


@pytest.mark.parametrize("cin,cout,misalign,route", [
    (64, 64, False, "sm90"),
    (24, 72, False, "sm90"),
    (3, 64, False, "simple"),       # Cin % 8
    (12, 64, False, "simple"),
    (64, 20, False, "simple"),      # Cout % 8
    (64, 64, True, "simple"),       # x 2 bytes off 16-byte alignment
])
def test_route_by_channels_and_alignment(cin, cout, misalign, route):
    n = 2 * 5 * 7 * cin
    x = torch.zeros(n + 8, dtype=torch.bfloat16)[int(misalign):n + int(misalign)]
    x = x.view(2, 5, 7, cin)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == misalign
    w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
    assert conv3x3_route(x, w) == route
    # a misaligned w routes as an aligned one: the sm90 route copies it
    wm = torch.zeros(w.numel() + 8, dtype=w.dtype)[1:w.numel() + 1].view(w.shape)
    assert wm.data_ptr() % 16 != 0 and conv3x3_route(x, wm) == route


_CSRC = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")


def _header_constant(name: str) -> int:
    """An int constant of csrc/conv3x3_sm90.cuh, the loops' one statement of it."""
    with open(os.path.join(_CSRC, "conv3x3_sm90.cuh")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("seed", range(8))
def test_sm90_plan_covers_the_gemm_once(seed):
    """Over seeded random shapes: the strip loop exactly where Cin and Cout
    are <= 64; else a built flat block whose grid, decoded as the kernel
    decodes blockIdx (M tile = index / N tiles), covers M x N exactly once,
    and whose tap-major K steps of 64 channels cover 9 x Cin."""
    rng = np.random.RandomState(seed)
    for _ in range(25):
        b, h, w = rng.randint(1, 17), rng.randint(3, 600), rng.randint(3, 600)
        cin, cout = 8 * rng.randint(1, 129), 8 * rng.randint(1, 129)
        plan = sm90_plan(cin, cout)
        assert (plan.kind == "strip") == (cin <= 64 and cout <= 64)
        if plan.kind == "strip":
            continue
        bm, bn = plan.bm, plan.bn
        assert (bm, bn) in SM90_FLAT_BLOCKS and (bn == 64) == (cout <= 64)
        m = b * (h - 2) * (w - 2)
        m_tiles, n_tiles = -(-m // bm), -(-cout // bn)
        idx = np.arange(m_tiles * n_tiles)
        m0, n0 = (idx // n_tiles) * bm, (idx % n_tiles) * bn
        # every (M tile, N tile) once, the last of each partly past the edge
        assert len(set(zip(m0.tolist(), n0.tolist()))) == len(idx)
        assert m0.max() < m <= m0.max() + bm and n0.max() < cout <= n0.max() + bn
        k_steps = 9 * -(-cin // 64)
        assert k_steps * 64 >= 9 * cin > (k_steps - 9) * 64


@pytest.mark.parametrize("seed", range(4))
def test_strip_plan_covers_every_output_pixel_once(seed):
    """The strip loop's 2-row x STRIP_TW-column tiles (the header's
    constant), enumerated as the kernel decodes them, cover every output
    pixel of the batch exactly once."""
    rng = np.random.RandomState(100 + seed)
    tw = _header_constant("STRIP_TW")
    for _ in range(6):
        b, h, w = rng.randint(1, 4), rng.randint(3, 140), rng.randint(3, 200)
        cin, cout = 8 * rng.randint(1, 9), 8 * rng.randint(1, 9)
        assert sm90_plan(cin, cout).kind == "strip"
        ho, wo = h - 2, w - 2
        tiles_c = -(-wo // tw)
        tiles_img = -(-ho // 2) * tiles_c
        seen = np.zeros((b, ho, wo), np.int64)
        for t in range(b * tiles_img):
            bi, rem = divmod(t, tiles_img)
            oy, ox = 2 * (rem // tiles_c), tw * (rem % tiles_c)
            seen[bi, oy:oy + 2, ox:ox + tw] += 1
        assert (seen == 1).all()


def test_sm90_plan_defaults_match_the_built_blocks():
    """The strip loop where Cin and Cout are <= 64; else flat 128 x 64
    blocks where Cout <= 64 and 256 x 128 above: the blocks the CUDA entry
    builds, and no others."""
    assert sm90_plan(64, 64).kind == "strip" and sm90_plan(8, 24).kind == "strip"
    p = sm90_plan(128, 64)
    assert (p.kind, p.bm, p.bn) == ("flat", 128, 64)
    p = sm90_plan(1024, 1024)
    assert (p.kind, p.bm, p.bn) == ("flat", 256, 128)
    with open(os.path.join(_CSRC, "conv3x3_bias_relu.cu")) as f:
        built = re.findall(r"sm90::launch<(\d+), (\d+), E>", f.read())
    assert sorted((int(m), int(n)) for m, n in built) == sorted(SM90_FLAT_BLOCKS)
