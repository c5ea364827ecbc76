"""The port's CUDA kernels on the card: K1 (fused 3x3 conv + bias + ReLU,
on its sm90 and simple routes) and its gradient, K2 (the EDT column
pass), K3 (the fused int8/bf16 conv of quantized serving), K4, K5 and
K6a-c (the fused enc0 chain, the fused concat + requantize and the pairing
copies of the research int8 forward), the fused k x k int8 conv of the
phase-packed level 0, the row gather of the gather probe and the three
enc0 stage kernels of the Mosaic probes; and the library-route modules of
the int4 tier and of the matmul conv backward, card against CPU. These
tests import no JAX (the
machine with the card has none) and skip without a CUDA device. Run them
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from tpu_unet_torch.models import ModelConfig, UNet
from tpu_unet_torch.ops.conv_pallas import (_conv3x3_route_forward, conv3x3_bias_relu,
                                            conv3x3_bias_relu_plain, sm90_plan)
from tpu_unet_torch.ops.conv_kxk import (_conv_kxk_route_forward, conv2x2_fused,
                                         conv_kxk_fused, conv_kxk_fused_plain,
                                         conv_kxk_route, conv_rows3_col)
from tpu_unet_torch.ops.conv_tiles import (_conv3x3_fused_route_forward, conv3x3_fused,
                                           conv3x3_fused_plain, conv3x3_fused_route,
                                           conv3x3_int8_xla)
from tpu_unet_torch.ops import conv_bwd
from tpu_unet_torch.ops import conv_tiles as ct
from tpu_unet_torch.ops import enc0_stages as st
from tpu_unet_torch.ops import edt_pallas
from tpu_unet_torch.ops.edt import edt_batch
from tpu_unet_torch.ops.edt_pallas import (_column_pass_route_forward, column_pass,
                                           column_pass_plain)
from tpu_unet_torch.ops.fused_level0 import (_enc0_chain_route_forward, _inverse,
                                             concat_quantize, concat_quantize_plain, enc0_chain,
                                             enc0_chain_plain, enc0_chain_route)
from tpu_unet_torch.ops.gather import row_gather, row_gather_plain
from tpu_unet_torch.ops.interleave import (interleave_pairs, interleave_pairs_plain,
                                           pair_batch_channels, pair_batch_channels_plain,
                                           unpair_batch_channels,
                                           unpair_batch_channels_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain version's f32 convs must not run in TF32
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(shape, cout, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=device)
         / (9 * cin) ** 0.5).to(dtype)
    b = (torch.randn((cout,), generator=g, device=device) * 0.1).to(dtype)
    return x, w, b


@pytest.mark.parametrize("shape,cout,dtype", [
    ((1, 18, 20, 8), 16, torch.float32),
    ((2, 13, 16, 4), 8, torch.float32),
    ((2, 12, 15, 1), 8, torch.float32),
    ((1, 9, 23, 3), 5, torch.float32),
    ((2, 20, 70, 64), 128, torch.bfloat16),
    ((2, 15, 33, 1), 64, torch.bfloat16),
    ((3, 13, 29, 128), 200, torch.bfloat16),
    ((2, 11, 19, 3), 20, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, shape, cout, dtype):
    """f32 (TF32 off) at rtol 1e-4 / atol 1e-5; bf16 at 2e-2 of the
    output's scale."""
    x, w, b = _inputs(shape, cout, dtype, cuda)
    with torch.no_grad():
        before = conv3x3_bias_relu.launches
        got = conv3x3_bias_relu(x, w, b)
        assert conv3x3_bias_relu.launches == before + 1
        ref = conv3x3_bias_relu_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        err = (got - ref).abs().max().item()
        assert err <= 2e-2 * max(ref.abs().max().item(), 1.0), err


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, w, b = _inputs((1, 6, 7, 8), 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        conv3x3_bias_relu(x, w.to(torch.bfloat16), b)
    with pytest.raises(TypeError):
        conv3x3_bias_relu(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        conv3x3_bias_relu(x, w, b, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_bias_relu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        conv3x3_bias_relu(x, w, b.cpu())
    with torch.enable_grad():       # the kernel now has a backward
        y = conv3x3_bias_relu(x, w.requires_grad_(), b)
        y.sum().backward()
    assert w.grad is not None and w.grad.shape == w.shape


def test_model_pallas_matches_xla(cuda):
    """A narrow f32 U-Net: the kernel path against cuDNN (TF32 off)."""
    cfg = ModelConfig(base_width=8, conv_impl="pallas")
    model = UNet(cfg).to(cuda)
    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(cuda)
    xla.load_state_dict(model.state_dict())
    x = torch.rand((2, 188, 188, 1), device=cuda)
    with torch.inference_mode():
        before = conv3x3_bias_relu.launches
        got = model(x)
        assert conv3x3_bias_relu.launches == before + 18
        ref = xla(x)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 20, 70, 64), torch.float32),
    ((2, 15, 33, 8), torch.bfloat16),
])
def test_kernel_gradient_matches_plain_autograd(cuda, shape, dtype):
    """dx, dw, db of the autograd.Function (kernel forward, library-conv
    backward) against autograd through the plain version: f32 (TF32 off)
    at rtol 1e-4; bf16 at 2e-2 of each gradient's scale."""
    x, w, b = _inputs(shape, 16, dtype, cuda, seed=3)
    g = torch.randn((shape[0], shape[1] - 2, shape[2] - 2, 16), device=cuda).to(dtype)
    grads = []
    for fn in (conv3x3_bias_relu, conv3x3_bias_relu_plain):
        xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
        fn(xs, ws, bs).backward(g)
        grads.append([t.grad.float() for t in (xs, ws, bs)])
    for got, ref in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
        else:
            assert (got - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


# (H=W of the layer's input, Cin, Cout) of the U-Net's 17 bf16 convs on
# the sm90 loop, at full width on a 572^2 tile: all but enc0_conv1.
SM90_FULL_WIDTH = [(570, 64, 64), (284, 64, 128), (282, 128, 128), (140, 128, 256),
                   (138, 256, 256), (68, 256, 512), (66, 512, 512), (32, 512, 1024),
                   (30, 1024, 1024), (56, 1024, 512), (54, 512, 512), (104, 512, 256),
                   (102, 256, 256), (200, 256, 128), (198, 128, 128), (392, 128, 64),
                   (390, 64, 64)]


def _bf16_close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(ref.float().abs().max().item(), 1.0), err


@pytest.mark.parametrize("s,cin,cout", SM90_FULL_WIDTH)
def test_sm90_loop_matches_plain_at_full_width(cuda, s, cin, cout):
    """Each full-width bf16 conv (H cut to 6 rows) on the sm90 loop within
    2e-2 of the output's scale, and the simple kernel at the same shape."""
    x, w, b = _inputs((2, 6, s, cin), cout, torch.bfloat16, cuda, seed=cin + cout)
    with torch.no_grad():
        before = (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches)
        got = conv3x3_bias_relu(x, w, b)
        assert (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches) == \
            (before[0] + 1, before[1] + 1)
        simple = _conv3x3_route_forward(x, w, b, "simple")
        ref = conv3x3_bias_relu_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _bf16_close(got, ref)
    _bf16_close(simple, ref)


@pytest.mark.parametrize("shape,cout", [
    ((2, 37, 45, 64), 64),          # M = 3010, not a multiple of 128
    ((1, 5, 130, 8), 8),            # Cin 8, Cout 8
    ((2, 9, 17, 24), 24),           # Cin 24, Cout 24
    ((1, 5, 130, 8), 72),
    ((3, 13, 29, 128), 200),        # Cout past one BN 128 block column, ragged
    ((1, 10, 12, 1024), 1024),      # Cin 1024: 144 K steps
    ((1, 3, 130, 64), 64),          # M = 128: one block
    ((2, 5, 300, 16), 40),          # strip: 3 column tiles, the last ragged
    ((2, 37, 45, 72), 40),          # flat 128 x 64: a part-filled K step and block column
])
def test_sm90_loop_edge_shapes(cuda, shape, cout):
    """The sm90 loop `sm90_plan` picks, within 2e-2 of the output's scale."""
    x, w, b = _inputs(shape, cout, torch.bfloat16, cuda, seed=cout)
    ref = conv3x3_bias_relu_plain(x, w, b)
    assert sm90_plan(shape[3], cout).kind == \
        ("strip" if shape[3] <= 64 and cout <= 64 else "flat")
    with torch.no_grad():
        before = conv3x3_bias_relu.sm90_launches
        got = conv3x3_bias_relu(x, w, b)
        assert conv3x3_bias_relu.sm90_launches == before + 1
    torch.cuda.synchronize()
    _bf16_close(got, ref)


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 256)])
def test_sm90_route_takes_a_misaligned_w(cuda, cin, cout):
    """A w 2 bytes off 16-byte alignment stays on the sm90 route (the
    wrapper copies it) and gives what the aligned w gives."""
    x, w, b = _inputs((1, 8, 40, cin), cout, torch.bfloat16, cuda, seed=cin)
    wm = torch.empty(w.numel() + 8, dtype=w.dtype, device=cuda)[1:w.numel() + 1] \
        .view(w.shape).copy_(w)
    assert wm.data_ptr() % 16 != 0
    with torch.no_grad():
        before = conv3x3_bias_relu.sm90_launches
        got = conv3x3_bias_relu(x, wm, b)
        assert conv3x3_bias_relu.sm90_launches == before + 1
        ref = conv3x3_bias_relu(x, w, b)
    assert torch.equal(got, ref)


def test_model_routes_17_convs_to_the_sm90_loop(cuda):
    """A narrow bf16 U-Net: 17 launches on the sm90 loop and enc0_conv1 on
    the simple kernel per forward; logits near cuDNN's."""
    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16", conv_impl="pallas")
    model = UNet(cfg).to(cuda)
    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(cuda)
    xla.load_state_dict(model.state_dict())
    x = torch.rand((2, 188, 188, 1), device=cuda)
    with torch.inference_mode():
        before = (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches)
        got = model(x)
        assert (conv3x3_bias_relu.launches - before[0],
                conv3x3_bias_relu.sm90_launches - before[1]) == (18, 17)
        ref = xla(x)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 5e-2 * max(ref.float().abs().max().item(), 1.0), err


# K1 with an f32 bias beside bf16 x and w (the int8 tier's float layers), on
# each route: the strip loop (64 -> 64), the flat 256 x 128 loop (64 -> 128)
# and the simple kernel (Cin 1)
F32_BIAS_CASES = [((2, 10, 100, 64), 64, "sm90"), ((2, 10, 100, 64), 128, "sm90"),
                  ((2, 15, 33, 1), 64, "simple")]


@pytest.mark.parametrize("shape,cout,route", F32_BIAS_CASES)
def test_kernel_takes_an_f32_bias(cuda, shape, cout, route):
    """bf16 x and w with an f32 bias on the route `conv3x3_route` picks (and
    the simple kernel forced at the sm90 shapes) within 2e-2 of the output's
    scale of the plain version; a bias bf16 cannot hold (1 + 2^-10) reaches
    the output where its bf16 rounding would not: relu(2^-8 + b) rounds to
    1 + 2^-7, relu(2^-8 + bf16(b)) to 1."""
    x, w, b = _inputs(shape, cout, torch.bfloat16, cuda, seed=cout)
    b = b.float() + 1e-3                  # off the bf16 grid
    assert sm90_plan(shape[3], cout).kind == ("strip" if cout <= 64 else "flat")
    with torch.no_grad():
        before = (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches)
        got = conv3x3_bias_relu(x, w, b)
        assert (conv3x3_bias_relu.launches - before[0],
                conv3x3_bias_relu.sm90_launches - before[1]) == (1, int(route == "sm90"))
        ref = conv3x3_bias_relu_plain(x, w, b)
        outs = [got] + ([_conv3x3_route_forward(x, w, b, "simple")] if route == "sm90" else [])
    torch.cuda.synchronize()
    for y in outs:
        assert y.dtype == torch.bfloat16 and y.shape == ref.shape
        _bf16_close(y, ref)
    ones = torch.zeros_like(x)
    ones[..., 0] = 1.0
    tap = torch.zeros_like(w)
    tap[1, 1, 0] = 2.0 ** -8
    odd = torch.full_like(b, 1 + 2.0 ** -10)
    with torch.no_grad():
        for fn in [conv3x3_bias_relu] + ([lambda *a: _conv3x3_route_forward(*a, "simple")]
                                         if route == "sm90" else []):
            assert bool((fn(ones, tap, odd) == 1 + 2.0 ** -7).all())
            assert bool((fn(ones, tap, odd.to(torch.bfloat16)) == 1.0).all())
            assert bool((conv3x3_bias_relu_plain(ones, tap, odd) == 1 + 2.0 ** -7).all())


def test_route_forward_refuses_what_its_route_does_not_take(cuda):
    x, w, b = _inputs((1, 6, 7, 12), 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="sm90"):
        _conv3x3_route_forward(x, w, b, "sm90")          # Cin 12
    with pytest.raises(ValueError, match="route"):
        _conv3x3_route_forward(x, w, b, "cudnn")
    with pytest.raises(ValueError, match="cuda"):
        _conv3x3_route_forward(x.cpu(), w.cpu(), b.cpu(), "simple")


def _g2(shape, seed, device):
    """Squared row distances of random blob masks: integers and +inf."""
    from tpu_unet_torch.ops.edt import _row_distance, _squared

    g = torch.Generator(device=device).manual_seed(seed)
    masks = torch.rand(shape, generator=g, device=device) < 0.02
    return _squared(_row_distance(masks)).contiguous()


# K2's routes: "sm90" (what column_pass runs) and "simple" (the first kernel)
K2_FORMS = {
    "sm90": lambda g2, nv, band: column_pass(g2, num_valid=nv, band=band),
    "simple": lambda g2, nv, band: _column_pass_route_forward(g2, nv, band, "simple"),
}


@pytest.mark.parametrize("shape,num_valid", [
    ((2, 32, 388, 388), [5, 0]),
    ((2, 32, 388, 388), None),    # all 64 planes live
    ((3, 70, 45), None),          # H, W not multiples of the tile; W not of 4
    ((2, 30, 100), None),         # H < band
    ((1, 4, 1, 37), [2]),         # one-row planes
    ((5, 64, 33), 3),
    ((2, 6, 37, 41), [4, 1]),     # H*W*4 not a multiple of 16: scalar +inf stores
])
@pytest.mark.parametrize("band", [40, None])
@pytest.mark.parametrize("form", list(K2_FORMS))
def test_column_pass_kernel_is_bit_exact(cuda, shape, num_valid, band, form):
    g2 = _g2(shape, 0, cuda)
    g2.view(-1, *shape[-2:])[0] = float("inf")   # an all-+inf plane
    if isinstance(num_valid, list):
        num_valid = torch.tensor(num_valid, dtype=torch.int32, device=cuda)
    before = column_pass.launches, column_pass.sm90_launches
    got = K2_FORMS[form](g2, num_valid, band)
    sm90 = int(form != "simple")
    assert (column_pass.launches, column_pass.sm90_launches) == (before[0] + 1,
                                                                 before[1] + sm90)
    ref = column_pass_plain(g2, num_valid=num_valid, band=band)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("band", [40, None])
def test_edt_batch_runs_the_sm90_route(cuda, band, monkeypatch):
    """edt_batch's column pass takes route "sm90", and its distances equal
    those of the plain column pass."""
    g = torch.Generator(device=cuda).manual_seed(3)
    masks = torch.rand((2, 6, 60, 50), generator=g, device=cuda) < 0.01
    nv = torch.tensor([6, 2], dtype=torch.int32, device=cuda)
    routes = []
    launch = edt_pallas._launch
    monkeypatch.setattr(edt_pallas, "_launch",
                        lambda *a, **k: routes.append(a[3]) or launch(*a, **k))
    before = column_pass.sm90_launches
    got = edt_batch(masks, num_valid=nv, band=band)
    assert column_pass.sm90_launches == before + 1 and routes == ["sm90"]
    from tpu_unet_torch.ops.edt import _row_distance, _squared
    ref = torch.sqrt(column_pass_plain(_squared(_row_distance(masks)).contiguous(),
                                       num_valid=nv, band=band))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_column_pass_refuses_what_it_does_not_take(cuda):
    g2 = _g2((2, 8, 9), 1, cuda)
    with pytest.raises(TypeError):
        column_pass(g2.double())
    with pytest.raises(ValueError, match="contiguous"):
        column_pass(g2.transpose(1, 2))
    with pytest.raises(ValueError):
        column_pass(g2[None], num_valid=torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="no route"):
        _column_pass_route_forward(g2, None, None, "fast")


def _k3_inputs(shape, cout, dtype, device, seed=0, offset=0):
    """int8 (or bf16) x and w, f32 alpha and beta that put the outputs
    across [0, 127]. `offset` > 0 places x that many bytes past a 16-byte
    boundary, which the kernel must take on its scalar load path."""
    g = torch.Generator(device=device).manual_seed(seed)
    cin = shape[-1]
    if dtype == torch.int8:
        n = int(torch.tensor(shape).prod())
        buf = torch.randint(-127, 128, (n + offset,), generator=g, device=device,
                            dtype=torch.int8)
        x = buf[offset:].view(shape)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device=device,
                          dtype=torch.int8)
        alpha = torch.rand((cout,), generator=g, device=device) * 2e-3 / cin ** 0.5
        beta = torch.randn((cout,), generator=g, device=device) * 3
    else:
        x = torch.randn(shape, generator=g, device=device).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=device)
             / (9 * cin) ** 0.5).to(dtype)
        alpha = torch.ones((cout,), device=device)
        beta = torch.randn((cout,), generator=g, device=device) * 0.1
    return x, w, alpha, beta


@pytest.mark.parametrize("shape,cout,offset", [
    ((2, 10, 12, 16), 8, 0),        # Cin 16, Cout 8: 16-byte loads
    ((1, 9, 13, 24), 40, 0),        # Cin 24: the scalar load path, ragged Cout
    ((2, 10, 12, 16), 8, 3),        # x off its 16-byte alignment
    ((1, 12, 40, 3), 5, 0),         # K = 27 < one staged step
    ((2, 20, 70, 128), 256, 0),     # a main-path channel pair, ragged pixels
])
@pytest.mark.parametrize("out_kind", ["int8", "bf16"])
def test_fused_kernel_is_bit_exact_int8(cuda, shape, cout, offset, out_kind):
    """K3 on int8 inputs against its plain version and the int8 library
    route: the int32 sums are exact and the epilogue is the same two f32
    roundings, so all three agree bit for bit."""
    x, w, alpha, beta = _k3_inputs(shape, cout, torch.int8, cuda, offset=offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = conv3x3_fused.launches
    got = conv3x3_fused(x, w, alpha, beta, out_kind=out_kind)
    assert conv3x3_fused.launches == before + 1
    ref = conv3x3_fused_plain(x, w, alpha, beta, out_kind)
    lib = conv3x3_int8_xla(x, w, alpha, beta, out_kind)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == (torch.int8 if out_kind == "int8" else torch.bfloat16)
    assert torch.equal(got, ref) and torch.equal(lib, ref)
    if out_kind == "int8":
        assert 0 < (ref > 0).float().mean() < 1 and int(ref.max()) <= 127


@pytest.mark.parametrize("shape,cout", [((2, 11, 19, 16), 24), ((1, 9, 13, 3), 5)])
def test_fused_kernel_bf16_inputs_match_plain(cuda, shape, cout):
    """bf16 x bf16 -> f32 sums, bf16 out: the kernel and the plain version
    sum in other orders; held at 2e-2 of the output's scale, as K1."""
    x, w, alpha, beta = _k3_inputs(shape, cout, torch.bfloat16, cuda)
    got = conv3x3_fused(x, w, alpha, beta)
    ref = conv3x3_fused_plain(x, w, alpha, beta)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * max(ref.float().abs().max().item(), 1.0), err


def test_fused_kernel_refuses_what_it_does_not_take(cuda):
    x, w, alpha, beta = _k3_inputs((1, 6, 7, 16), 8, torch.int8, cuda)
    before = conv3x3_fused.launches
    with pytest.raises(TypeError):
        conv3x3_fused(x, w.to(torch.bfloat16), alpha, beta)        # mixed dtypes
    with pytest.raises(TypeError):
        conv3x3_fused(x.float(), w.float(), alpha, beta)
    with pytest.raises(TypeError):
        conv3x3_fused(x, w, alpha.double(), beta)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_fused(x.transpose(1, 2).contiguous().transpose(1, 2), w, alpha, beta)
    with pytest.raises(ValueError):
        conv3x3_fused(x, w, alpha.cpu(), beta)
    assert conv3x3_fused.launches == before


# The int8 wgmma loop (route "sm90") off the model's shapes, against the
# plain version and the one-stage kernel, bit for bit: M not a multiple of
# the block, Cout 16/48/64/200/1024, Cin 16/48/1040 (a part-filled 128-channel
# K step), both blocks.
K3_LOOP_EDGES = [
    ((2, 37, 45, 128), 64),         # M = 3010; the 128 x 64 block
    ((1, 10, 30, 16), 16),          # Cin 16, Cout 16
    ((2, 9, 21, 48), 48),           # Cin 48, Cout 48
    ((3, 13, 29, 128), 200),        # Cout 200: bf16 out only (int8 out: simple)
    ((1, 10, 12, 1040), 1024),      # Cin 1040: 9 K steps per tap, the last part-filled
    ((2, 8, 20, 256), 1024),        # 8 block columns of 128
]


@pytest.mark.parametrize("shape,cout", K3_LOOP_EDGES)
@pytest.mark.parametrize("out_kind", ["int8", "bf16"])
def test_k3_loop_is_bit_exact_at_edge_shapes(cuda, shape, cout, out_kind):
    """K3 as routed (the loop where it takes the shape) and the forced
    simple route against the plain version, tolerance 0; the launch's
    route is the one `conv3x3_fused_route` names."""
    x, w, alpha, beta = _k3_inputs(shape, cout, torch.int8, cuda, seed=cout)
    route = conv3x3_fused_route(x, w, out_kind)
    assert route == ("simple" if out_kind == "int8" and cout % 16 else "sm90")
    ref = conv3x3_fused_plain(x, w, alpha, beta, out_kind)
    before = (conv3x3_fused.launches, conv3x3_fused.sm90_launches)
    got = conv3x3_fused(x, w, alpha, beta, out_kind=out_kind)
    assert (conv3x3_fused.launches, conv3x3_fused.sm90_launches) == \
        (before[0] + 1, before[1] + (route == "sm90"))
    simple = _conv3x3_fused_route_forward(x, w, alpha, beta, "simple", out_kind)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and torch.equal(got, ref) and torch.equal(simple, ref)
    assert 0 < (ref > 0).float().mean() < 1


@pytest.mark.parametrize("label,shape,cout,dtype,offset", [
    ("bf16 x", (1, 9, 13, 16), 16, torch.bfloat16, 0),
    ("Cin 24", (1, 9, 13, 24), 16, torch.int8, 0),
    ("Cout 40, int8 out", (1, 9, 13, 16), 40, torch.int8, 0),
    ("misaligned x", (1, 9, 13, 16), 16, torch.int8, 4),
])
def test_k3_routes_what_the_loop_does_not_take_to_the_simple_kernel(
        cuda, label, shape, cout, dtype, offset):
    x, w, alpha, beta = _k3_inputs(shape, cout, dtype, cuda, offset=offset)
    assert conv3x3_fused_route(x, w) == "simple"
    before = conv3x3_fused.sm90_launches
    got = conv3x3_fused(x, w, alpha, beta)
    assert conv3x3_fused.sm90_launches == before
    with pytest.raises(ValueError, match="sm90 route does not take"):
        _conv3x3_fused_route_forward(x, w, alpha, beta, "sm90")
    if dtype == torch.int8:
        assert torch.equal(got, conv3x3_fused_plain(x, w, alpha, beta))


def test_quant_inference_kernel_matches_library_route(cuda):
    """A narrow int8 engine on the card: every stage under impl='pallas' (K3,
    14 launches per forward) equals impl='xla' (the library route)."""
    from tpu_unet_torch.infer.quant import (QuantInference, add_concat_scales,
                                            calibrate, default_quant_names,
                                            prepare_quant_params)

    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((2, 188, 188, 1), device=cuda)
    scales = add_concat_scales(cfg, calibrate(model, x))
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, 16))
    engines = {impl: QuantInference(qp, impl=impl, device=cuda) for impl in ("pallas", "xla")}
    before = (conv3x3_fused.launches, conv3x3_fused.sm90_launches)
    logits = engines["pallas"].apply(x)
    # at base width 8 dec0_conv1 has Cout 8, which the int8 loop does not
    # take (16 per store): 13 of the 14 on the loop
    assert (conv3x3_fused.launches, conv3x3_fused.sm90_launches) == \
        (before[0] + 14, before[1] + 13)
    assert torch.equal(logits, engines["xla"].apply(x)) and torch.isfinite(logits).all()
    for stage in ("enc1_conv2", "pool2", "bottleneck_conv2", "up1", "dec1_conv1",
                  "dec0_conv1"):
        got = engines["pallas"].apply(x, stop_after=stage)
        assert torch.equal(got, engines["xla"].apply(x, stop_after=stage)), stage


# the int8 engine's float 3x3 convs at base width 8 (min_channels 16), and
# the stage each reads
ENGINE_FLOAT_CONVS = {"enc0_conv1": None, "enc0_conv2": "enc0_conv1",
                      "enc1_conv1": "pool0", "dec0_conv2": "dec0_conv1"}
ENGINE_STAGES = ("enc0_conv1", "enc0_conv2", "pool0", "enc1_conv1", "enc1_conv2", "pool2",
                 "bottleneck_conv2", "up1", "dec1_conv1", "dec0_conv1", "dec0_conv2", None)


@pytest.mark.parametrize("int4", [False, True])
def test_quant_engine_runs_its_float_convs_on_k1(cuda, int4):
    """A narrow int8 (and int4) engine of a config that routes its 3x3 convs
    to K1 (conv_impl='pallas'): its four float 3x3 convs take K1 with the
    f32 bias, 3 on the sm90 loop, a forward; each within 2e-2 of its scale
    of the library expression on the same input; 'pallas' and 'xla' equal
    at every stage; the engine of the 'xla' config launches no K1."""
    from tpu_unet_torch.infer.quant import (QuantInference, add_concat_scales,
                                            calibrate, default_int4_names,
                                            default_quant_names, prepare_quant_params)

    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16", conv_impl="pallas")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((2, 188, 188, 1), generator=torch.Generator().manual_seed(1)).to(cuda)
    scales = add_concat_scales(cfg, calibrate(model, x))
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, 16),
                              q4names=default_int4_names(cfg, 16) if int4 else None)
    xla_qp = dataclasses.replace(qp, cfg=dataclasses.replace(cfg, conv_impl="xla"))
    engines = {impl: QuantInference(qp, impl=impl, device=cuda) for impl in ("pallas", "xla")}
    library = QuantInference(xla_qp, impl="pallas", device=cuda)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the upconvs run twice
    try:
        for impl, qi in engines.items():
            before = (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches)
            qi.apply(x)
            assert (conv3x3_bias_relu.launches - before[0],
                    conv3x3_bias_relu.sm90_launches - before[1]) == (4, 3), impl
        before = conv3x3_bias_relu.launches
        library.apply(x)
        assert conv3x3_bias_relu.launches == before
        assert "_fconv_hwio" not in vars(library)    # K1's kernels never built
        for stage in ENGINE_STAGES:
            got = engines["pallas"].apply(x, stop_after=stage)
            assert torch.equal(got, engines["xla"].apply(x, stop_after=stage)), stage
        k1 = engines["pallas"]
        for name, prev in ENGINE_FLOAT_CONVS.items():
            v = x.to(torch.bfloat16) if prev is None else k1.apply(x, stop_after=prev)
            if v.dtype == torch.int8:
                v = k1._deq(v, qp.scales[prev])
            got, ref = k1._conv_f(name, v), library._conv_f(name, v)
            assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
            _bf16_close(got, ref)
    finally:
        torch.backends.cudnn.deterministic = deterministic


# --- K4, K5, K6a-c: the research int8 forward's kernels -----------------------

def _enc0_inputs(shape, c, x_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((*shape, 1), generator=g, device=device).to(x_dtype)
    w1 = (torch.randn((3, 3, 1, c), generator=g, device=device) * 0.5).to(torch.bfloat16)
    b1 = torch.randn((c,), generator=g, device=device) * 0.1
    w2 = (torch.randn((3, 3, c, c), generator=g, device=device) * (2 / (9 * c)) ** 0.5
          ).to(torch.bfloat16)
    b2 = torch.randn((c,), generator=g, device=device) * 0.1
    return x, w1, b1, w2, b2


def _enc0_close(got, ref):
    """K4's bars: a bf16 map within 2e-2 of its scale (the two sum conv1 and
    conv2 in other orders); an int8 skip off by at most 1 on < 1e-3 of
    values."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = (got.float() - ref.float()).abs()
    if got.dtype == torch.int8:
        assert d.max().item() <= 1 and (d > 0).float().mean().item() < 1e-3
    else:
        assert d.max().item() <= 2e-2 * max(ref.float().abs().max().item(), 1.0)


@pytest.mark.parametrize("shape,c", [
    ((2, 36, 44), 64),     # main-path channels, one full tile and edge tiles
    ((1, 26, 30), 8),      # Ho, Wo not multiples of the 8 x 32 tile
    ((3, 22, 70), 16),
    ((1, 14, 40), 24),     # C not a multiple of 16
    ((1, 6, 6), 8),        # Ho = Wo = 2: one sm90 tile of 2 columns
    ((1, 10, 92), 24),     # Wo = 88: one whole sm90 tile
    ((1, 6, 94), 64),      # Wo = 90: a last tile of 2 columns
    ((2, 10, 182), 64),    # Wo = 178: two tiles and a 2-column one
    ((2, 12, 132), 64),    # Wo = 128: a last tile of 40 columns, as at 572
    ((140, 8, 96), 16),    # 560 tiles: not a multiple of the grid, walks cross images
])
@pytest.mark.parametrize("int8_skip", [False, True])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_enc0_chain_kernel_matches_plain(cuda, shape, c, int8_skip, x_dtype):
    """K4 as routed (sm90) against its plain version (f32 convs, TF32 off):
    the bf16 skip and the pooled map within 2e-2 of their scale; the int8
    skip off by at most 1 on < 1e-3 of values."""
    args = _enc0_inputs(shape, c, x_dtype, cuda)
    scale = 0.0
    if int8_skip:
        scale = enc0_chain_plain(*args)[0].float().max().item() / 110.0
    assert enc0_chain_route(args[0], c) == "sm90"
    before = (enc0_chain.launches, enc0_chain.sm90_launches)
    skip, pooled = enc0_chain(*args, skip_scale=scale)
    assert (enc0_chain.launches, enc0_chain.sm90_launches) == (before[0] + 1, before[1] + 1)
    rskip, rpooled = enc0_chain_plain(*args, skip_scale=scale)
    torch.cuda.synchronize()
    assert pooled.dtype == torch.bfloat16
    _enc0_close(skip, rskip)
    _enc0_close(pooled, rpooled)
    if int8_skip:
        assert 0 < (rskip > 0).float().mean() < 1


@pytest.mark.parametrize("shape,c", [((2, 36, 44), 64), ((1, 10, 182), 24), ((16, 60, 572), 64),
                                     ((3, 8, 96), 8)])
@pytest.mark.parametrize("int8_skip", [False, True])
def test_enc0_chain_sm90_matches_simple(cuda, shape, c, int8_skip):
    """The two routes, forced, at K4's bars; each launch counted by route."""
    args = _enc0_inputs(shape, c, torch.bfloat16, cuda, seed=3)
    scale = enc0_chain_plain(*args)[0].float().max().item() / 110.0 if int8_skip else 0.0
    before = (enc0_chain.launches, enc0_chain.sm90_launches)
    simple = _enc0_chain_route_forward(*args, "simple", skip_scale=scale)
    assert (enc0_chain.launches, enc0_chain.sm90_launches) == (before[0] + 1, before[1])
    sm90 = _enc0_chain_route_forward(*args, "sm90", skip_scale=scale)
    assert (enc0_chain.launches, enc0_chain.sm90_launches) == (before[0] + 2, before[1] + 1)
    torch.cuda.synchronize()
    for got, ref in zip(sm90, simple):
        _enc0_close(got, ref)


def test_enc0_chain_refused_launch_raises(cuda, monkeypatch):
    """The CUDA entry checks the walk it is handed: a plan that is not the
    shape's is refused, and the wrapper raises RuntimeError, counts nothing
    and does not fall back to the simple route or the plain version."""
    from tpu_unet_torch.ops import fused_level0

    args = _enc0_inputs((2, 10, 182), 16, torch.bfloat16, cuda)
    good = fused_level0.enc0_plan(2, 10, 182)
    monkeypatch.setattr(fused_level0, "enc0_plan",
                        lambda *a: good._replace(tiles=good.tiles + 1))
    before = (enc0_chain.launches, enc0_chain.sm90_launches)
    with pytest.raises(RuntimeError, match="sm90 route"):
        enc0_chain(*args)
    assert (enc0_chain.launches, enc0_chain.sm90_launches) == before
    with pytest.raises(ValueError):
        _enc0_chain_route_forward(*args, "fast")
    with pytest.raises(ValueError):
        enc0_chain(*_enc0_inputs((1, 10, 20), 12, torch.bfloat16, cuda))


def _halves(shape, device, seed=0):
    """An int8 skip (inside a larger tensor, cropped as the decoder crops it)
    and a bf16 upconv output spread past the int8 range at scale 0.02."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, h, w, c = shape
    big = torch.randint(-127, 128, (b, h + 6, w + 4, c), generator=g, device=device,
                        dtype=torch.int8)
    u = ((torch.rand(shape, generator=g, device=device) * 2.6 - 1.3) * 127 * 0.02)
    return big[:, 3:3 + h, 2:2 + w], u.to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 7, 9, 16), (2, 12, 20, 64), (1, 5, 6, 24)])
def test_concat_quantize_kernel_is_bit_exact(cuda, shape):
    """K5 against its plain version, tolerance 0: int8 || bf16 with the skip
    a cropped view, bf16 || bf16, bf16 || int8; C a multiple of 16 (16-byte
    path) and not (scalar path)."""
    sk, u = _halves(shape, cuda)
    assert not sk.is_contiguous()
    for a, b in ((sk, u), (u, u * 0.5), (u, sk)):
        before = concat_quantize.launches
        got = concat_quantize(a, b, 0.02)
        assert concat_quantize.launches == before + 1
        ref = concat_quantize_plain(a, b, 0.02)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert ref.min() == -127 and ref.max() == 127


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("c,offset", [(64, 0), (5, 0), (64, 1)])
def test_interleave_kernels_are_bit_exact(cuda, dtype, c, offset):
    """K6a-c against their plain versions, tolerance 0: 16-byte copies (C
    64), byte copies (C 5, or an input off its 16-byte alignment), and a
    center-cropped view into interleave_pairs."""
    g = torch.Generator(device=cuda).manual_seed(c + offset)
    n = 4 * 6 * 10 * c
    buf = torch.randint(-100, 100, (n + offset,), generator=g, device=cuda).to(dtype)
    x = buf[offset:].view(4, 6, 10, c)
    counts = (pair_batch_channels.launches, unpair_batch_channels.launches,
              interleave_pairs.launches)
    p = pair_batch_channels(x)
    assert torch.equal(p, pair_batch_channels_plain(x))
    u = unpair_batch_channels(p)
    assert torch.equal(u, unpair_batch_channels_plain(p)) and torch.equal(u, x)
    big = pair_batch_channels_plain(
        torch.randint(-100, 100, (4, 10, 14, c), generator=g, device=cuda).to(dtype))
    view = big[:, 2:8, 2:12]
    got = interleave_pairs(view, p)
    torch.cuda.synchronize()
    assert torch.equal(got, interleave_pairs_plain(view, p))
    assert (pair_batch_channels.launches, unpair_batch_channels.launches,
            interleave_pairs.launches) == tuple(k + 1 for k in counts)


def test_research_kernels_refuse_what_they_do_not_take(cuda):
    args = list(_enc0_inputs((1, 20, 24), 8, torch.bfloat16, cuda))
    counts = (enc0_chain.launches, concat_quantize.launches, interleave_pairs.launches)
    for c in (12, 72):                       # not a multiple of 8; past the kernel's 64
        with pytest.raises(ValueError, match="multiple of 8"):
            enc0_chain(*_enc0_inputs((1, 20, 24), c, torch.bfloat16, cuda))
    with pytest.raises(ValueError):
        enc0_chain(*args[:3], args[3], args[4].cpu())
    with pytest.raises(ValueError, match="quantized skip"):
        enc0_chain(*args, skip_scale=0.1, pool_mode="none")
    a = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        concat_quantize(a, a[:, :3], 0.1)
    with pytest.raises(ValueError):
        concat_quantize(a, a.cpu(), 0.1)
    with pytest.raises(TypeError):
        interleave_pairs(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        pair_batch_channels(a)                # odd batch
    assert (enc0_chain.launches, concat_quantize.launches,
            interleave_pairs.launches) == counts


@pytest.mark.parametrize("flags,launches,k3_sm90", [
    ({"fused_enc0": True, "fused_concat": True},
     {"enc0_chain": 1, "concat_quantize": 4}, 13),
    ({"pair_level0": True},
     {"pair_batch_channels": 1, "unpair_batch_channels": 1, "interleave_pairs": 1}, 14),
])
def test_research_forward_kernel_matches_library_route(cuda, flags, launches, k3_sm90):
    """A narrow research int8 engine on the card: impl='pallas' (K3 and the
    research kernels) equals impl='xla' (the int8 library route and the same
    research kernels) bit for bit, with each kernel's launches per forward:
    K3 on the int8 loop but for dec0_conv1's Cout 8 at this width, which the
    pair formulation doubles to 16."""
    from tpu_unet_torch.infer.quant import (add_concat_scales, calibrate,
                                            default_quant_names, prepare_quant_params)
    from tpu_unet_torch.infer.quant_research import ResearchQuantInference
    from tpu_unet_torch.ops import fused_level0, interleave

    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((2, 188, 188, 1), device=cuda)
    scales = add_concat_scales(cfg, calibrate(model, x))
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, 16))
    fns = {name: getattr(fused_level0, name, None) or getattr(interleave, name)
           for name in launches}
    before = {name: fn.launches for name, fn in fns.items()}
    k3 = (conv3x3_fused.launches, conv3x3_fused.sm90_launches)
    logits = ResearchQuantInference(qp, impl="pallas", device=cuda, **flags).apply(x)
    assert (conv3x3_fused.launches, conv3x3_fused.sm90_launches) == \
        (k3[0] + 14, k3[1] + k3_sm90)
    assert {name: fn.launches - before[name] for name, fn in fns.items()} == launches
    ref = ResearchQuantInference(qp, impl="xla", device=cuda, **flags).apply(x)
    assert logits.shape == (2, 4, 4, 2) and torch.isfinite(logits).all()
    assert torch.equal(logits, ref)


# --- the fused k x k int8 conv of the phase-packed level 0 ---------------------

def _kxk_inputs(shape, k, cout, device, offset=0, seed=0):
    """int8 x (off its 16-byte alignment by `offset` bytes) and w, with f32
    alpha and beta that spread the outputs over [0, 127]."""
    g = torch.Generator(device=device).manual_seed(seed)
    cin = shape[-1]
    n = 1
    for d in shape:
        n *= d
    buf = torch.randint(-127, 128, (n + offset,), generator=g, device=device,
                        dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=g, device=device,
                      dtype=torch.int8)
    alpha = torch.rand((cout,), generator=g, device=device) * 2e-3 / (k * k * cin) ** 0.5
    beta = torch.randn((cout,), generator=g, device=device) * 3
    return buf[offset:].view(shape), w, alpha, beta


@pytest.mark.parametrize("k,shape,cout,offset", [
    (2, (2, 21, 19, 256), 256, 0),   # the packed path's channels, odd extents
    (2, (2, 9, 13, 32), 32, 0),      # packed widths of a narrow model
    (2, (1, 8, 11, 24), 40, 0),      # Cin 24: the scalar load path, ragged Cout
    (2, (2, 9, 12, 32), 16, 5),      # x off its 16-byte alignment
    (3, (2, 12, 30, 128), 128, 0),   # the 3x3 case (conv_rows3_col)
    (3, (1, 7, 9, 3), 5, 0),         # K = 27 < one staged step
])
def test_kxk_kernel_is_bit_exact(cuda, k, shape, cout, offset):
    """The kernel against its plain version and the int8 library route: the
    int32 sums are exact and the epilogue the same two f32 roundings, so
    all three agree bit for bit; each wrapper name launches it once."""
    x, w, alpha, beta = _kxk_inputs(shape, k, cout, cuda, offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    ref = conv_kxk_fused_plain(x, w, alpha, beta)
    lib = conv3x3_int8_xla(x, w, alpha, beta, "int8")
    calls = [lambda: conv_kxk_fused(x, w, alpha, beta),
             lambda: conv_rows3_col(x, w, alpha, beta, cout_tile=cout)]
    if k == 2:
        calls.append(lambda: conv2x2_fused(x, w, alpha, beta, cout_tile=cout))
    for call in calls:
        before = conv_kxk_fused.launches
        got = call()
        assert conv_kxk_fused.launches == before + 1
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert torch.equal(lib, ref)
    assert 0 < (ref > 0).float().mean() < 1 and int(ref.max()) <= 127


@pytest.mark.parametrize("k,shape,cout", [
    (2, (2, 21, 19, 256), 256),      # the packed path's channels, odd extents
    (2, (1, 9, 13, 48), 48),         # Cin 48, Cout 48
    (2, (2, 37, 45, 64), 64),        # M = 3168 on the 128 x 64 block
    (3, (1, 7, 50, 16), 16),         # the 3x3 case at Cin 16, Cout 16
    (3, (1, 9, 12, 1040), 1024),     # Cin 1040: a part-filled K step
])
def test_kxk_loop_is_bit_exact_at_edge_shapes(cuda, k, shape, cout):
    """The k x k kernel on the int8 wgmma loop and on the forced simple
    route against the plain version, tolerance 0, each launch on the route
    `conv_kxk_route` names."""
    x, w, alpha, beta = _kxk_inputs(shape, k, cout, cuda, seed=cout)
    assert conv_kxk_route(x, w) == "sm90"
    ref = conv_kxk_fused_plain(x, w, alpha, beta)
    before = (conv_kxk_fused.launches, conv_kxk_fused.sm90_launches)
    got = conv_kxk_fused(x, w, alpha, beta)
    assert (conv_kxk_fused.launches, conv_kxk_fused.sm90_launches) == \
        (before[0] + 1, before[1] + 1)
    simple = _conv_kxk_route_forward(x, w, alpha, beta, "simple")
    assert conv_kxk_fused.sm90_launches == before[1] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(simple, ref)
    assert 0 < (ref > 0).float().mean() < 1


def test_kxk_routes_what_the_loop_does_not_take_to_the_simple_kernel(cuda):
    for shape, cout, offset in (((1, 8, 11, 24), 16, 0), ((1, 8, 11, 16), 40, 0),
                                ((2, 9, 12, 32), 16, 5)):
        x, w, alpha, beta = _kxk_inputs(shape, 2, cout, cuda, offset)
        assert conv_kxk_route(x, w) == "simple"
        before = conv_kxk_fused.sm90_launches
        got = conv_kxk_fused(x, w, alpha, beta)
        assert conv_kxk_fused.sm90_launches == before
        assert torch.equal(got, conv_kxk_fused_plain(x, w, alpha, beta))
        with pytest.raises(ValueError, match="sm90 route does not take"):
            _conv_kxk_route_forward(x, w, alpha, beta, "sm90")


def test_kxk_kernel_refuses_what_it_does_not_take(cuda):
    x, w, alpha, beta = _kxk_inputs((1, 6, 7, 16), 2, 8, cuda)
    before = conv_kxk_fused.launches
    with pytest.raises(TypeError):
        conv_kxk_fused(x, w, alpha.double(), beta)
    with pytest.raises(TypeError):
        conv_kxk_fused(x.float(), w.float(), alpha, beta)
    with pytest.raises(ValueError, match="contiguous"):
        conv_kxk_fused(x.transpose(1, 2).contiguous().transpose(1, 2), w, alpha, beta)
    with pytest.raises(ValueError):
        conv_kxk_fused(x, w, alpha.cpu(), beta)
    with pytest.raises(ValueError):
        conv_kxk_fused(x, torch.zeros((4, 4, 16, 8), dtype=torch.int8, device=cuda),
                       alpha, beta)
    assert conv_kxk_fused.launches == before


def test_phase_engine_kernel_matches_library_route(cuda):
    """A narrow int8-phase engine on the card: impl='pallas' (the k x k
    kernel twice, K3 13 times per forward) equals impl='xla' (the library
    routes) bit for bit at every level-0 stage and in the logits."""
    from tpu_unet_torch.infer.quant import (QuantInference, add_concat_scales,
                                            calibrate, default_quant_names,
                                            prepare_quant_params)

    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand((2, 188, 204, 1), device=cuda)
    scales = add_concat_scales(cfg, calibrate(model, x))
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, 16))
    engines = {impl: QuantInference(qp, impl=impl, phase_level0="int8", device=cuda)
               for impl in ("pallas", "xla")}
    counts = lambda: (conv_kxk_fused.launches, conv3x3_fused.launches,   # noqa: E731
                      conv_kxk_fused.sm90_launches, conv3x3_fused.sm90_launches)
    before = counts()
    logits = engines["pallas"].apply(x)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 13, 2, 13)
    assert logits.shape == (2, 4, 20, 2) and torch.isfinite(logits).all()
    assert torch.equal(logits, engines["xla"].apply(x))
    for stage in ("enc0_conv1", "enc0_conv2", "pool0", "up0", "dec0_conv1", "dec0_conv2"):
        got = engines["pallas"].apply(x, stop_after=stage)
        assert torch.equal(got, engines["xla"].apply(x, stop_after=stage)), stage


# Gradients of the phase-packed and the plain model, per tensor in norm:
# one pre-activation within rounding of 0 can take another sign under the
# two summation orders, and the flipped ReLU mask moves a whole gradient
# term (tests/test_torch_phase_train.py shows one such flip on the CPU at
# this input). chip_smoke.py's phase 7 holds a train step to the same bar.
PHASE_GRAD_TOL = 1e-2


def test_phase_model_matches_plain_on_the_card(cuda):
    """The phase-packed trainable model against the plain one on the same
    weights, f32 with TF32 off: logits at rtol 2e-4, each gradient within
    PHASE_GRAD_TOL of its norm."""
    cfg = ModelConfig(base_width=8)
    model = UNet(cfg, generator=torch.Generator().manual_seed(1)).to(cuda)
    phase = UNet(dataclasses.replace(cfg, phase_level0=True)).to(cuda)
    phase.load_state_dict(model.state_dict())
    x = torch.rand((2, 204, 204, 1), generator=torch.Generator().manual_seed(2)).to(cuda)
    ys = [m(x) for m in (model, phase)]
    torch.testing.assert_close(ys[1], ys[0], rtol=2e-4, atol=2e-4)
    for y in ys:
        y.square().mean().backward()
    for (name, p), q in zip(model.named_parameters(), phase.parameters()):
        err = ((q.grad - p.grad).norm() / p.grad.norm()).item()
        assert err <= PHASE_GRAD_TOL, (name, err)


@pytest.mark.parametrize("c,offset", [(128, 0), (2, 0), (8, 0), (1, 0), (3, 0), (5, 0),
                                      (128, 1), (8, 3)])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_kernel_is_bit_exact(cuda, c, offset, idx_dtype):
    """Bit for bit against the plain version, NaN in the same places: in
    range, negative and out-of-range indices; a src view off its 16-byte
    alignment by `offset` floats takes the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(c + offset)
    n, m = 300, 1000
    buf = torch.rand((n * c + offset,), generator=g, device=cuda)
    src = buf[offset:].view(n, c)
    idx = torch.randint(-n - 20, n + 20, (m,), generator=g, device=cuda).to(idx_dtype)
    before = row_gather.launches
    got = row_gather(src, idx)
    assert row_gather.launches == before + 1
    ref = row_gather_plain(src, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert 0 < torch.isnan(ref[:, 0]).float().mean() < 0.2
    cols = torch.rand((n, 2 * c), generator=g, device=cuda)[:, :c]   # row stride 2c
    torch.testing.assert_close(row_gather(cols, idx), row_gather_plain(cols, idx), rtol=0,
                               atol=0, equal_nan=True)


def test_row_gather_refuses_what_it_does_not_take(cuda):
    src = torch.rand((10, 4), device=cuda)
    idx = torch.arange(5, device=cuda)
    before = row_gather.launches
    with pytest.raises(ValueError):
        row_gather(src.double(), idx)
    with pytest.raises(ValueError):
        row_gather(src, idx.float())
    with pytest.raises(ValueError):
        row_gather(src, idx.cpu())
    assert row_gather.launches == before
    assert row_gather(src, idx[:0]).shape == (0, 4)


def _bf16_ulp_ok(got, ref, scale_tol=1e-5):
    """Every value within one bf16 ulp of `ref`'s (2^(e - 8) for |ref| =
    m 2^e, m in [0.5, 1)), or within `scale_tol` of the output's scale
    (values near 0, where the f32 sums' order decides the sign)."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    floor = scale_tol * max(r.abs().max().item(), 1.0)
    return bool(((g - r).abs() <= ulp + floor).all())


@pytest.mark.parametrize("taps,dtype,c", [(False, torch.float32, 64),
                                          (False, torch.bfloat16, 64),
                                          (False, torch.float32, 24), (True, torch.float32, 16)])
@pytest.mark.parametrize("bias", [False, True])
def test_conv1_stage_kernel_matches_plain(cuda, taps, dtype, c, bias):
    """Within one bf16 ulp: the kernel sums by fmaf, the plain version by
    products and sums apart."""
    g = torch.Generator(device=cuda).manual_seed(c)
    shape = (2, 13, 37, 9) if taps else (2, 15, 39)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w9 = torch.randn((9, c), generator=g, device=cuda) * 0.5
    b = torch.randn((c,), generator=g, device=cuda) * 0.1 if bias else None
    before = st.conv1_stage.launches
    got = st.conv1_stage(x, w9, b, taps=taps)
    assert st.conv1_stage.launches == before + 1
    ref = st.conv1_stage_plain(x, w9, b, taps=taps)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _bf16_ulp_ok(got, ref)


@pytest.mark.parametrize("shape,c,taps,dtype", [
    ((3, 5, 7, 9), 16, True, torch.float32),     # 105 pixels: runs cross row and image ends
    ((2, 1, 3, 9), 64, True, torch.float32),     # 6 pixels: one run past the slab's end
    ((2, 7, 21), 24, False, torch.float32),      # Ho 5 (the last row pair cut), Wo 19
    ((2, 7, 21), 24, False, torch.bfloat16),
    ((3, 4, 20), 8, False, torch.bfloat16),      # Ho 2, Wo 18: one row pair per image
    ((2, 9, 130), 128, False, torch.float32),    # C 128: 16 channel groups a pixel
])
def test_conv1_stage_runs_cross_row_and_image_ends(cuda, shape, c, taps, dtype):
    """Within one bf16 ulp of the plain version where the producer's pixel
    runs (16 pixels of two output rows; of the flat pixel order for the
    slab) end past a row, an image or the slab, and at odd output extents."""
    g = torch.Generator(device=cuda).manual_seed(len(shape) + c)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w9 = torch.randn((9, c), generator=g, device=cuda) * 0.5
    b = torch.randn((c,), generator=g, device=cuda) * 0.1
    got = st.conv1_stage(x, w9, b, taps=taps)
    ref = st.conv1_stage_plain(x, w9, b, taps=taps)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _bf16_ulp_ok(got, ref)


@pytest.mark.parametrize("shape,cin,cout", [((2, 13, 37), 64, 64), ((1, 11, 21), 16, 24),
                                            ((2, 10, 34), 24, 16), ((1, 19, 7), 8, 64)])
@pytest.mark.parametrize("relu_bf16", [False, True])
def test_conv2_stage_kernel_matches_plain(cuda, shape, cin, cout, relu_bf16):
    """f32 out within 1e-5 of the output's scale (summation order only);
    ReLU-bf16 out within one bf16 ulp. Odd output extents, Cin not a
    multiple of 16."""
    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    h = torch.relu(torch.randn((*shape, cin), generator=g, device=cuda)).to(torch.bfloat16)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=cuda)
         * (2 / (9 * cin)) ** 0.5).to(torch.bfloat16)
    before = st.conv2_stage.launches
    got = st.conv2_stage(h, w, relu_bf16=relu_bf16)
    assert st.conv2_stage.launches == before + 1
    ref = st.conv2_stage_plain(h, w, relu_bf16=relu_bf16)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if relu_bf16:
        assert _bf16_ulp_ok(got, ref)
    else:
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip,pool", [(None, True), ("bf16", True), ("int8", True),
                                       ("int8", False), ("bf16", False)])
def test_pool_quant_stage_kernel_is_bit_exact(cuda, dtype, skip, pool):
    """Bit for bit, with values that land on .5 after scaling (round half
    to even) and past 127; C 24 and 64."""
    for c, shape in ((64, (2, 12, 34)), (24, (1, 6, 10))):
        g = torch.Generator(device=cuda).manual_seed(c)
        h = (torch.randint(-40, 600, (*shape, c), generator=g, device=cuda) / 4.0).to(dtype)
        kw = {"skip": skip, "pool": pool, "skip_scale": 2.0 if skip == "int8" else None}
        before = st.pool_quant_stage.launches
        got = st.pool_quant_stage(h, **kw)
        assert st.pool_quant_stage.launches == before + 1
        ref = st.pool_quant_stage_plain(h, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)
        if skip == "int8":
            q = ref[0].float()
            assert (q == 127).any() and (q == 0).any()
            assert ((h.float() * 2.0) % 1 == 0.5).any()


def test_stage_kernels_refuse_what_they_do_not_take(cuda):
    h = torch.rand((1, 6, 8, 12), device=cuda)
    before = (st.conv1_stage.launches, st.conv2_stage.launches, st.pool_quant_stage.launches)
    with pytest.raises(ValueError, match="multiples of 8"):
        st.pool_quant_stage(h)
    with pytest.raises(ValueError, match="multiples of 8"):
        st.conv1_stage(h[0, :, :, :1].permute(2, 0, 1), torch.rand((9, 12), device=cuda))
    with pytest.raises(ValueError, match="up to"):
        st.conv2_stage(torch.rand((1, 5, 5, 72), device=cuda).to(torch.bfloat16),
                       torch.rand((3, 3, 72, 8), device=cuda).to(torch.bfloat16))
    with pytest.raises(ValueError):
        st.conv1_stage(h[..., 0], torch.rand((9, 8)))
    assert before == (st.conv1_stage.launches, st.conv2_stage.launches,
                      st.pool_quant_stage.launches)


@pytest.mark.parametrize("shape,c", [((2, 44, 76), 64), ((2, 20, 136), 16), ((1, 14, 132), 24),
                                     ((1, 10, 572), 64)])
def test_staged_chain_matches_enc0_chain(cuda, shape, c):
    """conv1 -> conv2 (ReLU, bf16) -> pool + int8 skip against K4 with b2 =
    0: the conv2 stage and K4's sm90 route issue one MMA step
    (`strip_mma`) on the same h1, so the pooled maps are equal; the int8
    skip quantizes bf16(h2), not h2, so it is off by at most 1. C 16 and 24
    leave most of the wgmma's 64 channel rows zero; widths 128 and 568 end
    in a 40-column tile."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand((*shape, 1), generator=g, device=cuda).to(torch.bfloat16)
    w1 = (torch.randn((3, 3, 1, c), generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    b1 = torch.randn((c,), generator=g, device=cuda) * 0.1
    w2 = (torch.randn((3, 3, c, c), generator=g, device=cuda) * (2 / (9 * c)) ** 0.5
          ).to(torch.bfloat16)
    b2 = torch.zeros((c,), device=cuda)
    scale = enc0_chain(x, w1, b1, w2, b2)[0].float().max().item() / 110
    skip, pooled = enc0_chain(x, w1, b1, w2, b2, skip_scale=scale)
    h1 = st.conv1_stage(x[..., 0], w1.float().reshape(9, c), b1)
    h2 = st.conv2_stage(h1, w2, relu_bf16=True)
    s_skip, s_pooled = st.pool_quant_stage(h2, skip="int8", skip_scale=_inverse(scale))
    torch.cuda.synchronize()
    assert torch.equal(s_pooled, pooled)
    assert (s_skip.float() - skip.float()).abs().max().item() <= 1


# --- the int4 tier and the matmul conv backward (library routes) -------------

@pytest.mark.parametrize("shape,cout", [((2, 30, 30, 128), 128), ((1, 17, 23, 48), 24),
                                        ((2, 12, 14, 1024), 16)])
def test_int4_ops_on_the_card_equal_the_cpu(cuda, shape, cout):
    """The int4 helpers on CUDA tensors (the accumulate on the int8 library
    route) against the same calls on CPU copies, bit for bit: the shifted
    and signed accumulates, the u4s epilogue and the four quantizers."""
    g = torch.Generator().manual_seed(3)
    x4 = torch.randint(-8, 8, shape, generator=g, dtype=torch.int8)
    w4 = torch.randint(-7, 8, (3, 3, shape[-1], cout), generator=g, dtype=torch.int8)
    alpha = torch.rand(cout, generator=g) * 0.05
    beta = torch.randn(cout, generator=g)
    xf = torch.rand(shape, generator=g) * 3
    x8 = torch.randint(0, 128, shape, generator=g, dtype=torch.int8)
    calls = [
        lambda d: ct.conv3x3_int4_acc(x4.to(d), w4.to(d), shifted=True),
        lambda d: ct.conv3x3_int4_acc(x4.clamp(-7, 7).to(d), w4.to(d)),
        lambda d: ct.conv3x3_int4_xla(x4.to(d), w4.to(d), alpha.to(d), beta.to(d),
                                      out_kind="u4s", shifted=True),
        lambda d: ct.quantize_weights_int4(w4.float().to(d) * 0.01)[0],
        lambda d: ct.quantize_activations_u4s(xf.to(d), 0.2),
        lambda d: ct.quantize_activations_s4(xf.to(d) - 1.5, 0.2),
        lambda d: ct.requantize_i8_to_u4s(x8.to(d), 0.013, 0.013 * 127 / 15),
        lambda d: ct.requantize_u4s_to_i8(x4.to(d), 0.013 * 127 / 15, 0.013),
    ]
    for k, call in enumerate(calls):
        got, want = call(cuda), call(torch.device("cpu"))
        assert got.device.type == cuda.type and got.dtype == want.dtype, k
        assert torch.equal(got.cpu(), want), k


@pytest.mark.parametrize("phase_level0", [None, "int8"])
def test_int4_engine_on_the_card(cuda, phase_level0):
    """A narrow int4 engine (min_channels 16) on the card: 'pallas' (K3 on
    the int8 dec0_conv1, or the k x k kernel twice under int4-phase) equals
    'xla' at the int4 stages and in the logits."""
    from tpu_unet_torch.infer.quant import (QuantInference, add_concat_scales,
                                            calibrate, default_int4_names,
                                            default_quant_names, prepare_quant_params)

    cfg = ModelConfig(base_width=8, compute_dtype="bfloat16")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.rand((2, 188, 204, 1), generator=torch.Generator().manual_seed(1))
    scales = add_concat_scales(cfg, calibrate(model, x))
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, 16),
                              q4names=default_int4_names(cfg, 16))
    engines = {impl: QuantInference(qp, impl=impl, phase_level0=phase_level0, device=cuda)
               for impl in ("pallas", "xla")}
    before = conv3x3_fused.launches, conv_kxk_fused.launches
    logits = engines["pallas"].apply(x.to(cuda))
    got = conv3x3_fused.launches - before[0], conv_kxk_fused.launches - before[1]
    assert got == ((1, 0) if phase_level0 is None else (0, 2))
    assert torch.isfinite(logits).all() and torch.equal(logits, engines["xla"].apply(x.to(cuda)))
    for stage in ("enc1_conv2", "enc2_conv1", "pool2", "bottleneck_conv2", "dec3_conv1",
                  "dec1_conv2"):
        a = engines["pallas"].apply(x.to(cuda), stop_after=stage)
        assert a.dtype == torch.int8, stage
        assert torch.equal(a, engines["xla"].apply(x.to(cuda), stop_after=stage)), stage


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wgrad,dgrad", [("mm", "xla"), ("xla", "mm"), ("mm", "mm")])
def test_conv3x3_bias_matches_autograd_on_the_card(cuda, dtype, wgrad, dgrad):
    """conv3x3_bias on the card: the forward equals F.conv2d with the bias
    bit for bit; each gradient within 1e-4 of its norm of autograd's in f32
    (TF32 off), within 1e-2 in bf16 (one rounding against the library's)."""
    x, w, b = _inputs((2, 40, 44, 64), 32, dtype, cuda, seed=4)
    g = torch.randn((2, 38, 42, 32), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = conv_bwd.conv3x3_bias(*leaves, wgrad=wgrad, dgrad=dgrad)
    refs = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = torch.nn.functional.conv2d(refs[0].permute(0, 3, 1, 2), refs[1].permute(3, 2, 0, 1),
                                     refs[2]).permute(0, 2, 3, 1)
    assert torch.equal(y.detach(), ref.detach())
    y.backward(g)
    ref.backward(g)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for got, want in zip(leaves, refs):
        assert got.grad.dtype == dtype
        err = ((got.grad.float() - want.grad.float()).norm() / want.grad.float().norm()).item()
        assert err <= tol, err
