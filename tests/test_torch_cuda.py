"""The port's CUDA kernels on the card: K1 (fused 3x3 conv + bias + ReLU)
and its gradient, and K2 (the EDT column pass). These tests import no JAX
(the machine with the card has none) and skip without a CUDA device. Run
them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from tpu_unet_torch.models import ModelConfig, UNet
from tpu_unet_torch.ops.conv_pallas import (conv3x3_bias_relu,
                                            conv3x3_bias_relu_plain)
from tpu_unet_torch.ops.edt_pallas import column_pass, column_pass_plain

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


def _g2(shape, seed, device):
    """Squared row distances of random blob masks: integers and +inf."""
    from tpu_unet_torch.ops.edt import _row_distance, _squared

    g = torch.Generator(device=device).manual_seed(seed)
    masks = torch.rand(shape, generator=g, device=device) < 0.02
    return _squared(_row_distance(masks)).contiguous()


@pytest.mark.parametrize("shape,num_valid", [
    ((2, 32, 388, 388), [5, 0]),
    ((3, 70, 45), None),          # H, W not multiples of the tile
    ((2, 30, 100), None),         # H < band
    ((1, 4, 1, 37), [2]),         # one-row planes
    ((5, 64, 33), 3),
])
@pytest.mark.parametrize("band", [40, None])
def test_column_pass_kernel_is_bit_exact(cuda, shape, num_valid, band):
    g2 = _g2(shape, 0, cuda)
    g2.view(-1, *shape[-2:])[0] = float("inf")   # an all-+inf plane
    if isinstance(num_valid, list):
        num_valid = torch.tensor(num_valid, dtype=torch.int32, device=cuda)
    before = column_pass.launches
    got = column_pass(g2, num_valid=num_valid, band=band)
    assert column_pass.launches == before + 1
    ref = column_pass_plain(g2, num_valid=num_valid, band=band)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    assert torch.equal(got, ref)


def test_column_pass_refuses_what_it_does_not_take(cuda):
    g2 = _g2((2, 8, 9), 1, cuda)
    with pytest.raises(TypeError):
        column_pass(g2.double())
    with pytest.raises(ValueError, match="contiguous"):
        column_pass(g2.transpose(1, 2))
    with pytest.raises(ValueError):
        column_pass(g2[None], num_valid=torch.tensor([1], dtype=torch.int32))
