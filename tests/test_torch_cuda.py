"""The port's CUDA kernel on the card. These tests import no JAX (the
machine with the card has none) and skip without a CUDA device. Run them on
the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from tpu_unet_torch.models import ModelConfig, UNet
from tpu_unet_torch.ops.conv_pallas import (conv3x3_bias_relu,
                                            conv3x3_bias_relu_plain)

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
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="no backward"):
            conv3x3_bias_relu(x, w.requires_grad_(), b)


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
