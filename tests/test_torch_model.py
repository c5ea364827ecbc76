"""The port's U-Net (tpu_unet_torch/models/unet.py) against the JAX U-Net:
the same weights, crossed through state_dict_from_jax_params, and the same
numpy input give the same logits on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_unet.config import ModelConfig as JaxModelConfig
from tpu_unet.models import UNet as JaxUNet
from tpu_unet.models import center_crop_or_pad as jax_crop
from tpu_unet_torch.convert import (load_reference_checkpoint,
                                    state_dict_from_jax_params,
                                    state_dict_from_reference)
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.models import UNet, center_crop_or_pad
from tests.test_convert import _random_reference_state_dict
from tests.test_parity_forward import _torch_oracle_forward


def numpy_params(jmodel, size, seed):
    """A JAX parameter tree of `jmodel` drawn with numpy: He-scaled kernels
    and nonzero biases."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 1)))

    def draw(path, s):
        if path[-1].key == "bias":
            return (rng.randn(*s.shape) * 0.1).astype(np.float32)
        fan_in = np.prod(s.shape[:-1])
        return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_config(cfg, cls=JaxModelConfig):
    """The JAX package's config built from the fields of the port's `cfg`
    (the two packages' config dataclasses have the same fields)."""
    return cls(**dataclasses.asdict(cfg))


def _jax_and_port(cfg, seed=0, size=188):
    x = np.random.RandomState(seed).rand(1, size, size, 1).astype(np.float32)
    jmodel = JaxUNet(jax_config(cfg))
    params = numpy_params(jmodel, size, seed)
    model = UNet(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    return x, jmodel, params, model


def _jax_logits(jmodel, params, x):
    return np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("skip_variant", ["paper", "parity"])
@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_logits_match_jax(conv_impl, skip_variant):
    cfg = ModelConfig(base_width=4, conv_impl=conv_impl,
                      skip_variant=skip_variant)
    x, jmodel, params, model = _jax_and_port(cfg)
    expected = _jax_logits(jmodel, params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == expected.shape == (1, 4, 4, 2)
    # JAX and torch sum f32 convs in other orders: rtol 1e-4.
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-5)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("cfg", [
    ModelConfig(base_width=4, upconv_impl="matmul"),
    ModelConfig(base_width=4, split_concat_conv=False),
    ModelConfig(base_width=2, depth=3, width_mult=2),
], ids=["matmul_upconv", "concat_conv", "depth3_wide"])
def test_logits_match_jax_variants(cfg):
    size = 188 if cfg.depth == 4 else 92
    x, jmodel, params, model = _jax_and_port(cfg, seed=1, size=size)
    expected = _jax_logits(jmodel, params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)


def test_bf16_pallas_logits_match_jax():
    """The port's bf16 'pallas' model against the JAX bf16 model (its XLA
    convs, which compute what the Pallas kernel computes, at a fraction of
    the interpret-mode cost)."""
    cfg = ModelConfig(base_width=4, compute_dtype="bfloat16")
    x, jmodel, params, _ = _jax_and_port(cfg, seed=2)
    model = UNet(dataclasses.replace(cfg, conv_impl="pallas"))
    model.load_state_dict(state_dict_from_jax_params(params))
    expected = _jax_logits(jmodel, params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # bf16 rounds at other places in the two frameworks: compare relative
    # to the logits' scale.
    scale = np.abs(expected).max()
    assert np.abs(got - expected).max() <= 5e-2 * scale


def test_reference_state_dict_loads_and_matches_oracle(tmp_path):
    sd = _random_reference_state_dict(seed=5)
    model = UNet(ModelConfig(skip_variant="parity"))
    model.load_state_dict(state_dict_from_reference(sd))
    assert torch.equal(model.enc0_conv1["weight"], sd["conv11c.weight"])
    assert torch.equal(model.up3["weight"], sd["upconv4.weight"])
    path = tmp_path / "ref.pth"
    torch.save(sd, path)
    loaded = load_reference_checkpoint(str(path))
    assert all(torch.equal(loaded[k], v)
               for k, v in state_dict_from_reference(sd).items())

    x = np.random.RandomState(0).rand(1, 1, 188, 188).astype(np.float32)
    with torch.no_grad():
        expected = _torch_oracle_forward(sd, torch.from_numpy(x))
        got = model(torch.from_numpy(x).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, expected, rtol=1e-4, atol=1e-5)


def test_reference_state_dict_missing_key_raises():
    sd = _random_reference_state_dict()
    del sd["finalconv.bias"]
    with pytest.raises(KeyError, match="finalconv.bias"):
        state_dict_from_reference(sd)


@pytest.mark.parametrize("hw,target,fill", [
    ((9, 12), (4, 7), 0),       # odd crop margins truncate toward zero
    ((4, 6), (9, 11), 0),       # pad
    ((4, 10), (7, 5), -8),      # pad one axis, crop the other, custom fill
])
def test_center_crop_or_pad_matches_jax(hw, target, fill):
    a = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    expected = np.asarray(jax_crop(jnp.asarray(a), target, fill=fill))
    got = center_crop_or_pad(torch.from_numpy(a), target, fill=fill).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("scheme", ["paper", "parity"])
def test_init_scheme_statistics(scheme):
    model = UNet(ModelConfig(init_scheme=scheme),
                 generator=torch.Generator().manual_seed(3))
    w = model.enc3_conv2["weight"]                      # fan_in 512, N 4608
    std = (2.0 / (9 * 512)) ** 0.5 if scheme == "paper" else 2.0 / 4608 ** 0.5
    assert abs(w.std().item() / std - 1) < 0.01
    b = model.enc3_conv2["bias"]
    if scheme == "paper":
        assert not b.any()
    else:
        bound = 1.0 / (9 * 512) ** 0.5
        assert b.abs().max().item() <= bound and b.abs().max().item() > 0.5 * bound
        first = model.enc0_conv1["weight"]
        assert abs(first.std().item() / 2 ** 0.5 - 1) < 0.1
    again = UNet(ModelConfig(init_scheme=scheme),
                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.head["weight"], model.head["weight"])


def test_rejects_invalid_input_size():
    model = UNet(ModelConfig(base_width=2))
    with pytest.raises(ValueError, match="not a valid U-Net input size"):
        model(torch.zeros(1, 190, 188, 1))


@pytest.mark.parametrize("field,value,item", [
    ("phase_level0", True, "item 8"),
    ("conv_bwd", "auto", "item 13"),
    ("conv_bwd", "mm", "item 13"),
])
def test_unported_options_raise(field, value, item):
    """The options the port once lacked (`item`: the ROADMAP queue-1 item
    that ported them) build. conv_bwd 'mm'/'auto' give the 'xla' model's
    logits from the same weights bit for bit (only the backward changes;
    tests/test_torch_conv_bwd.py holds the gradients), and an unknown value
    raises as JAX's does; phase_level0 builds under conv_impl='xla', gives
    the plain model's logits, and refuses 'pallas' as JAX does."""
    cfg = ModelConfig(base_width=2, **{field: value})
    if field != "phase_level0":
        model, plain = UNet(cfg), UNet(dataclasses.replace(cfg, conv_bwd="xla"))
        plain.load_state_dict(model.state_dict())
        x = torch.from_numpy(np.random.RandomState(0).rand(1, 188, 188, 1).astype(np.float32))
        assert torch.equal(model(x), plain(x))
        with pytest.raises(ValueError, match="conv_bwd must be"):
            UNet(dataclasses.replace(cfg, conv_bwd="pallas"))
        return
    model, plain = UNet(cfg), UNet(dataclasses.replace(cfg, phase_level0=False))
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 188, 188, 1).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), plain(x), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="phase_level0"):
        UNet(dataclasses.replace(cfg, conv_impl="pallas"))


@pytest.mark.parametrize("field,value", [
    ("skip_variant", "other"), ("init_scheme", "other"),
    ("conv_impl", "other"), ("upconv_impl", "other"),
    ("compute_dtype", "float16"), ("conv_bwd", "other"),
])
def test_bad_config_values_raise(field, value):
    with pytest.raises(ValueError):
        UNet(ModelConfig(base_width=2, **{field: value}))
