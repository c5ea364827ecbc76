"""The port's matmul conv backward (tpu_unet_torch/ops/conv_bwd.py) against
the JAX package's (tpu_unet/ops/conv_bwd.py) on the CPU, given the same
numpy inputs: wgrad_mm and dgrad_mm at tests/test_conv_bwd.py's shapes and
tolerances, conv3x3_bias's gradients for the four (wgrad, dgrad) pairs, the
'auto' rule, and the model under conv_bwd 'mm' and 'auto': the 'xla'
model's logits bit for bit and its gradients."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpu_unet.ops import conv_bwd as jcb
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.models import UNet
from tpu_unet_torch.ops import conv_bwd as tcb

SHAPES = [(2, 12, 3, 8), (1, 9, 16, 4), (3, 7, 1, 5)]


def _draw(seed, b, s, cin, cout):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, s, cin).astype(np.float32),
            rng.randn(3, 3, cin, cout).astype(np.float32),
            rng.randn(b, s - 2, s - 2, cout).astype(np.float32))


@pytest.mark.parametrize("b,s,cin,cout", SHAPES)
def test_wgrad_mm_matches_jax(b, s, cin, cout):
    x, w, g = _draw(0, b, s, cin, cout)
    got = tcb.wgrad_mm(torch.from_numpy(g), torch.from_numpy(x))
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jcb.wgrad_mm(jnp.asarray(g),
                                                                    jnp.asarray(x))),
                               rtol=1e-5, atol=1e-4)
    auto = torch.nn.grad.conv2d_weight(torch.from_numpy(x).permute(0, 3, 1, 2),
                                       (cout, cin, 3, 3), torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), auto.permute(2, 3, 1, 0).numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,s,cin,cout", SHAPES)
def test_dgrad_mm_matches_jax(b, s, cin, cout):
    x, w, g = _draw(1, b, s, cin, cout)
    got = tcb.dgrad_mm(torch.from_numpy(g), torch.from_numpy(w))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jcb.dgrad_mm(jnp.asarray(g),
                                                                    jnp.asarray(w))),
                               rtol=1e-5, atol=1e-4)
    jy, vjp = jax.vjp(lambda x_: jcb.conv3x3_valid(x_, jnp.asarray(w)), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tcb.conv3x3_valid(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("wgrad,dgrad", [("xla", "xla"), ("mm", "xla"), ("xla", "mm"),
                                         ("mm", "mm")])
def test_conv3x3_bias_vjp_matches_jax(wgrad, dgrad):
    """The forward equals F.conv2d with the bias bit for bit; dx, dK, db
    equal JAX's custom VJP at its test's tolerances."""
    x, w, g = _draw(2, 2, 10, 6, 8)
    bias = np.random.RandomState(3).randn(8).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    y = tcb.conv3x3_bias(xt, wt, bt, wgrad=wgrad, dgrad=dgrad)
    plain = F.conv2d(xt.detach().permute(0, 3, 1, 2), wt.detach().permute(3, 2, 0, 1),
                     bt.detach()).permute(0, 2, 3, 1)
    assert torch.equal(y.detach(), plain)
    y.backward(torch.from_numpy(g))
    jy, vjp = jax.vjp(lambda x_, w_, b_: jcb.conv3x3_bias(x_, w_, b_, wgrad=wgrad, dgrad=dgrad),
                      jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for got, want in zip((xt.grad, wt.grad, bt.grad), vjp(jnp.asarray(g))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_bf16_gradients_round_once_to_the_primal_dtype():
    """Under bf16 the matmul gradients are bf16 products summed in f32 and
    rounded to bf16 once: dK equals the f32 sums of the same bf16 values,
    rounded; db is g's sum in g's dtype."""
    x, w, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _draw(4, 2, 11, 8, 16))
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    bt = torch.zeros(16, dtype=torch.bfloat16, requires_grad=True)
    tcb.conv3x3_bias(xt, wt, bt, wgrad="mm", dgrad="mm").backward(g)
    assert xt.grad.dtype == wt.grad.dtype == bt.grad.dtype == torch.bfloat16
    assert torch.equal(wt.grad, tcb.wgrad_mm(g.float(), x.float()).to(torch.bfloat16))
    assert torch.equal(xt.grad, tcb.dgrad_mm(g.float(), w.float()).to(torch.bfloat16))
    assert torch.equal(bt.grad, g.sum(dim=(0, 1, 2)))


@pytest.mark.parametrize("wgrad,dgrad", [("pallas", "xla"), ("mm", "cuda")])
def test_conv3x3_bias_rejects_unknown_impl(wgrad, dgrad):
    x, w, b = torch.zeros(1, 5, 5, 2), torch.zeros(3, 3, 2, 2), torch.zeros(2)
    with pytest.raises(ValueError, match="wgrad/dgrad must be 'xla' or 'mm'"):
        tcb.conv3x3_bias(x, w, b, wgrad=wgrad, dgrad=dgrad)
    with pytest.raises(ValueError):
        jcb.conv3x3_bias(jnp.zeros((1, 5, 5, 2)), jnp.zeros((3, 3, 2, 2)), jnp.zeros(2),
                         wgrad=wgrad, dgrad=dgrad)


def test_auto_rule_matches_jax():
    """At the 572^2 tile's layers (the cases tests/test_conv_bwd.py lists)
    and over a grid of input sizes and widths."""
    for in_hw, cin, want in [(572, 1, "mm"), (284, 64, "mm"), (282, 128, "mm"),
                             (570, 64, "xla"), (30, 1024, "xla"), (66, 512, "xla")]:
        assert tcb.auto_wgrad_impl(in_hw, cin) == want == jcb.auto_wgrad_impl(in_hw, cin)
    for in_hw in range(4, 700, 7):
        for cin in (1, 2, 4, 5, 8, 64, 128, 129, 256, 1024):
            assert tcb.auto_wgrad_impl(in_hw, cin) == jcb.auto_wgrad_impl(in_hw, cin)


def _grads(cfg, x, seed=1):
    model = UNet(cfg, generator=torch.Generator().manual_seed(seed))
    y = model(x)
    (y.float() ** 2).sum().backward()
    return y.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_bwd", ["mm", "auto"])
def test_model_grads_match_xla_backward(conv_bwd, dtype):
    """The 188^2 input at base width 4 ('auto' sends the three convs of
    Cin <= 4 to 'mm' at this size, 'mm' every plain conv): the logits
    of the 'xla' model bit for bit, every parameter gradient at
    tests/test_conv_bwd.py's tolerance in f32, and within 1e-2 of its norm
    in bf16."""
    cfg = ModelConfig(base_width=4, compute_dtype=dtype)
    x = torch.from_numpy(np.random.RandomState(5).rand(1, 188, 188, 1).astype(np.float32))
    y0, g0 = _grads(cfg, x)
    y1, g1 = _grads(dataclasses.replace(cfg, conv_bwd=conv_bwd), x)
    assert torch.equal(y1, y0)
    for name, want in g0.items():
        got = g1[name]
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-3,
                                       err_msg=name)
        else:
            assert (got - want).norm() <= 1e-2 * want.norm() + 1e-12, name


def test_routes_of_the_model_convs(monkeypatch):
    """Which convs take the matmul wgrad: under 'mm' every plain 3x3 conv
    and the concat-form decoder conv1s, under 'auto' those the rule picks
    at their input size; never the split-concat convs, the phase-packed
    level 0 or 'pallas' (as the JAX package's conv3 routes)."""
    seen = []
    real = tcb.conv3x3_bias
    monkeypatch.setattr("tpu_unet_torch.models.unet.conv3x3_bias",
                        lambda x, k, b, **kw: seen.append((x.shape[1], x.shape[-1]))
                        or real(x, k, b, **kw))
    x = torch.rand(1, 188, 188, 1)

    def routed(**kw):
        seen.clear()
        with torch.no_grad():
            UNet(ModelConfig(base_width=4, **kw))(x)
        return list(seen)

    plain = routed(conv_bwd="mm")
    assert len(plain) == 14                        # 18 - the 4 split-concat conv1s
    assert len(routed(conv_bwd="mm", split_concat_conv=False)) == 18
    assert len(routed(conv_bwd="mm", phase_level0=True)) == 11
    assert routed(conv_bwd="mm", conv_impl="pallas") == []
    auto = routed(conv_bwd="auto")
    assert auto == [s for s in plain if jcb.auto_wgrad_impl(*s) == "mm"]
    assert (188, 1) in auto and len(auto) < len(plain)


def test_remat_with_the_matmul_backward():
    """remat recomputes each encoder level in the backward: the same
    gradients as without it under conv_bwd='mm'."""
    cfg = ModelConfig(base_width=4, conv_bwd="mm")
    x = torch.from_numpy(np.random.RandomState(6).rand(1, 188, 188, 1).astype(np.float32))
    y0, g0 = _grads(cfg, x)
    y1, g1 = _grads(dataclasses.replace(cfg, remat=True), x)
    assert torch.equal(y1, y0)
    for name, want in g0.items():
        torch.testing.assert_close(g1[name], want, rtol=1e-5, atol=1e-6)
