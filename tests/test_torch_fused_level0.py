"""The port's fused level-0 kernels (tpu_unet_torch/ops/fused_level0.py: K4
`enc0_chain`, K5 `concat_quantize`) against the JAX package's Pallas kernels
in interpret mode, on the same seeded numpy inputs. On the CPU the wrappers
run their plain versions; the CUDA kernels are held to those on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.ops import fused_level0 as jfl
from tpu_unet_torch.ops import fused_level0 as tfl


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _enc0_inputs(seed, shape, c):
    """x, w1, b1, w2, b2 as numpy f32; x in [0, 1)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape, 1).astype(np.float32),
            (rng.randn(3, 3, 1, c) * 0.5).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(3, 3, c, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def _torch_args(args, bf16_inputs):
    """x, w1, w2 in bf16 as the research forward passes them (`bf16_inputs`),
    or in f32; the biases in f32."""
    tdt = torch.bfloat16 if bf16_inputs else torch.float32
    return [torch.from_numpy(a).to(tdt if k in (0, 1, 3) else torch.float32)
            for k, a in enumerate(args)]


def _run_both(args, bf16_inputs, **kw):
    """(JAX's Pallas kernel in interpret mode, the port's wrapper on the CPU)
    on the same values."""
    targs = _torch_args(args, bf16_inputs)
    want = jfl.enc0_chain(*(jnp.asarray(t.float().numpy(), jnp.bfloat16
                                        if t.dtype == torch.bfloat16 else jnp.float32)
                            for t in targs), interpret=True, **kw)
    return want, tfl.enc0_chain(*targs, **kw)


def _assert_last_bit(got, want):
    """Equal but for at most 1e-3 of the values, each off by one bf16 ulp
    (a bf16 map) or by 1 (an int8 skip). The plain version sums conv1's 9
    and conv2's 9C f32 products in PyTorch's conv order, the Pallas kernel in
    its dots' order; a last-bit f32 difference flips a bf16 rounding or an
    int8 rint now and then (2 values in 40960 at most in these cases)."""
    g, w = _np(got).astype(np.float64), _jnp(want).astype(np.float64)
    assert g.shape == w.shape
    off = g != w
    assert off.mean() <= 1e-3, f"{off.sum()} of {off.size} values differ"
    if got.dtype == torch.int8:
        assert np.abs(g - w).max() <= 1
    else:
        assert (np.abs(g - w) <= 2 ** -7 * np.maximum(np.abs(g), np.abs(w))).all()


def _skip_scale(args, bf16_inputs):
    """A scale that spreads the int8 skip over [0, 127]."""
    skip, _ = tfl.enc0_chain_plain(*_torch_args(args, bf16_inputs))
    return float(skip.float().max()) / 110.0


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("skip_kind,pool_mode", [("bf16", "fused"), ("bf16", "cols"),
                                                 ("bf16", "none"), ("int8", "fused"),
                                                 ("int8", "cols")])
def test_enc0_chain_matches_jax(c, skip_kind, pool_mode):
    """bf16 x and weights, as the research forward runs it: the skip (bf16,
    or int8 from the f32 h2) and the pooled map equal the Pallas kernel's
    but for a last-bit flip (`_assert_last_bit`), in every pool mode."""
    args = _enc0_inputs(c, (2, 36, 44), c)
    scale = _skip_scale(args, True) if skip_kind == "int8" else 0.0
    (jskip, jpool), (skip, pooled) = _run_both(args, True, skip_scale=scale,
                                               pool_mode=pool_mode)
    assert skip.shape == (2, 32, 40, c) and pooled.shape == (2, 16, 20, c)
    assert skip.dtype == (torch.int8 if scale else torch.bfloat16)
    assert pooled.dtype == torch.bfloat16
    _assert_last_bit(skip, jskip)
    _assert_last_bit(pooled, jpool)
    if scale:
        q = _np(skip)
        assert q.min() >= 0 and q.max() <= 127 and 0.05 < (q > 0).mean() < 1


@pytest.mark.parametrize("skip_kind", ["bf16", "int8"])
def test_enc0_chain_ragged_and_f32_match_jax(skip_kind):
    """H - 4 not a multiple of block_rows and W - 4 not of 16 (the JAX
    kernel pads, the port computes only the output), with f32 x and weights,
    at `_assert_last_bit`."""
    args = _enc0_inputs(7, (1, 26, 30), 8)
    scale = _skip_scale(args, False) if skip_kind == "int8" else 0.0
    (jskip, jpool), (skip, pooled) = _run_both(args, False, skip_scale=scale, block_rows=8)
    assert skip.shape == (1, 22, 26, 8) and pooled.shape == (1, 11, 13, 8)
    _assert_last_bit(skip, jskip)
    _assert_last_bit(pooled, jpool)


def test_enc0_chain_plain_is_the_unfused_chain():
    """The plain version is two convs, ReLU and the pool: with f32 inputs
    its bf16 skip is the f32 chain rounded once, and its pooled map the
    pool of that chain."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _enc0_inputs(3, (1, 20, 24), 8))
    skip, pooled = tfl.enc0_chain_plain(x, w1, b1, w2, b2)
    h1 = torch.relu(torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1),
                                               b1)).to(torch.bfloat16).float()
    h2 = torch.relu(torch.nn.functional.conv2d(h1, w2.to(torch.bfloat16).float()
                                               .permute(3, 2, 0, 1), b2))
    torch.testing.assert_close(skip.float(), h2.permute(0, 2, 3, 1).to(torch.bfloat16).float(),
                               rtol=2 ** -8, atol=1e-6)
    torch.testing.assert_close(pooled, torch.nn.functional.max_pool2d(h2, 2).permute(
        0, 2, 3, 1).to(torch.bfloat16), rtol=2 ** -8, atol=1e-6)
    assert tfl.enc0_chain.launches == 0                # CPU calls don't count


@pytest.mark.parametrize("change,kw", [
    ("cin", {}), ("odd_h", {}), ("odd_w", {}),
    (None, {"block_rows": 7}), (None, {"block_cols": 24}),
])
def test_enc0_chain_refuses_what_jax_refuses(change, kw):
    """The JAX function's asserts are ValueErrors in the port, on the same
    inputs."""
    x, w1, b1, w2, b2 = _enc0_inputs(1, (1, 20, 24), 8)
    if change == "cin":
        x = np.concatenate([x, x], -1)
    elif change == "odd_h":
        x = x[:, :19]
    elif change == "odd_w":
        x = x[:, :, :23]
    with pytest.raises(AssertionError):
        jfl.enc0_chain(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                       jnp.asarray(b2), interpret=True, **kw)
    with pytest.raises(ValueError):
        tfl.enc0_chain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)), **kw)


def test_enc0_chain_refuses_pooling_the_quantized_skip():
    """pool_mode='none' with an int8 skip: the JAX function pools the
    quantized integers (a map in units of 1/skip_scale); the port raises.
    It also names an unknown pool_mode, which JAX takes as 'fused'; and the
    weights' shapes."""
    args = [torch.from_numpy(a) for a in _enc0_inputs(2, (1, 20, 24), 8)]
    with pytest.raises(ValueError, match="quantized skip"):
        tfl.enc0_chain(*args, skip_scale=0.05, pool_mode="none")
    with pytest.raises(ValueError, match="pool_mode"):
        tfl.enc0_chain(*args, pool_mode="rows")
    x, w1, b1, w2, b2 = args
    with pytest.raises(ValueError, match="w2"):
        tfl.enc0_chain(x, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError, match="b1"):
        tfl.enc0_chain(x, w1, b1[:4], w2, b2)
    # the bf16 skip pools the same in every mode
    outs = [tfl.enc0_chain(*args, pool_mode=m) for m in ("fused", "cols", "none")]
    for skip, pooled in outs[1:]:
        assert torch.equal(skip, outs[0][0]) and torch.equal(pooled, outs[0][1])


# --- K5 ---------------------------------------------------------------------

def _halves(seed, shape, kinds, scale):
    """Two halves in [-1.3, 1.3] x 127 x scale (some past the int8 range), in
    the kinds asked for: 'int8' (quantized at `scale`), 'bf16' or 'f32'; a
    few values on rounding boundaries."""
    rng = np.random.RandomState(seed)
    out = []
    for kind in kinds:
        v = ((rng.rand(*shape) * 2.6 - 1.3) * 127 * scale).astype(np.float32)
        v.reshape(-1)[:4] = np.array([0.5, 1.5, -2.5, 126.5], np.float32) * scale
        if kind == "int8":
            out.append(np.clip(np.round(v / scale), -127, 127).astype(np.int8))
        else:
            out.append(v)
    return out


def _to(a, kind, lib):
    if lib == "jax":
        return jnp.asarray(a, {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[kind])
    return torch.from_numpy(a).to({"int8": torch.int8, "bf16": torch.bfloat16,
                                   "f32": torch.float32}[kind])


@pytest.mark.parametrize("kinds", [("int8", "bf16"), ("bf16", "bf16"), ("bf16", "int8"),
                                   ("f32", "int8")])
@pytest.mark.parametrize("c", [16, 24])
def test_concat_quantize_matches_jax_bit_for_bit(kinds, c):
    """The skip || upconv concat + requantize: int8 halves pass through,
    float halves are rounded to bf16 and multiplied by f32(1/scale), at
    three scales; C a multiple of 16 and not."""
    for scale in (0.03, 1 / 127, 0.37):
        a, b = _halves(c, (2, 7, 9, c), kinds, scale)
        want = jfl.concat_quantize(_to(a, kinds[0], "jax"), _to(b, kinds[1], "jax"), scale,
                                   interpret=True)
        got = tfl.concat_quantize(_to(a, kinds[0], "torch"), _to(b, kinds[1], "torch"), scale)
        assert got.dtype == torch.int8 and got.shape == (2, 7, 9, 2 * c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.min() == -127 and got.max() == 127    # both clamps reached
    assert tfl.concat_quantize.launches == 0


def test_concat_quantize_takes_a_cropped_skip():
    """The caller's center-cropped int8 skip (a strided view) and the bf16
    upconv output: the same as on contiguous copies, and as JAX's."""
    scale = 0.05
    big, u = _halves(5, (2, 12, 14, 16), ("int8", "bf16"), scale)
    sk = torch.from_numpy(big)[:, 2:9, 3:12]
    assert not sk.is_contiguous()
    got = tfl.concat_quantize(sk, _to(u[:, :7, :9], "bf16", "torch"), scale)
    want = jfl.concat_quantize(jnp.asarray(big[:, 2:9, 3:12]),
                               jnp.asarray(u[:, :7, :9], jnp.bfloat16), scale, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="equal"):
        tfl.concat_quantize(sk, sk[:, :6], scale)
