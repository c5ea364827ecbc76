"""The port's pairing copies (tpu_unet_torch/ops/interleave.py: K6a
`pair_batch_channels`, K6b `unpair_batch_channels`, K6c `interleave_pairs`)
against the JAX package's Pallas kernels in interpret mode, bit for bit, at
seeded random shapes. On the CPU the wrappers run their plain versions; the
CUDA kernel is held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.ops import interleave as jil
from tpu_unet_torch.ops import interleave as til

DTYPES = {"int8": (np.int8, jnp.int8, torch.int8),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "f32": (np.float32, jnp.float32, torch.float32)}


def _pair(rng, shape, kind):
    """The same values as a JAX array and a torch tensor of dtype `kind`."""
    np_dt, jdt, tdt = DTYPES[kind]
    a = rng.randint(-120, 120, shape).astype(np_dt)
    if kind != "int8":
        a = a * np.float32(0.37)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _same(got, want):
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(
        (got.float() if got.dtype == torch.bfloat16 else got).numpy(),
        np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16 else want))


def _shape(rng, c2_even=False):
    """A seeded random [B, H, W, C] with even B (and even C if asked)."""
    b = 2 * rng.randint(1, 4)
    c = rng.randint(1, 20) * (2 if c2_even else 1)
    return (b, rng.randint(1, 9), rng.randint(1, 13), c)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("seed", range(3))
def test_pair_and_unpair_match_jax(kind, seed):
    rng = np.random.RandomState(seed)
    jx, tx = _pair(rng, _shape(rng), kind)
    jp = jil.pair_batch_channels(jx, interpret=True)
    tp = til.pair_batch_channels(tx)
    assert tp.dtype == tx.dtype
    _same(tp, jp)
    _same(til.unpair_batch_channels(tp), jil.unpair_batch_channels(jp, interpret=True))
    assert torch.equal(til.unpair_batch_channels(tp), tx)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("seed", range(3))
def test_interleave_pairs_matches_jax(kind, seed):
    rng = np.random.RandomState(10 + seed)
    shape = _shape(rng, c2_even=True)
    (ja, ta), (jb, tb) = _pair(rng, shape, kind), _pair(rng, shape, kind)
    got = til.interleave_pairs(ta, tb)
    _same(got, jil.interleave_pairs(ja, jb, interpret=True))
    # each image's half is its own concat([a_img, b_img], -1)
    c = shape[3] // 2
    for half in range(2):
        s = slice(half * c, (half + 1) * c)
        assert torch.equal(got[..., 2 * half * c:2 * (half + 1) * c],
                           torch.cat([ta[..., s], tb[..., s]], -1))


def test_pair_path_shapes_and_views():
    """The research forward's uses at a small size: pair of the int8 upconv
    output, interleave with a center-cropped (strided) paired skip, unpair of
    the pooled map; each equal to JAX's on contiguous copies."""
    rng = np.random.RandomState(3)
    ju, tu = _pair(rng, (4, 6, 6, 8), "int8")
    jsk, tsk = _pair(rng, (2, 10, 10, 16), "int8")
    tview = tsk[:, 2:8, 2:8]
    assert not tview.is_contiguous()
    got = til.interleave_pairs(tview, til.pair_batch_channels(tu))
    want = jil.interleave_pairs(jsk[:, 2:8, 2:8], jil.pair_batch_channels(ju, interpret=True),
                                interpret=True)
    _same(got, want)
    assert til._packed(tview) is tview                 # read in place on the card
    assert til._packed(tu.transpose(1, 2)).is_contiguous()
    assert til.pair_batch_channels.launches == til.interleave_pairs.launches == 0


def test_shape_checks_match_jax():
    """Odd batch (pair), odd channel count (unpair, interleave), unequal
    shapes (interleave): JAX asserts, the port raises ValueError."""
    x = np.zeros((3, 4, 5, 6), np.float32)
    y = np.zeros((2, 4, 5, 7), np.float32)
    cases = [(jil.pair_batch_channels, til.pair_batch_channels, (x,)),
             (jil.unpair_batch_channels, til.unpair_batch_channels, (y,)),
             (jil.interleave_pairs, til.interleave_pairs, (y, y)),
             (jil.interleave_pairs, til.interleave_pairs, (x[:2], x[:2, :3]))]
    for jfn, tfn, args in cases:
        with pytest.raises(AssertionError):
            jfn(*(jnp.asarray(a) for a in args), interpret=True)
        with pytest.raises(ValueError):
            tfn(*(torch.from_numpy(a) for a in args))
    with pytest.raises(TypeError):
        til.interleave_pairs(torch.zeros((1, 2, 2, 4)), torch.zeros((1, 2, 2, 4),
                                                                    dtype=torch.int8))
