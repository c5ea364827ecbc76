"""The port's EDT (tpu_unet_torch/ops/edt.py) and the plain version of its
column-pass kernel K2 (tpu_unet_torch/ops/edt_pallas.py) against the JAX
package: the Pallas kernel run in interpret mode, as tests/test_edt_pallas.py
runs it, and the scan twins. Every value is an integer below 2^24 or +inf,
so the column pass is compared for exact equality.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is held
against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from tpu_unet.ops.edt import _row_distance as jax_row_distance
from tpu_unet.ops.edt import edt as jax_edt
from tpu_unet.ops.edt import edt_batch as jax_edt_batch
from tpu_unet.ops.edt_pallas import column_pass_pallas
from tpu_unet_torch.ops.edt import _row_distance, _squared, edt, edt_batch
from tpu_unet_torch.ops.edt_pallas import (_column_pass_route_forward, column_pass,
                                           column_pass_plain)


def _blobs(h, w, n, seed):
    rng = np.random.RandomState(seed)
    m = np.zeros((h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(1, 6)
        m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = True
    return m


def _g2(masks):
    """Squared row distances from the JAX package (+inf where a row is
    empty), as numpy."""
    g = np.asarray(jax.vmap(jax_row_distance)(jnp.asarray(masks)))
    return np.where(np.isinf(g), np.inf, g * g).astype(np.float32)


def _planes(n, h, w, seed, empty=1):
    return np.stack([_blobs(h, w, 1 + k % 3, seed + k) for k in range(n - empty)]
                    + [np.zeros((h, w), bool)] * empty)


@pytest.mark.parametrize("h,w", [(40, 48), (23, 37), (1, 19)])
def test_row_distance_matches_jax(h, w):
    masks = _planes(3, h, w, 0)
    expected = np.asarray(jax.vmap(jax_row_distance)(jnp.asarray(masks)))
    got = _row_distance(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("band", [None, 40, 5])
@pytest.mark.parametrize("num_valid", [None, 2])
def test_column_pass_plain_equals_pallas_interpret(band, num_valid):
    g2 = _g2(_planes(4, 44, 52, 1))
    expected = np.asarray(column_pass_pallas(
        jnp.asarray(g2), num_valid=num_valid, band=band, interpret=True))
    got = column_pass(torch.from_numpy(g2), num_valid=num_valid, band=band).numpy()
    np.testing.assert_array_equal(got, expected)
    if num_valid is not None:
        assert np.isinf(got[num_valid:]).all()


@pytest.mark.parametrize("band", [None, 40])
def test_column_pass_under_a_batch_dimension_matches_vmap(band):
    """Leading batch dims with per-entry `num_valid`, as `weighted_map`
    calls it, against the Pallas kernel under `jax.vmap`."""
    g2 = np.stack([_g2(_planes(3, 30, 26, 10 * s, empty=s % 2)) for s in range(3)])
    nums = np.array([3, 1, 0], np.int32)
    fn = jax.vmap(lambda g, n: column_pass_pallas(g, num_valid=n, band=band,
                                                  interpret=True))
    expected = np.asarray(fn(jnp.asarray(g2), jnp.asarray(nums)))
    got = column_pass(torch.from_numpy(g2), num_valid=torch.from_numpy(nums),
                      band=band).numpy()
    np.testing.assert_array_equal(got, expected)
    assert np.isinf(got[2]).all() and np.isinf(got[1, 1:]).all()


def test_edt_batch_matches_jax_scan():
    """Through the square root: XLA's CPU sqrt is not always correctly
    rounded, so rtol 1e-6 (one f32 ulp is 6e-8) with equal +inf."""
    masks = _planes(3, 36, 40, 3)
    for band in (None, 12):
        expected = np.asarray(jax_edt_batch(jnp.asarray(masks), use_pallas=False,
                                            band=band))
        got = edt_batch(torch.from_numpy(masks), band=band).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(expected))
        np.testing.assert_allclose(got, expected, rtol=1e-6)
    m = _blobs(32, 32, 2, 3)
    np.testing.assert_allclose(edt(torch.from_numpy(m)).numpy(),
                               np.asarray(jax_edt(jnp.asarray(m))), rtol=1e-6)


def test_column_pass_rejects_bad_arguments():
    g2 = torch.zeros(2, 3, 4, 5)
    with pytest.raises(TypeError):
        column_pass(g2.double())
    with pytest.raises(ValueError, match="leading shape"):
        column_pass(g2, num_valid=torch.tensor([1, 1, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="band"):
        column_pass(g2, band=-1)
    with pytest.raises(ValueError):
        column_pass(torch.zeros(4, 5))
    before = column_pass.launches
    column_pass_plain(g2, num_valid=torch.tensor([1, 0], dtype=torch.int32))
    column_pass(g2)
    assert column_pass.launches == before      # CPU calls are not launches


def _bits_loop_model(g2, num_valid, band):
    """Route "sm90"'s loop in plain PyTorch: rows outside the plane
    staged as +inf, the f32 sum of each candidate over the offsets
    -band..band (the exact pass: every offset that reaches the plane), the
    minimum taken in int32 over the sums' bit patterns, read back as f32."""
    h = g2.shape[-2]
    reach = h - 1 if band is None else min(band, h)
    s = torch.nn.functional.pad(g2, (0, 0, reach, reach), value=float("inf"))
    acc = torch.full(g2.shape, float("inf")).view(torch.int32)
    for d in range(-reach, reach + 1):
        cand = s[..., reach + d:reach + d + h, :] + torch.tensor(float(d * d))
        acc = torch.minimum(cand.view(torch.int32), acc)
    out = acc.view(torch.float32)
    if num_valid is not None:
        k = torch.arange(g2.shape[-3])
        live = (k < torch.as_tensor(num_valid)[..., None])[..., None, None]
        out = torch.where(live, out, float("inf"))
    return out


@pytest.mark.parametrize("shape,num_valid", [
    ((2, 5, 44, 52), [3, 0]),       # random masks, dead planes
    ((1, 4, 1, 37), [2]),           # one-row planes
    ((3, 30, 26), None),            # H < band
    ((2, 3, 70, 45), None),
])
@pytest.mark.parametrize("band", [40, None])
def test_bits_loop_model_equals_plain_bit_for_bit(shape, num_valid, band):
    """Route "sm90"'s arithmetic (f32 sums, an int32 minimum over their bit
    patterns) equals the f32 plain version bit for bit on edt_batch's g2,
    an empty plane included; so do `column_pass` and both routes on the
    CPU."""
    rng = np.random.RandomState(sum(shape))
    masks = rng.rand(*shape) < 0.03
    masks.reshape(-1, *shape[-2:])[0] = False             # an empty plane
    g2 = _squared(_row_distance(torch.from_numpy(masks))).contiguous()
    nv = None if num_valid is None else torch.tensor(num_valid, dtype=torch.int32)
    ref = column_pass_plain(g2, num_valid=nv, band=band)
    assert torch.equal(_bits_loop_model(g2, nv, band), ref)
    assert torch.equal(column_pass(g2, num_valid=nv, band=band), ref)
    for route in ("sm90", "simple"):
        assert torch.equal(_column_pass_route_forward(g2, nv, band, route), ref)
    with pytest.raises(ValueError, match="no route"):
        _column_pass_route_forward(g2, nv, band, "fast")


@settings(max_examples=40, deadline=None, database=None)
@given(w=st.integers(1, 4096), seed=st.integers(0, 2 ** 31 - 1), hits=st.integers(0, 3))
def test_edt_batch_row_distances_fit_the_bits_loop(w, seed, hits):
    """The squared row distances edt_batch builds are what column_pass
    takes (its route "sm90" relies on it), for every W up to 4096: +0
    (never -0.0), positive or +inf, and every finite one an integer below
    2^24 (so exact in f32), the farthest included: one hit at a row's end
    leaves a distance of W - 1."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((3, w), bool)
    masks[0, 0] = True
    masks[1, rng.randint(0, w, hits)] = True
    g2 = _squared(_row_distance(torch.from_numpy(masks)))
    assert not torch.isnan(g2).any() and not torch.signbit(g2).any()
    fin = g2[torch.isfinite(g2)]
    assert torch.equal(fin, fin.round()) and float(fin.max()) == (w - 1) ** 2 < 2 ** 24
    assert torch.isinf(g2[2]).all()

