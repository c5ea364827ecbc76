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

import jax
import jax.numpy as jnp

from tpu_unet.ops.edt import _row_distance as jax_row_distance
from tpu_unet.ops.edt import edt as jax_edt
from tpu_unet.ops.edt import edt_batch as jax_edt_batch
from tpu_unet.ops.edt_pallas import column_pass_pallas
from tpu_unet_torch.ops.edt import _row_distance, edt, edt_batch
from tpu_unet_torch.ops.edt_pallas import column_pass, column_pass_plain


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
