"""The port's warps (tpu_unet_torch/ops/warp.py) and augmentation
(tpu_unet_torch/data/augment.py) against the JAX package on the same numpy
inputs. JAX's random bits differ from torch's, so the random values of a
JAX key (crop id, jitter, angle, the two uniform fields) are recomputed
from that key's splits, as ``tpu_unet/data/augment.py::_augment_one`` draws
them, and fed to the port's deterministic core."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_unet.data import augment as jaug
from tpu_unet.data.synthetic import synthetic_dataset
from tpu_unet.ops import warp as jwarp
from tpu_unet_torch.config import AugmentConfig
from tpu_unet_torch.data import augment as taug
from tpu_unet_torch.ops import warp as twarp

TOL = 1e-5      # of the output's scale: f32 sums and trig in other orders


def _close(got, expected, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    assert got.shape == expected.shape
    scale = max(np.abs(expected).max(), 1.0)
    assert np.abs(got - expected).max() <= tol * scale


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("sigma", [1.5, 10.0])
def test_gaussian_filter_and_blur_matrix_match_jax(sigma):
    img = np.random.RandomState(0).rand(96, 80).astype(np.float32)
    np.testing.assert_array_equal(twarp.gaussian_blur_matrix(40, sigma).numpy(),
                                  np.asarray(jwarp.gaussian_blur_matrix(40, sigma)))
    _close(twarp.gaussian_filter(_t(img), sigma),
           jwarp.gaussian_filter(jnp.asarray(img), sigma))


def test_map_coordinates_match_jax():
    """Bilinear with scipy's hard fill (coordinates off the image, on its
    last row and column, and inside), and cubic one knot inside."""
    rng = np.random.RandomState(1)
    img = rng.rand(30, 40).astype(np.float32) * 255
    ci = rng.uniform(-3, 33, (50, 60)).astype(np.float32)
    cj = rng.uniform(-3, 43, (50, 60)).astype(np.float32)
    ci[0, :5] = 29.0
    cj[1, :5] = 39.0
    _close(twarp.map_coordinates_bilinear(_t(img), (_t(ci), _t(cj)), cval=-1.0),
           jwarp.map_coordinates_bilinear(jnp.asarray(img), (ci, cj), cval=-1.0))
    ci = rng.uniform(1, 28, (40, 40)).astype(np.float32)
    cj = rng.uniform(1, 38, (40, 40)).astype(np.float32)
    _close(twarp.map_coordinates_cubic(_t(img), (_t(ci), _t(cj))),
           jwarp.map_coordinates_cubic(jnp.asarray(img), (ci, cj)))
    np.testing.assert_allclose(twarp.spline_filter_matrix(17).numpy(),
                               np.asarray(jwarp.spline_filter_matrix(17)), rtol=1e-6)
    idx = np.arange(-9, 25)
    np.testing.assert_array_equal(twarp._mirror_index(_t(idx), 12).numpy(),
                                  np.asarray(jwarp._mirror_index(jnp.asarray(idx), 12)))
    t = rng.rand(7).astype(np.float32)
    for a, b in zip(twarp._bspline3_weights(_t(t)), jwarp._bspline3_weights(jnp.asarray(t))):
        _close(a, b)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("angle", [0.0, 30.0, 210.0])
def test_rotation_matches_jax(angle, order):
    img = np.random.RandomState(2).rand(48, 48).astype(np.float32)
    si, sj = twarp.rotation_coords(64, (48, 48), torch.tensor(angle))
    ji, jj = jwarp.rotation_coords(64, (48, 48), jnp.float32(angle))
    _close(si, ji)
    _close(sj, jj)
    _close(twarp.rotate_about_center(_t(img), torch.tensor(angle), 64, order=order),
           jwarp.rotate_about_center(jnp.asarray(img), jnp.float32(angle), 64,
                                     order=order))


def _jax_uniform_fields(key, shape):
    """The U(-1, 1) fields `tpu_unet/ops/warp.py::elastic_fields` draws."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, shape, jnp.float32, -1.0, 1.0)),
            np.asarray(jax.random.uniform(k2, shape, jnp.float32, -1.0, 1.0)))


def test_elastic_fields_and_warp_match_jax():
    key = jax.random.PRNGKey(3)
    jdx, jdy = jwarp.elastic_fields(key, (64, 72), 200.0, 10.0)
    u1, u2 = _jax_uniform_fields(key, (64, 72))
    dx, dy = twarp.elastic_fields((64, 72), 200.0, 10.0, u1=_t(u1), u2=_t(u2))
    _close(dx, jdx)
    _close(dy, jdy)
    img = np.random.RandomState(4).rand(64, 72).astype(np.float32)
    _close(twarp.elastic_warp(_t(img), dx, dy),
           jwarp.elastic_warp(jnp.asarray(img), jdx, jdy))
    g = torch.Generator().manual_seed(0)
    a, b = twarp.elastic_fields((64, 72), 200.0, 10.0, generator=g)
    assert a.shape == (64, 72) and not torch.equal(a, b)
    with pytest.raises(ValueError):
        twarp.elastic_fields((64, 72), 200.0, 10.0)


@pytest.mark.parametrize("order", [1, 3])
def test_fused_rotate_elastic_multi_matches_jax(order):
    rng = np.random.RandomState(5)
    src = (rng.rand(40, 40, 2) * 255).astype(np.float32)
    dx = (rng.randn(96, 96) * 6).astype(np.float32)
    dy = (rng.randn(96, 96) * 6).astype(np.float32)
    for angle in (0.0, 60.0, 330.0):
        _close(taug._fused_rotate_elastic_multi(_t(src), torch.tensor(angle), _t(dx),
                                                _t(dy), 96, order=order),
               jaug._fused_rotate_elastic_multi(jnp.asarray(src), jnp.float32(angle),
                                                jnp.asarray(dx), jnp.asarray(dy), 96,
                                                order=order))
    si = rng.uniform(0, 39, (20, 30)).astype(np.float32)
    sj = rng.uniform(0, 39, (20, 30)).astype(np.float32)
    _close(taug._bilinear_multi(_t(src), _t(si), _t(sj)),
           jaug._bilinear_multi(jnp.asarray(src), si, sj))
    _close(taug._cubic_multi(_t(src), _t(si), _t(sj)),
           jaug._cubic_multi(jnp.asarray(src), si, sj))


def _draws_from_key(key, log_probs, aug):
    """The values `_augment_one` draws from `key` (augment.py:188-206)."""
    k_crop, k_jit, k_rot, k_el = jax.random.split(key, 4)
    skip = aug.crop_grid_skip
    cid = jax.random.categorical(k_crop, jnp.asarray(log_probs))
    jitter = jax.random.randint(k_jit, (2,), -(skip // 2), skip // 2 + 1)
    angle = jax.random.randint(k_rot, (), 0, 360 // aug.rotate_step_deg) * aug.rotate_step_deg
    u1, u2 = _jax_uniform_fields(k_el, (aug.input_size, aug.input_size))
    return taug.AugmentDraws(torch.tensor(int(cid)), _t(np.asarray(jitter)).long(),
                             torch.tensor(float(angle)), _t(u1), _t(u2))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_one_matches_jax(fused, seed):
    """Image within 1e-4 of its scale; labels equal wherever the warped
    target lies more than 1e-4 of its scale (255) from the threshold."""
    aug = AugmentConfig(crop=64, fused_warp=fused)
    data = synthetic_dataset(n_images=2, h=160, w=160, crop=64, seed=4)
    kw = dict(crop=aug.crop, input_size=aug.input_size, alpha=aug.elastic_alpha,
              sigma=aug.elastic_sigma, fused_warp=fused)
    key = jax.random.PRNGKey(seed)
    j_inp, j_gt = jaug._augment_one(
        jnp.asarray(data.images[seed]), jnp.asarray(data.targets[seed]),
        jnp.asarray(data.crop_log_probs[seed]), key, pairs=jnp.asarray(data.crop_pairs),
        rotate_step=aug.rotate_step_deg, skip=aug.crop_grid_skip, **kw)
    draws = _draws_from_key(key, data.crop_log_probs[seed], aug)
    inp, gt = taug._augment_one(_t(data.images[seed]), _t(data.targets[seed]), draws,
                                pairs=_t(data.crop_pairs), **kw)
    assert inp.shape == (aug.input_size, aug.input_size, 1) and gt.dtype == torch.int32
    _close(inp, j_inp, tol=1e-4)

    # the port's warped target, to find the labels no rounding can flip
    origin = data.crop_pairs[int(draws.cid)] + draws.jitter.numpy()
    oy, ox = np.clip(origin, 0, 160 - 64)
    tgt = _t(data.targets[seed, oy:oy + 64, ox:ox + 64])
    dx, dy = twarp.elastic_fields((aug.input_size,) * 2, aug.elastic_alpha,
                                  aug.elastic_sigma, u1=draws.u1, u2=draws.u2)
    if fused:
        tw = taug._fused_rotate_elastic_multi(torch.stack([tgt, tgt], -1), draws.angle,
                                              dx, dy, aug.input_size)[..., 0]
    else:
        tw = twarp.elastic_warp(twarp.rotate_about_center(tgt, draws.angle,
                                                          aug.input_size), dx, dy)
    pad = (aug.input_size - 64) // 2
    tw = tw[pad:pad + 64, pad:pad + 64].numpy()
    decided = np.abs(tw - 127.0) > 1e-4 * 255
    np.testing.assert_array_equal(gt.numpy()[decided], np.asarray(j_gt)[decided])
    assert decided.mean() > 0.99


def test_pipeline_draws_are_reproducible():
    """A batch drawn twice from generators of one seed is the same batch;
    the crop draw never picks a -inf origin."""
    data = synthetic_dataset(n_images=3, h=120, w=120, crop=20, seed=6)
    pipe = taug.AugmentPipeline(AugmentConfig(crop=20))
    args = [_t(a) for a in (data.images, data.targets, data.crop_log_probs,
                            data.crop_pairs)]
    runs = [pipe(*args, np.array([2, 0]), torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert runs[0][0].shape == (2, 380, 380, 1) and runs[0][1].shape == (2, 20, 20)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    lp = torch.full((50,), float("-inf"))
    lp[[3, 17]] = 0.0
    g = torch.Generator().manual_seed(1)
    cids = {int(pipe.draw(g, lp).cid) for _ in range(40)}
    assert cids == {3, 17}
