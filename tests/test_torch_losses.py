"""The port's losses and weight maps (tpu_unet_torch/losses/, ops/cc.py)
against the JAX package on the same numpy inputs: the weighted BCE, the
connected components and their planes, `class_balance` and the HeLa
distance map `weighted_map` at 388^2 with 32 object planes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.losses.bce import weighted_bce_with_logits as jax_bce
from tpu_unet.losses.weights import class_balance as jax_class_balance
from tpu_unet.losses.weights import make_weight_fn as jax_make_weight_fn
from tpu_unet.losses.weights import weighted_map as jax_weighted_map
from tpu_unet.ops.cc import component_planes as jax_component_planes
from tpu_unet.ops.cc import connected_components as jax_cc
from tpu_unet_torch.losses.bce import one_hot_targets, weighted_bce_with_logits
from tpu_unet_torch.losses.weights import class_balance, make_weight_fn, weighted_map
from tpu_unet_torch.ops.cc import component_planes, connected_components


def _blob_labels(b, h, w, n_blobs, seed=0):
    rng = np.random.RandomState(seed)
    out = np.zeros((b, h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for bi in range(b):
        for _ in range(n_blobs):
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            ry, rx = rng.randint(3, max(4, h // 8)), rng.randint(3, max(4, w // 8))
            out[bi][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1
    return out


def _spiral():
    mask = np.zeros((32, 32), bool)
    mask[0, :] = True
    mask[:, -1] = True
    mask[-1, :] = True
    mask[2:, 0] = True
    mask[2, 1:-2] = True
    return mask


# ------------------------------------------------------------------- BCE


@pytest.mark.parametrize("reduction", ["mean", "per_sample"])
@pytest.mark.parametrize("broadcast", ["intended", "parity"])
def test_weighted_bce_matches_jax(broadcast, reduction):
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 16, 16, 2) * 3).astype(np.float32)
    labels = (rng.rand(2, 16, 16) < 0.4).astype(np.int32)
    weights = (rng.rand(2, 16, 16) * 5).astype(np.float32)
    expected = np.asarray(jax_bce(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(weights), broadcast, reduction))
    got = weighted_bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(weights), broadcast, reduction)
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6)


def test_bce_rejects_bad_modes():
    args = (torch.zeros(3, 4, 4, 2), torch.zeros(3, 4, 4, dtype=torch.int32),
            torch.ones(3, 4, 4))
    with pytest.raises(ValueError, match="batch == num_classes"):
        weighted_bce_with_logits(*args, broadcast="parity")
    with pytest.raises(ValueError, match="broadcast"):
        weighted_bce_with_logits(*args, broadcast="other")
    with pytest.raises(ValueError, match="reduction"):
        weighted_bce_with_logits(*args, reduction="sum")
    y = one_hot_targets(torch.tensor([[[0, 1]]]))
    assert y.tolist() == [[[[1.0, 0.0], [0.0, 1.0]]]]


# ----------------------------------------------------- connected components


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_component_labels_equal_jax(seed):
    mask = _blob_labels(1, 48, 56, 6, seed)[0].astype(bool)
    expected = np.asarray(jax_cc(jnp.asarray(mask)))
    got = connected_components(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, expected)


def test_connected_components_spiral_and_batch():
    """The spiral's long geodesic needs many sweeps; a batch of masks
    labels each mask on its own."""
    masks = np.stack([_spiral(), _blob_labels(1, 32, 32, 4, 5)[0].astype(bool),
                      np.zeros((32, 32), bool)])
    got = connected_components(torch.from_numpy(masks)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[k], np.asarray(jax_cc(jnp.asarray(masks[k]))))
    assert (got[0][masks[0]] == 0).all()


@pytest.mark.parametrize("max_objects", [4, 32])
def test_component_planes_equal_jax(max_objects):
    masks = _blob_labels(3, 40, 40, 8, 7).astype(bool)
    planes, num = component_planes(torch.from_numpy(masks), max_objects)
    assert planes.shape == (3, max_objects, 40, 40) and num.dtype == torch.int32
    for b in range(3):
        jp, jn = jax_component_planes(jnp.asarray(masks[b]), max_objects)
        np.testing.assert_array_equal(planes[b].numpy(), np.asarray(jp))
        assert int(num[b]) == int(jn)


# ------------------------------------------------------------ weight maps


def _compare_maps(got, expected):
    """rtol 1e-6; atol 1e-12 for the far tails of the border term (values
    near 1e-14 under `parity_int_wc`, where XLA's and torch's CPU exp differ
    in the last bits)."""
    assert got.dtype == torch.float32 and tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("parity_int_wc", [False, True])
def test_weighted_map_matches_jax_at_388(parity_int_wc):
    """The DIC-HeLa map at its training crop, 32 object planes, band 40."""
    gt = _blob_labels(2, 388, 388, 14, 3)
    expected = np.asarray(jax_weighted_map(jnp.asarray(gt), max_objects=32,
                                           parity_int_wc=parity_int_wc))
    got = weighted_map(torch.from_numpy(gt), max_objects=32,
                       parity_int_wc=parity_int_wc)
    _compare_maps(got, expected)
    assert got.max() > 2.0            # the border term is live


def test_weighted_map_edge_cases_match_jax():
    """Exact column pass (edt_band=None); an empty map, a single object
    (d2 = 0), an all-cell map, and more objects than planes."""
    gt = np.zeros((4, 60, 60), np.int32)
    gt[1, 20:30, 25:40] = 1
    gt[2] = 1
    gt[3] = _blob_labels(1, 60, 60, 12, 9)[0]
    for band in (None, 40):
        fn = jax_make_weight_fn("distance", max_objects=3, edt_band=band)
        expected = np.asarray(fn(jnp.asarray(gt)))
        got = make_weight_fn("distance", max_objects=3, edt_band=band)(
            torch.from_numpy(gt))
        _compare_maps(got, expected)
    assert (got[0] == 1).all() and (got[2] == 1).all()


def test_class_balance_matches_jax():
    gt = _blob_labels(3, 64, 48, 5, 11)
    gt[2] = 0
    expected = np.asarray(jax_class_balance(jnp.asarray(gt)))
    _compare_maps(class_balance(torch.from_numpy(gt)), expected)
    assert make_weight_fn("class_balance") is class_balance
    with pytest.raises(ValueError):
        make_weight_fn("other")
