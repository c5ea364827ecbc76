"""The port's phase packing (tpu_unet_torch/ops/phase.py) against the JAX
package's tpu_unet/ops/phase.py on the same numpy inputs, mirroring
tests/test_phase.py: the relabelings (space-to-depth, the packed kernels,
the pool, the crop) bit for bit, the packed float convs, upconv and head at
rtol 1e-4 (JAX and torch sum f32 in other orders), the packed int8 conv
exactly. Spatial sizes are drawn at random (even), per the ROADMAP's rule
for tiling and packing geometry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tpu_unet.ops import phase as jph
from tpu_unet_torch.ops import phase as tph

SEEDS = [0, 1, 2]


def _even_hw(rng, lo=4, hi=24):
    return tuple(2 * rng.randint(lo // 2, hi // 2 + 1) for _ in range(2))


def _conv3x3(x, w):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(x, w, (1, 1), "VALID", dimension_numbers=dn)


@pytest.mark.parametrize("seed", SEEDS)
def test_space_to_depth_roundtrip_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    p = tph.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jph.space_to_depth(jnp.asarray(x))))
    # phase-major: channel (p*2+q)*C + c holds pixel (2i+p, 2j+q, c)
    for pq in range(4):
        assert torch.equal(p[..., 3 * pq:3 * pq + 3],
                           torch.from_numpy(x[:, pq // 2::2, pq % 2::2]))
    assert torch.equal(tph.depth_to_space(p), torch.from_numpy(x))
    with pytest.raises(ValueError, match="even"):
        tph.space_to_depth(torch.zeros(1, h + 1, w, 1))
    with pytest.raises(ValueError, match="4"):
        tph.depth_to_space(torch.zeros(1, 2, 2, 6))


def test_pack_kernel_matches_jax_and_its_gradient_sums_the_placements():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 5, 7).astype(np.float32)
    want = jph.phase_pack_kernel(w)
    assert len(tph._PACK_PLACEMENTS) == 36
    assert tph._PACK_PLACEMENTS == jph._PACK_PLACEMENTS
    np.testing.assert_array_equal(tph.phase_pack_kernel(w), want)
    wt = torch.from_numpy(w).requires_grad_()
    packed = tph.phase_pack_kernel_torch(wt)
    np.testing.assert_array_equal(packed.detach().numpy(), want)
    g = rng.randn(*want.shape).astype(np.float32)
    (packed * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(jph.phase_pack_kernel_jnp, jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="3x3"):
        tph.phase_pack_kernel(np.zeros((2, 2, 1, 1)))


@pytest.mark.parametrize("seed", SEEDS)
def test_phase_pool_matches_jax_and_the_max_pool(seed):
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng)
    x = rng.randn(2, h, w, 8).astype(np.float32)
    xp = tph.space_to_depth(torch.from_numpy(x))
    got = tph.phase_pool(xp)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jph.phase_pool(jph.space_to_depth(jnp.asarray(x)))))
    ref = torch.from_numpy(x).reshape(2, h // 2, 2, w // 2, 2, 8).amax(dim=(2, 4))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ci,co", [(1, 8), (8, 8), (16, 4)])
def test_packed_conv_matches_jax_and_the_3x3_conv(seed, ci, co):
    """conv2x2(s2d(x), pack(k)) equals JAX's at rtol 1e-4 and s2d(conv3x3(x,
    k)); in bf16 the f32 sums of bf16 values, returned as f32."""
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng, lo=6)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, ci, co) * 0.3).astype(np.float32)
    want = np.asarray(jph.conv2x2_valid(jph.space_to_depth(jnp.asarray(x)),
                                        jnp.asarray(jph.phase_pack_kernel(k))))
    got = tph.conv2x2_valid(tph.space_to_depth(torch.from_numpy(x)),
                            torch.from_numpy(tph.phase_pack_kernel(k)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    full = np.asarray(jph.space_to_depth(_conv3x3(jnp.asarray(x), jnp.asarray(k))))
    np.testing.assert_allclose(got.numpy(), full, rtol=1e-4, atol=1e-5)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(jph.phase_pack_kernel(k), jnp.bfloat16)
    want = np.asarray(jph.conv2x2_valid(jph.space_to_depth(xb), kb, jnp.float32))
    got = tph.conv2x2_valid(tph.space_to_depth(torch.from_numpy(x).to(torch.bfloat16)),
                            torch.from_numpy(np.asarray(kb, np.float32)).to(torch.bfloat16),
                            torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_int8_conv_is_exact(seed):
    """int8 x int8 -> int32 through the library accumulate: the zero taps
    add nothing, so the packed conv equals JAX's packed conv and the 3x3
    conv bit for bit, and K3's plain version's sums."""
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng, lo=6)
    x = rng.randint(-127, 128, (2, h, w, 8)).astype(np.int8)
    k = rng.randint(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    kp = jph.phase_pack_kernel(k.astype(np.int32)).astype(np.int8)
    want = np.asarray(jph.conv2x2_valid(jph.space_to_depth(jnp.asarray(x)), jnp.asarray(kp),
                                        preferred=jnp.int32))
    got = tph.conv2x2_valid(tph.space_to_depth(torch.from_numpy(x)), torch.from_numpy(kp),
                            torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    full = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                      torch.from_numpy(k).double().permute(3, 2, 0, 1))
    assert torch.equal(got, tph.space_to_depth(full.permute(0, 2, 3, 1).to(torch.int32)))
    with pytest.raises(ValueError, match="int32"):
        tph.conv2x2_valid(torch.from_numpy(x), torch.from_numpy(kp[:, :, :8, :4]),
                          torch.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_phase_upconv_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng, lo=2, hi=12)
    x = rng.randn(2, h // 2, w // 2 + 1, 16).astype(np.float32)
    k = (rng.randn(2, 2, 16, 8) * 0.3).astype(np.float32)
    b = (rng.randn(8) * 0.1).astype(np.float32)
    m, bm = tph.phase_upconv_weights(k, b)
    jm, jbm = jph.phase_upconv_weights(k, b)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(bm, jbm)
    np.testing.assert_array_equal(tph.mirrored_upconv_matrix(torch.from_numpy(k)).numpy(), jm)
    assert not tph.phase_upconv_weights(k)[1].any()
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tph.phase_upconv_matmul(torch.from_numpy(x), torch.from_numpy(k),
                                      torch.from_numpy(b), dtype=dtype)
        want = jph.phase_upconv_matmul(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                       dtype=jdt)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-4 if dtype == torch.float32 else 2 ** -7,
                                   atol=1e-5)
    full = lax.conv_transpose(jnp.asarray(x), jnp.asarray(k), (2, 2), "VALID",
                              dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = tph.depth_to_space(tph.phase_upconv_matmul(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=1e-4, atol=1e-5)


def test_phase_head_matches_jax():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 5, 6, 4 * 8).astype(np.float32)
    k = (rng.randn(1, 1, 8, 2) * 0.3).astype(np.float32)
    b = (rng.randn(2) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tph.phase_head_kernel(k), jph.phase_head_kernel(k))
    got = tph.phase_head_matmul(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    want = jph.phase_head_matmul(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    dense = jph.conv2x2_valid(jnp.asarray(x), jnp.asarray(jph.phase_head_kernel(k)))
    np.testing.assert_allclose(got.numpy() - np.tile(b, 4), np.asarray(dense),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tph.phase_bias(torch.from_numpy(b)).numpy(),
                                  np.asarray(jph.phase_bias(jnp.asarray(b))))


@pytest.mark.parametrize("seed", SEEDS)
def test_phase_crop_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = _even_hw(rng, lo=12)
    margin = 2 * rng.randint(0, 3)
    x = rng.randn(1, h, w, 4).astype(np.float32)
    xp = tph.space_to_depth(torch.from_numpy(x))
    got = tph.phase_crop(xp, margin)
    want = jph.phase_crop(jph.space_to_depth(jnp.asarray(x)), margin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if margin:
        assert not got.is_contiguous()     # a view, as the JAX slice is
        full = x[:, margin:h - margin, margin:w - margin]
        assert torch.equal(got, tph.space_to_depth(torch.from_numpy(full)))
    with pytest.raises(ValueError, match="even"):
        tph.phase_crop(xp, 3)


def test_enc0_chain_end_to_end_matches_full_resolution():
    """s2d -> packed conv + ReLU -> packed conv + ReLU -> phase pool equals
    the full-resolution chain, through odd packed sizes (20 -> 10 -> 9 -> 8)."""
    rng = np.random.RandomState(17)
    x = rng.randn(1, 20, 20, 1).astype(np.float32)
    k1 = (rng.randn(3, 3, 1, 8) * 0.5).astype(np.float32)
    k2 = (rng.randn(3, 3, 8, 8) * 0.3).astype(np.float32)
    y = jnp.maximum(_conv3x3(jnp.asarray(x), jnp.asarray(k1)), 0.0)
    y = jnp.maximum(_conv3x3(y, jnp.asarray(k2)), 0.0)
    ref = lax.reduce_window(y, -jnp.inf, lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    p = tph.space_to_depth(torch.from_numpy(x))
    for k in (k1, k2):
        p = torch.relu(tph.conv2x2_valid(p, torch.from_numpy(tph.phase_pack_kernel(k))))
    got = tph.phase_pool(p)
    assert got.shape == (1, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
