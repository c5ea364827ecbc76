"""The port's enc0 stages (tpu_unet_torch/ops/enc0_stages.py) against the
JAX expressions of the Mosaic probes' pieces (scripts/tpu_mosaic_probe.py,
scripts/tpu_mosaic_probe3.py), K5's `block_rows` against the JAX package's
Pallas kernel in interpret mode, and the mosaic probe
(tpu_unet_torch/probes/mosaic_probe.py) on the CPU. The scripts' kernels are
closures inside their main(); these tests write each piece's arithmetic in
jnp, as the kernel body does, on the same seeded numpy inputs, at the block
(bh, bw, c) = (4, 16, 8). On the CPU the wrappers run their plain versions;
the CUDA kernels are held to those on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from tpu_unet.ops import fused_level0 as jfl
from tpu_unet_torch.ops import enc0_stages as st
from tpu_unet_torch.ops import fused_level0 as tfl
from tpu_unet_torch.probes import mosaic_probe

BH, BW, C = 4, 16, 8


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _within_one_bf16_ulp(got, want, floor=1e-6):
    """|got - want| <= one bf16 ulp of `want` (2^(e - 8) for |want| = m 2^e,
    m in [0.5, 1)), or <= `floor` (values that round to either side of 0)."""
    g, w = _np(got).astype(np.float64), _f32(want).astype(np.float64)
    assert g.shape == w.shape
    _, e = np.frexp(w)
    assert (np.abs(g - w) <= np.ldexp(1.0, e - 8) + floor).all()


def _conv2_oracle(h, w):
    """tpu_mosaic_probe3.py:97-101: f32 conv of the bf16 values."""
    return lax.conv_general_dilated(jnp.asarray(h, jnp.float32), jnp.asarray(w, jnp.float32),
                                    (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(1, BH + 2, BW + 2, C) * 0.5, 0).astype(np.float32)
    w2 = (rng.randn(3, 3, C, C) * 0.05).astype(np.float32)
    # both as bf16 values
    return (np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32)),
            np.asarray(jnp.asarray(w2, jnp.bfloat16).astype(jnp.float32)), rng)


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("x_bf16,bias", [(False, False), (True, False), (False, True)])
def test_conv1_stage_matches_k_conv1(x_bf16, bias):
    """k_conv1 (tpu_mosaic_probe.py:61-67): the broadcast multiply-add over
    (dy, dx), ReLU, bf16; a bias after the sum where given."""
    rng = np.random.RandomState(1)
    x = rng.rand(BH + 4, BW + 4).astype(np.float32)
    if x_bf16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w9 = (rng.randn(9, C) * 0.5).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32) if bias else None
    acc = jnp.zeros((BH + 2, BW + 2, C), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            xs = jnp.asarray(x)[dy:dy + BH + 2, dx:dx + BW + 2]
            acc = acc + xs[:, :, None] * jnp.asarray(w9)[3 * dy + dx][None, None, :]
    if bias:
        acc = acc + b
    want = jnp.maximum(acc, 0.0).astype(jnp.bfloat16)
    tx = torch.tensor(x)[None]
    got = st.conv1_stage(tx.to(torch.bfloat16) if x_bf16 else tx, torch.from_numpy(w9),
                         None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (1, BH + 2, BW + 2, C)
    _within_one_bf16_ulp(got[0], want)


def test_conv1_taps_matches_the_einsum_oracle():
    """A (tpu_mosaic_probe3.py:77-89): a [rows*cols, 9] x [9, c] product +
    ReLU -> bf16, against the script's einsum oracle."""
    rng = np.random.RandomState(2)
    slab9 = rng.randn(BH + 2, BW + 2, 9).astype(np.float32)
    w9 = (rng.randn(9, C) * 0.1).astype(np.float32)
    want = jnp.maximum(jnp.einsum("rct,tk->rck", slab9, w9), 0.0).astype(jnp.bfloat16)
    got = st.conv1_stage(torch.from_numpy(slab9)[None], torch.from_numpy(w9), taps=True)
    _within_one_bf16_ulp(got[0], want)


def test_conv2_stage_matches_the_oracle():
    """B, C and D against conv2_oracle at rtol 1e-4; the ReLU-bf16 store
    within one bf16 ulp of the oracle's."""
    h, w2, _ = _inputs(3)
    want = np.asarray(_conv2_oracle(h, w2))
    got = st.conv2_stage(_bf16(h), _bf16(w2))
    assert got.dtype == torch.float32 and got.shape == (1, BH, BW, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    got = st.conv2_stage(_bf16(h), _bf16(w2), relu_bf16=True)
    assert got.dtype == torch.bfloat16
    _within_one_bf16_ulp(got, jnp.maximum(want, 0.0).astype(jnp.bfloat16))


def _pair_weights(w2, junk):
    """k_pair's [5, 2c, c] from HWIO: pair p stacks taps 2p and 2p + 1;
    pair 4's second half multiplies the kernel's zeros (`junk` there)."""
    taps = [w2[t // 3, t % 3] for t in range(9)] + [junk]
    return np.stack([np.concatenate(taps[2 * p:2 * p + 2], 0) for p in range(5)])


def test_pair_layout_and_k_pair():
    """k_pair (tpu_mosaic_probe.py:75-93) in jnp on the pair weights against
    conv2_stage(relu_bf16=True) on the converted weights."""
    h, w2, rng = _inputs(4)
    wp = _pair_weights(w2, rng.randn(C, C).astype(np.float32))
    wp = np.asarray(jnp.asarray(wp, jnp.bfloat16).astype(jnp.float32))
    hj = jnp.asarray(h[0], jnp.bfloat16)
    acc = None
    for p in range(5):
        ta, tb = 2 * p, 2 * p + 1
        ya, xa = ta // 3, ta % 3
        other = (hj[tb // 3:tb // 3 + BH, tb % 3:tb % 3 + BW, :] if tb < 9
                 else jnp.zeros((BH, BW, C), jnp.bfloat16))
        lhs = jnp.concatenate([hj[ya:ya + BH, xa:xa + BW, :], other], axis=-1)
        d = lax.dot_general(lhs, jnp.asarray(wp[p], jnp.bfloat16),
                            dimension_numbers=(((2,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
        acc = d if acc is None else acc + d
    want = jnp.maximum(acc, 0.0).astype(jnp.bfloat16)
    w_hwio = st.hwio_from_pair(_bf16(wp))
    np.testing.assert_array_equal(_np(w_hwio), w2)
    got = st.conv2_stage(_bf16(h), w_hwio, relu_bf16=True)
    _within_one_bf16_ulp(got[0], want)


def test_layout_converters_invert_the_scripts_layouts():
    """B's nconcat (tpu_mosaic_probe3.py:104-108), C's rows3 (:129) and D's
    im2col (:152), built as the script builds them, convert back to HWIO."""
    _, w2, _ = _inputs(5)
    w2j = jnp.asarray(w2, jnp.bfloat16)
    w2cat = jnp.zeros((3, C, 3 * 128), jnp.bfloat16)
    for dy in range(3):
        for dx in range(3):
            w2cat = w2cat.at[dy, :, dx * 128:dx * 128 + C].set(w2j[dy, dx])
    for got in (st.hwio_from_nconcat(_bf16(_f32(w2cat))),
                st.hwio_from_rows3(_bf16(_f32(w2j.reshape(3, 3 * C, C)))),
                st.hwio_from_im2col(_bf16(_f32(w2j.reshape(9 * C, C))))):
        assert got.shape == (3, 3, C, C)
        np.testing.assert_array_equal(_np(got), w2)
    with pytest.raises(ValueError):
        st.hwio_from_nconcat(_bf16(_f32(w2cat)), cout=129)
    with pytest.raises(ValueError):
        st.hwio_from_pair(torch.zeros((4, 2 * C, C)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s", [50.0, 37.5, 0.5])
def test_pool_quant_stage_matches_jax(dtype, s):
    """pool_oracle (tpu_mosaic_probe3.py:181-184) and k_q8's
    clip(round(h * s), 0, 127) (tpu_mosaic_probe.py:112-114), bit for bit;
    at s = 0.5 every odd value lands on .5 (round half to even)."""
    rng = np.random.RandomState(6)
    if s == 0.5:
        h = rng.randint(-20, 300, (1, BH, BW, C)).astype(np.float32)
    else:
        h = np.abs(rng.randn(1, BH, BW, C)).astype(np.float32) * 1.5
    hj = jnp.asarray(h, dtype)
    want_pool = jnp.max(hj.astype(jnp.float32).reshape(1, BH // 2, 2, BW // 2, 2, C),
                        axis=(2, 4)).astype(jnp.bfloat16)
    want_q = jnp.clip(jnp.round(hj.astype(jnp.float32) * s), 0.0, 127.0).astype(jnp.int8)
    th = torch.from_numpy(_f32(hj)).to(torch.float32 if dtype == jnp.float32
                                       else torch.bfloat16)
    skip, pooled = st.pool_quant_stage(th, skip="int8", skip_scale=s)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(_np(pooled), _f32(want_pool))
    if s == 0.5:
        assert (np.asarray(want_q) == 127).any() and (np.asarray(want_q) == 0).any()
    skip, pooled = st.pool_quant_stage(th, skip="bf16", pool=False)
    assert pooled is None
    np.testing.assert_array_equal(_np(skip), _f32(hj.astype(jnp.bfloat16)))


def test_stages_check_their_arguments():
    h = torch.rand((1, 4, 6, 8))
    for kw in ({"skip": "int8"}, {"skip": "int8", "skip_scale": 0.0},
               {"skip": "bf16", "skip_scale": 2.0}, {"skip": None, "pool": False},
               {"skip": "f32"}):
        with pytest.raises(ValueError):
            st.pool_quant_stage(h, **kw)
    with pytest.raises(ValueError, match="even"):
        st.pool_quant_stage(h[:, :3])
    with pytest.raises(TypeError):
        st.conv2_stage(h, torch.rand((3, 3, 8, 8)))
    with pytest.raises(ValueError):
        st.conv2_stage(h.to(torch.bfloat16), torch.rand((3, 3, 4, 8)).to(torch.bfloat16))
    with pytest.raises(ValueError):
        st.conv1_stage(h, torch.rand((9, 8)))                       # not 9 taps
    with pytest.raises(ValueError):
        st.conv1_stage(h[..., 0], torch.rand((8, 8)))
    with pytest.raises(ValueError):
        st.conv1_stage(h[..., 0], torch.rand((9, 8)), torch.rand(4))
    assert (st.conv1_stage.launches, st.conv2_stage.launches,
            st.pool_quant_stage.launches) == (0, 0, 0)


@pytest.mark.parametrize("int8_skip", [False, True])
def test_g_and_h_compose_against_chain_oracle(int8_skip):
    """G and H (tpu_mosaic_probe3.py:208-282) composed of the three stages
    against the scripts' kernel arithmetic (k_chain, :208-230), stage by
    stage: h1 within one bf16 ulp of bf16(relu(a1)); from that h1, conv2 in
    f32 and ReLU, the bf16 skip and the pool within one bf16 ulp and H's
    int8 skip within 1 (the stages quantize bf16(h2), the script the f32
    h2); and G against the script's chain_oracle (:233-242) at its atol
    2e-1 (the script gives H none)."""
    _, w2, rng = _inputs(8)
    slab9b = rng.randn(BH + 4, BW + 4, 9).astype(np.float32)
    w9 = (rng.randn(9, C) * 0.1).astype(np.float32)
    a1 = jnp.einsum("rct,tk->rck", slab9b[1:BH + 3, 1:BW + 3, :], w9)

    def chain(h1o):
        h2 = jnp.maximum(_conv2_oracle(jnp.asarray(h1o)[None], w2)[0], 0.0)
        pool = jnp.max(h2.reshape(BH // 2, 2, BW // 2, 2, C), axis=(1, 3))
        skip = jnp.clip(jnp.round(h2 * 37.5), 0.0, 127.0) if int8_skip else h2
        return skip, pool

    h1 = st.conv1_stage(torch.from_numpy(slab9b)[None, 1:BH + 3, 1:BW + 3], torch.from_numpy(w9),
                        taps=True)
    _within_one_bf16_ulp(h1[0], jnp.maximum(a1, 0.0).astype(jnp.bfloat16))
    want_skip, want_pool = chain(_np(h1)[0])
    y2 = st.conv2_stage(h1, _bf16(w2), relu_bf16=True)
    if int8_skip:
        skip, pooled = st.pool_quant_stage(y2, skip="int8", skip_scale=37.5)
        assert skip.dtype == torch.int8
        np.testing.assert_allclose(_np(skip)[0], np.asarray(want_skip), rtol=0, atol=1)
    else:
        skip, pooled = y2, st.pool_quant_stage(y2)[1]
        _within_one_bf16_ulp(skip[0], want_skip.astype(jnp.bfloat16))
        oracle_skip, oracle_pool = chain(jnp.maximum(a1, 0.0))
        np.testing.assert_allclose(_np(skip)[0], np.asarray(oracle_skip), rtol=0, atol=2e-1)
        np.testing.assert_allclose(_np(pooled)[0], np.asarray(oracle_pool), rtol=0, atol=2e-1)
    _within_one_bf16_ulp(pooled[0], want_pool.astype(jnp.bfloat16))


@pytest.mark.parametrize("block_rows", [1, 3, 8, 16])
def test_concat_quantize_block_rows_matches_jax(block_rows):
    """K5 takes the TPU kernel's row block (tpu_mosaic_probe.py:149-153):
    the same int8 for every block_rows, equal to JAX's in interpret mode."""
    rng = np.random.RandomState(block_rows)
    a = ((rng.rand(2, 9, 7, 16) * 2.6 - 1.3) * 127 * 0.02).astype(np.float32)
    b = ((rng.rand(2, 9, 7, 16) * 2.6 - 1.3) * 127 * 0.02).astype(np.float32)
    want = jfl.concat_quantize(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), 0.02,
                               block_rows=block_rows, interpret=True)
    got = tfl.concat_quantize(_bf16(a), _bf16(b), 0.02, block_rows=block_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_concat_quantize_refuses_a_bad_block_rows():
    a = torch.zeros((1, 2, 3, 8), dtype=torch.bfloat16)
    for br in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="block_rows"):
            tfl.concat_quantize(a, a, 0.1, block_rows=br)


def test_mosaic_probe_runs_on_the_cpu(monkeypatch):
    """Every section at a small size, untimed, nothing beyond its bar; a
    stage made to differ gives exit code 1."""
    monkeypatch.setattr(mosaic_probe, "BLOCK", (BH, BW, C))
    monkeypatch.setattr(mosaic_probe, "K4_CASES", ((1, 12, 16), (2, 20, 32)))
    monkeypatch.setattr(mosaic_probe, "K5_CASES", ((1, 8, 8), (2, 10, 16)))
    monkeypatch.setattr(mosaic_probe, "CHUNK", (2, 14, 8))
    results = mosaic_probe.run(device="cpu")
    names = [r["name"] for r in results]
    assert len(results) == 5 + 8 + 2 + 2 + 3 and names[5].startswith("A ")
    assert not any(r["mismatch"] for r in results)
    assert all(r["ms"] is None for r in results)
    chain = results[-3]
    assert chain["pooled_equal"] and chain["err"][0] <= 1
    assert mosaic_probe.main(["--device", "cpu"]) == 0
    real = st.conv2_stage
    monkeypatch.setattr(st, "conv2_stage", lambda h, w, **kw: real(h, w, **kw) * 2)
    assert mosaic_probe.main(["--device", "cpu"]) == 1
