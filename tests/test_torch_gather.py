"""The port's row gather (tpu_unet_torch/ops/gather.py) against jnp.take,
the warp's gather modes and single-image warp (tpu_unet_torch/data/augment.py)
against the JAX package, and the gather probe
(tpu_unet_torch/probes/gather_probe.py) on the CPU. The probe script's
Pallas kernels are closures inside its main(); what they compute is
``jnp.take(src, idx, axis=0)``, which is the oracle here. On the CPU the
wrappers run their plain version; the CUDA kernel is held to it on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from tpu_unet.data import augment as jaug
from tpu_unet_torch.data import augment as taug
from tpu_unet_torch.ops import gather
from tpu_unet_torch.probes import gather_probe


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("c", [1, 2, 8, 128])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_row_gather_matches_jnp_take(c, idx_dtype):
    """In range, negative (counted from the end) and out of range (NaN),
    through row_gather and the script's three wrapper names; no launch is
    counted on the CPU."""
    rng = np.random.RandomState(c)
    n = 50
    src = rng.rand(n, c).astype(np.float32)
    idx = rng.randint(-n - 10, n + 10, size=64).astype(idx_dtype)
    want = np.asarray(jnp.take(jnp.asarray(src), jnp.asarray(idx), axis=0))
    assert np.isnan(want).any() and (idx < 0).any()
    before = gather.row_gather.launches
    for got in (gather.row_gather_plain(_t(src), _t(idx)), gather.row_gather(_t(src), _t(idx)),
                gather.take_rows(_t(src), _t(idx[None])),
                gather.vecidx_rows(_t(src), _t(idx[None])),
                gather.rowloop_rows(_t(idx), _t(src), 64)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather.rowloop_rows(_t(idx), _t(src), 10).numpy(), want[:10])
    assert gather.row_gather.launches == before


def test_row_gather_checks_its_arguments():
    src, idx = torch.rand((8, 4)), torch.arange(4)
    for bad in ((src.double(), idx), (src, idx.float()), (src[None], idx), (src, idx[None]),
                (src[:, :0], idx)):
        with pytest.raises(ValueError):
            gather.row_gather(*bad)
    with pytest.raises(ValueError, match="index row"):
        gather.take_rows(src, idx)
    with pytest.raises(ValueError, match="index row"):
        gather.vecidx_rows(src, idx[None].repeat(2, 1))
    # the script's run_rowloop(1024) reads 1024 indices of the 128 it passes
    with pytest.raises(ValueError, match="nrows"):
        gather.rowloop_rows(torch.arange(128), src, 1024)
    for nrows in (0, 2.0, True):
        with pytest.raises(ValueError, match="nrows"):
            gather.rowloop_rows(idx, src, nrows)
    assert gather.row_gather(torch.zeros((0, 3)), idx).isnan().all()


def _fields(rng, s, scale):
    return (ndi.gaussian_filter(rng.randn(s, s), 8.0) * scale).astype(np.float32)


def test_bilinear_multi_gather_modes_match_jax():
    rng = np.random.RandomState(4)
    src = (rng.rand(40, 36, 2) * 255).astype(np.float32)
    si = rng.uniform(0, 39, (20, 30)).astype(np.float32)
    sj = rng.uniform(0, 35, (20, 30)).astype(np.float32)
    got = {}
    for mode in ("take4", "stacked"):
        got[mode] = taug._bilinear_multi(_t(src), _t(si), _t(sj), gather=mode)
        want = np.asarray(jaug._bilinear_multi(jnp.asarray(src), si, sj, gather=mode))
        np.testing.assert_allclose(got[mode].numpy(), want, rtol=1e-6, atol=1e-4)
    assert torch.equal(got["take4"], got["stacked"])
    with pytest.raises(ValueError, match="gather"):
        taug._bilinear_multi(_t(src), _t(si), _t(sj), gather="take2")


def test_fused_rotate_elastic_multi_gather_modes():
    """tests/test_augment_fused.py:59-77 on the port: 'take4' equals
    'stacked' bit for bit; each equals JAX's within f32 trig and sums."""
    rng = np.random.RandomState(3)
    src = rng.rand(72, 72, 2).astype(np.float32)
    s = 96
    dx, dy = _fields(rng, s, 25), _fields(rng, s, 25)
    for deg in (0.0, 30.0, 210.0):
        outs = {}
        for mode in ("stacked", "take4"):
            outs[mode] = taug._fused_rotate_elastic_multi(
                _t(src), torch.tensor(deg), _t(dx), _t(dy), s, gather=mode)
            want = np.asarray(jaug._fused_rotate_elastic_multi(
                jnp.asarray(src), jnp.float32(deg), jnp.asarray(dx), jnp.asarray(dy), s,
                gather=mode))
            np.testing.assert_allclose(outs[mode].numpy(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(outs["stacked"], outs["take4"])
    with pytest.raises(ValueError, match="gather"):
        taug._fused_rotate_elastic_multi(_t(src), torch.tensor(0.0), _t(dx), _t(dy), s,
                                         gather="rows")


def test_fused_rotate_elastic_matches_jax():
    """The single-image warp at seeded random (H, W, canvas, offset,
    out_size): the whole canvas and windows of it."""
    rng = np.random.RandomState(7)
    for _ in range(4):
        h, w = rng.randint(20, 60, size=2)
        canvas = int(rng.randint(48, 100))
        out_size = int(rng.randint(8, canvas + 1)) if rng.rand() < 0.75 else None
        offset = int(rng.randint(0, canvas - (out_size or canvas) + 1))
        n = out_size or canvas
        img = (rng.rand(h, w) * 255).astype(np.float32)
        dx, dy = (rng.randn(2, n, n) * 6).astype(np.float32)
        angle = float(rng.choice([0.0, 30.0, 90.0, 150.0, 330.0]))
        got = taug._fused_rotate_elastic(_t(img), torch.tensor(angle), _t(dx), _t(dy), canvas,
                                         offset=offset, out_size=out_size)
        want = np.asarray(jaug._fused_rotate_elastic(
            jnp.asarray(img), jnp.float32(angle), jnp.asarray(dx), jnp.asarray(dy), canvas,
            offset=offset, out_size=out_size))
        assert got.shape == want.shape == (n, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * 255)


def test_gather_probe_runs_on_the_cpu(monkeypatch):
    """Every section at S = 48, untimed, each kernel route equal to its
    torch route; a route made to differ gives exit code 1."""
    results = gather_probe.run(size=48, device="cpu")
    assert {r["section"] for r in results} == {1, 2, 3, 4, 5}
    assert len(results) == 24 and all(r["ms"] is None for r in results)
    assert all(not r["mismatch"] for r in results)
    assert gather_probe.main(["--size", "48", "--device", "cpu"]) == 0
    real = gather.row_gather
    monkeypatch.setattr(gather, "row_gather", lambda s, i: real(s, i) + 1)
    assert gather_probe.main(["--size", "48", "--device", "cpu"]) == 1


def test_probes_default_to_the_card(monkeypatch):
    from tpu_unet_torch.probes import mosaic_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (gather_probe.run, mosaic_probe.run):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            run()
