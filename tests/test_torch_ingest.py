"""The port's TIFF codec (tpu_unet_torch/data/tiff.py) against Pillow, and
its CTC/ISBI loaders (tpu_unet_torch/data/ingest.py) against the JAX
package's on synthetic on-disk trees; the layout cases of
tests/test_ingest_layout.py, mirrored."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tpu_unet.data import ingest as jax_ingest
from tpu_unet.data.synthetic import synthetic_instances
from tpu_unet_torch.data import load_ctc_test, load_ctc_training, load_isbi_training
from tpu_unet_torch.data.tiff import read_tiff, write_tiff
from tests.test_ingest_layout import _make_ctc_tree

DTYPES = [np.uint8, np.uint16, np.int32, np.float32]


def _values(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    if dtype == np.float32:
        return (rng.randn(*shape) * 1e3).astype(np.float32)
    info = np.iinfo(dtype)
    hi = min(int(info.max), 2 ** 31 - 1)        # uint32: PIL reads it as int32
    return rng.randint(max(int(info.min), -2 ** 31), hi, size=shape, dtype=np.int64
                       ).astype(dtype)


def _make_isbi_tree(root, frames=4, size=128, seed=1):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "01"), exist_ok=True)
    os.makedirs(os.path.join(root, "01_GT", "SEG"), exist_ok=True)
    for t in range(frames):
        img = (rng.rand(size, size) * 255).astype(np.uint8)
        inst = synthetic_instances(size, size, 4, rng).astype(np.uint16)
        Image.fromarray(img).save(os.path.join(root, "01", f"t{t:03d}.tif"))
        Image.fromarray(inst).save(os.path.join(root, "01_GT", "SEG", f"man_seg{t:03d}.tif"))
    return root


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("rows_per_strip", [None, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_read_tiff_equals_pillow(tmp_path, dtype, rows_per_strip):
    a = _values(dtype, (50, 37), seed=3)
    path = str(tmp_path / "a.tif")
    Image.fromarray(a).save(path, **({"tiffinfo": {278: rows_per_strip}}
                                     if rows_per_strip else {}))
    (page,) = read_tiff(path)
    assert page.dtype == np.asarray(Image.open(path)).dtype == dtype
    np.testing.assert_array_equal(page, a)


def test_read_tiff_reads_every_page(tmp_path):
    frames = [_values(np.uint8, (40, 33), seed=s) for s in range(3)]
    path = str(tmp_path / "m.tif")
    Image.fromarray(frames[0]).save(path, save_all=True,
                                    append_images=[Image.fromarray(f) for f in frames[1:]])
    pages = read_tiff(path)
    assert len(pages) == 3
    for page, frame in zip(pages, frames):
        np.testing.assert_array_equal(page, frame)


def test_read_tiff_big_endian(tmp_path):
    a = _values(np.uint16, (33, 41), seed=4)
    path = str(tmp_path / "be.tif")
    Image.frombytes("I;16B", (41, 33), a.astype(">u2").tobytes()).save(path)
    assert open(path, "rb").read(2) == b"MM"
    (page,) = read_tiff(path)
    assert page.dtype == np.uint16
    np.testing.assert_array_equal(page, a)
    np.testing.assert_array_equal(page, np.asarray(Image.open(path)))


@pytest.mark.parametrize("dtype", DTYPES + [np.uint32])
def test_write_tiff_read_by_pillow_and_jax(tmp_path, dtype):
    a = _values(dtype, (29, 46), seed=5)
    path = str(tmp_path / "w.tif")
    write_tiff(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    np.testing.assert_array_equal(jax_ingest._imread(path), a)


@pytest.mark.parametrize("mode,kwargs,tag", [
    ("L", {"compression": "tiff_lzw"}, "Compression (tag 259) = 5"),
    ("P", {}, "PhotometricInterpretation (tag 262) = 3"),
    ("RGB", {}, "PhotometricInterpretation (tag 262) = 2"),
])
def test_read_tiff_rejects_what_it_cannot_decode(tmp_path, mode, kwargs, tag):
    path = str(tmp_path / "x.tif")
    Image.fromarray(_values(np.uint8, (16, 16), seed=6)).convert(mode).save(path, **kwargs)
    with pytest.raises(ValueError, match=tag.replace("(", r"\(").replace(")", r"\)")):
        read_tiff(path)


@pytest.mark.parametrize("array", [np.zeros((2, 3, 4), np.uint8), np.zeros((0, 3), np.uint8),
                                   np.zeros((2, 3), np.float64)])
def test_write_tiff_rejects_other_arrays(tmp_path, array):
    with pytest.raises(ValueError):
        write_tiff(str(tmp_path / "x.tif"), array)


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       dtype=st.sampled_from(DTYPES + [np.uint32]), seed=st.integers(0, 2 ** 31 - 1))
def test_write_then_read_round_trips(tmp_path_factory, h, w, dtype, seed):
    a = _values(dtype, (h, w), seed)
    path = str(tmp_path_factory.mktemp("rt") / "r.tif")
    write_tiff(path, a)
    (page,) = read_tiff(path)
    assert page.dtype == a.dtype
    np.testing.assert_array_equal(page, a)


# ------------------------------------------------------------------ loaders


def _assert_same(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.targets, want.targets)
    for a, b in ((got.crop_log_probs, want.crop_log_probs),
                 (got.crop_pairs, want.crop_pairs)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got.images.dtype == want.images.dtype
    assert got.targets.dtype == want.targets.dtype
    assert got.name == want.name


@pytest.mark.parametrize("loader", ["load_ctc_training", "load_ctc_test",
                                    "load_isbi_training"])
def test_loaders_equal_jax(tmp_path, loader):
    if loader == "load_isbi_training":
        root = _make_isbi_tree(str(tmp_path / "ISBI2012-training"))
    else:
        root = _make_ctc_tree(str(tmp_path / "DS-training"), n_seq=2, frames=3,
                              gt_frames=2)
    kwargs = {} if loader == "load_ctc_test" else {"crop": 64}
    port = {"load_ctc_training": load_ctc_training, "load_ctc_test": load_ctc_test,
            "load_isbi_training": load_isbi_training}[loader]
    _assert_same(port(root, **kwargs), getattr(jax_ingest, loader)(root, **kwargs))


def test_ctc_training_excludes_gt_frames(tmp_path):
    root = _make_ctc_tree(str(tmp_path / "DS-training"), n_seq=2, frames=3, gt_frames=1)
    data = load_ctc_training(root, crop=64)
    assert len(data) == 4                       # 2 sequences x (3 ST - 1 GT-reserved)
    assert data.images.shape == (4, 96, 96)
    assert set(np.unique(data.targets)) <= {0.0, 255.0}
    assert data.crop_log_probs.shape[0] == 4
    assert len(os.listdir(os.path.join(root, "01_ST", "SEG"))) == 3   # nothing moved


def test_ctc_test_loads_gold_truth_only(tmp_path):
    root = _make_ctc_tree(str(tmp_path / "DS-training"), n_seq=2, frames=3, gt_frames=2)
    data = load_ctc_test(root)
    assert len(data) == 4
    assert data.crop_log_probs is None


def test_isbi_layout(tmp_path):
    data = load_isbi_training(_make_isbi_tree(str(tmp_path / "ISBI2012-training")), crop=64)
    assert len(data) == 4
    assert data.images.shape == (4, 128, 128)


def test_many_sequences_supported(tmp_path):
    root = str(tmp_path / "DS-training")
    rng = np.random.RandomState(2)
    for name in ["01", "02", "10"]:
        for sub in (name, f"{name}_ST/SEG", f"{name}_GT/SEG"):
            os.makedirs(os.path.join(root, sub))
        img = (rng.rand(96, 96) * 255).astype(np.uint8)
        inst = synthetic_instances(96, 96, 2, rng).astype(np.uint16)
        Image.fromarray(img).save(os.path.join(root, name, "t000.tif"))
        Image.fromarray(inst).save(os.path.join(root, f"{name}_ST", "SEG", "man_seg000.tif"))
    assert len(load_ctc_training(root, crop=64)) == 3
