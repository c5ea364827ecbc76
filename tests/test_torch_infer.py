"""The port's serving slice — padding, metrics, the tile engine and the
evaluation entry point (tpu_unet_torch/ops/pad.py, losses/metrics.py,
infer/tiles.py, infer/tester.py, data/) — against the JAX package on the CPU.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from tpu_unet.data import synthetic_dataset as jax_synthetic_dataset
from tpu_unet.infer import evaluate as jax_evaluate
from tpu_unet.losses.metrics import batch_evaluation_metrics as jax_metrics
from tpu_unet.models import UNet as JaxUNet
from tpu_unet.ops.pad import reflect_pad as jax_reflect_pad
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.convert import state_dict_from_jax_params
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.infer import TileInference, evaluate, make_tile_batch_forward
from tpu_unet_torch.losses import batch_evaluation_metrics, iou, pixel_error
from tpu_unet_torch.models import UNet
from tpu_unet_torch.ops import reflect_pad
from tests.test_torch_model import jax_config, numpy_params

# The slice at test size: 2 images of 96x96, tile_out 52 -> 4 tiles each.
DATA_ARGS = dict(n_images=2, h=96, w=96, n_cells=2, crop=20, seed=5)
TILE_OUT = 52


@pytest.fixture(scope="module")
def pallas_models():
    cfg = ModelConfig(base_width=4, conv_impl="pallas")
    jmodel = JaxUNet(jax_config(cfg))
    params = numpy_params(jmodel, 188, seed=7)
    model = UNet(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    return jmodel, params, model


def _read_tiff(path):
    return np.asarray(Image.open(path))


def test_evaluate_matches_jax(pallas_models, tmp_path):
    jmodel, params, model = pallas_models
    data = synthetic_dataset(**DATA_ARGS)
    jdata = jax_synthetic_dataset(**DATA_ARGS)
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    expected = jax_evaluate(jmodel, params, jdata, output_dir=jout,
                            tile_out=TILE_OUT, verbose=False)
    got = evaluate(model, data, output_dir=out, tile_out=TILE_OUT,
                   verbose=False)
    assert set(got) == set(expected)
    assert got["num_images"] == expected["num_images"] == 2

    engine = TileInference(model, 96, 96, tile_out=TILE_OUT)
    assert engine.plan.num_tiles == 4
    labels = (data.targets > 127).astype(np.uint8)
    undecided = []
    for i in range(2):
        pred = _read_tiff(os.path.join(out, "preds", f"pred{i}.tif")) // 255
        jpred = _read_tiff(os.path.join(jout, "preds", f"pred{i}.tif")) // 255
        # class maps agree wherever the top-2 logit margin exceeds 1e-3
        logits = engine.predict_logits(data.images[i]).numpy()
        top2 = np.sort(logits, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > 1e-3
        assert decided.mean() > 0.99
        undecided.append((~decided).mean())
        np.testing.assert_array_equal(pred[decided], jpred[decided])
        np.testing.assert_array_equal(
            pred, engine.predict(data.images[i]).numpy())
        # per-image metrics agree up to the undecided pixels
        ms = batch_evaluation_metrics(torch.from_numpy(pred[None]),
                                      torch.from_numpy(labels[i][None]))[0]
        jms = np.asarray(jax_metrics(jnp.asarray(jpred[None]),
                                     jnp.asarray(labels[i][None])))[0]
        np.testing.assert_allclose(ms.numpy(), jms, atol=undecided[i] + 1e-6)
    for key in ("iou_mean", "iou_std", "pe_mean", "pe_std"):
        np.testing.assert_allclose(got[key], expected[key],
                                   atol=2 * max(undecided) + 1e-6)


def test_evaluate_writes_artifacts(pallas_models, tmp_path):
    _, _, model = pallas_models
    data = synthetic_dataset(**DATA_ARGS)
    out = str(tmp_path / "eval")
    result = evaluate(model, data, output_dir=out, tile_out=TILE_OUT,
                      verbose=False)
    for sub, name in [("images", "image0.tif"), ("preds", "pred1.tif"),
                      ("labels", "label0.tif"), ("labels", "label1.tif")]:
        assert os.path.exists(os.path.join(out, sub, name))
    iou_out = np.loadtxt(os.path.join(out, "test_iou.out"))
    pe_out = np.loadtxt(os.path.join(out, "test_pe.out"))
    np.testing.assert_allclose(iou_out, [result["iou_mean"], result["iou_std"]])
    np.testing.assert_allclose(pe_out, [result["pe_mean"], result["pe_std"]])


def test_evaluate_groups_shapes_and_rejects_quant(pallas_models):
    _, _, model = pallas_models
    data = synthetic_dataset(**DATA_ARGS)
    # a non-square frame is square-cropped, which gives a second shape group
    data.images = [data.images[0], data.images[1][:, :80]]
    data.targets = [data.targets[0], data.targets[1][:, :80]]
    result = evaluate(model, data, tile_out=TILE_OUT, verbose=False)
    assert result["num_images"] == 2 and np.isfinite(result["pe_mean"])
    # int8 and int4 serving take both shape groups too; an unknown tier raises
    for quant in ("int8", "int4"):
        result = evaluate(model, data, tile_out=TILE_OUT, verbose=False, quant=quant)
        assert result["num_images"] == 2 and np.isfinite(result["pe_mean"])
    with pytest.raises(ValueError, match="quant must be"):
        evaluate(model, data, quant="int2", verbose=False)


def test_synthetic_dataset_matches_jax():
    a = synthetic_dataset(n_images=2, h=64, w=72, n_cells=3, crop=30, seed=11)
    b = jax_synthetic_dataset(n_images=2, h=64, w=72, n_cells=3, crop=30, seed=11)
    for field in ("images", "targets", "crop_log_probs", "crop_pairs"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_tiled_matches_whole_image_random_sizes():
    """Tile origins are aligned to the pooling period, so the stitched tiled
    pass equals the whole-image pass at any size (seeded random draws)."""
    model = UNet(ModelConfig(base_width=2))
    rng = np.random.RandomState(21)
    for _ in range(4):
        h, w = rng.randint(20, 140, size=2)
        tout = int(rng.choice([20, 36, 52, 68]))
        img = rng.rand(h, w).astype(np.float32)
        tiled = TileInference(model, h, w, tile_out=tout, batch_tiles=3)
        whole = TileInference(model, h, w)
        assert all(y % 16 == 0 and x % 16 == 0
                   for (y, x) in tiled.plan.out_origins)
        lt = tiled.predict_logits(img).numpy()
        lw = whole.predict_logits(img).numpy()
        np.testing.assert_allclose(lt, lw, rtol=1e-4, atol=1e-4)
        margin = np.abs(lw[..., 1] - lw[..., 0]) > 1e-3
        ids = tiled.predict_batch(img[None])[0].numpy()
        np.testing.assert_array_equal(ids[margin], lw.argmax(-1)[margin])


def test_flat_path_honours_batch_tiles():
    """The flat batch goes through the model in chunks of `batch_tiles`,
    the last filled up by cycling real tiles; the result does not depend on
    the chunking."""
    model = UNet(ModelConfig(base_width=2))
    sizes = []
    model.register_forward_pre_hook(lambda m, args: sizes.append(args[0].shape[0]))
    imgs = np.random.RandomState(3).rand(3, 60, 60).astype(np.float32)
    ids = {}
    for bt in (1, 4, 16):
        sizes.clear()
        eng = TileInference(model, 60, 60, tile_out=36, batch_tiles=bt)
        m = 3 * eng.plan.num_tiles                       # 12 tiles
        ids[bt] = eng.predict_batch(imgs).numpy()
        c = min(bt, m)
        assert sizes == [c] * (-(-m // c))
    np.testing.assert_array_equal(ids[1], ids[4])
    np.testing.assert_array_equal(ids[1], ids[16])


def test_engine_rejects_small_tiles_and_mesh():
    """tile_out under one pooling period, and a mesh axis the mesh lacks
    (the meshed engine itself: tests/test_torch_parallel.py)."""
    model = UNet(ModelConfig(base_width=2))
    with pytest.raises(ValueError, match=">= 16"):
        TileInference(model, 64, 64, tile_out=12)
    mesh = SimpleNamespace(mesh_dim_names=("data", "spatial"))
    with pytest.raises(ValueError, match="no axis 'tiles'"):
        TileInference(model, 64, 64, tile_out=36, mesh=mesh, mesh_axis="tiles")


def test_make_tile_batch_forward():
    model = UNet(ModelConfig(base_width=2))
    fwd = make_tile_batch_forward(model, 188, 2)
    tiles = torch.rand(2, 188, 188, 1)
    out = fwd(tiles)
    assert tuple(out.shape) == (2, 4, 4)
    with torch.no_grad():
        torch.testing.assert_close(out, model(tiles).argmax(-1))


@pytest.mark.parametrize("shape,pad", [
    ((5, 7), 3),
    ((4, 6), ((11, 2), (0, 13))),     # pads past the image side: multi-bounce
    ((2, 1, 3), ((4, 4), (5, 1))),    # a leading batch axis, a 1-px side
])
def test_reflect_pad_matches_jax(shape, pad):
    img = np.random.RandomState(0).rand(*shape).astype(np.float32)
    expected = np.asarray(jax_reflect_pad(jnp.asarray(img), pad))
    got = reflect_pad(torch.from_numpy(img), pad).numpy()
    np.testing.assert_array_equal(got, expected)
    if img.ndim == 2 and min(shape) > 1:
        p = ((pad, pad), (pad, pad)) if isinstance(pad, int) else pad
        np.testing.assert_array_equal(got, np.pad(img, p, mode="reflect"))


def test_metrics_match_jax():
    rng = np.random.RandomState(4)
    preds = (rng.rand(3, 9, 11) > 0.5).astype(np.int32)
    labels = (rng.rand(3, 9, 11) > 0.4).astype(np.uint8)
    preds[2] = 0
    labels[2] = 0                       # both empty: IoU is NaN (0/0)
    got = batch_evaluation_metrics(torch.from_numpy(preds),
                                   torch.from_numpy(labels)).numpy()
    expected = np.asarray(jax_metrics(jnp.asarray(preds), jnp.asarray(labels)))
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    assert np.isnan(got[2, 0]) and got[2, 1] == 0
    for k in range(3):
        np.testing.assert_allclose(
            [iou(torch.from_numpy(preds[k]), torch.from_numpy(labels[k])).item(),
             pixel_error(torch.from_numpy(preds[k]),
                         torch.from_numpy(labels[k])).item()],
            got[k], rtol=1e-6)
