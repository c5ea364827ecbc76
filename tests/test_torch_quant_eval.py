"""The port's quantized evaluate() against the JAX package's on the CPU,
given the same numpy weights: served from a .npz that JAX calibrated and
wrote (quant 'int8', 'int8-phase', 'int4' and 'int4-phase'; the int4 tiers
share this file's JAX compiles), calibrated once and then served from
disk, and the int4 tiers' check of the file's tier."""

import os

import numpy as np
import pytest

import jax

from tpu_unet.data import synthetic_dataset as jax_synthetic_dataset
from tpu_unet.infer import evaluate as jax_evaluate
from tpu_unet.models import UNet as JaxUNet
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.data.tiff import read_tiff
from tpu_unet_torch.infer import evaluate
from tpu_unet_torch.infer import quant as tq
from tests.test_torch_model import jax_config
from tests.test_torch_quant import make_nets


@pytest.fixture(scope="module")
def nets():
    return make_nets()


EVAL_DATA = dict(n_images=2, h=64, w=64, n_cells=3, crop=20, seed=3)


def test_evaluate_int8_matches_jax(nets, tmp_path):
    """evaluate(quant='int8') served from a .npz that JAX's evaluate
    calibrated and wrote: the class maps and the metrics equal JAX's.

    JAX's evaluate runs here with jit disabled, op by op as the port runs:
    XLA's fused program does not round the bf16 dequantize before the
    upconvs, so jitted it differs from its own eager run (42% of up3's
    values, 7% of dec3_conv1's int8 values at this size), while the port
    matches the eager run bit for bit (test_every_stage_matches_jax)."""
    path = str(tmp_path / "qp.npz")
    jmodel_bf16 = JaxUNet(jax_config(nets["bfloat16"].cfg))
    with jax.disable_jit():
        expected = jax_evaluate(jmodel_bf16, nets["params"],
                                jax_synthetic_dataset(**EVAL_DATA),
                                output_dir=str(tmp_path / "jax"), verbose=False,
                                quant="int8", quant_path=path)
    assert os.path.exists(path)
    model = nets["bfloat16"]
    data = synthetic_dataset(**EVAL_DATA)
    got = evaluate(model, data, output_dir=str(tmp_path / "port"), verbose=False,
                   quant="int8", quant_path=path)
    assert set(got) == set(expected) and got["num_images"] == 2
    from PIL import Image
    for i in range(2):
        pred = np.asarray(Image.open(tmp_path / "port" / "preds" / f"pred{i}.tif"))
        jpred = np.asarray(Image.open(tmp_path / "jax" / "preds" / f"pred{i}.tif"))
        assert 0 < (pred > 0).mean() < 1
        np.testing.assert_array_equal(pred, jpred)
    for key in ("iou_mean", "iou_std", "pe_mean", "pe_std"):
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-6, atol=1e-7)


def test_evaluate_int8_phase_matches_jax(nets, tmp_path):
    """evaluate(quant='int8-phase') served from the .npz JAX's evaluate
    calibrated and wrote (JAX run eagerly, as for quant='int8' above):
    class maps equal, metrics at rtol 1e-6."""
    path = str(tmp_path / "qp.npz")
    jmodel = JaxUNet(jax_config(nets["bfloat16"].cfg))
    with jax.disable_jit():
        expected = jax_evaluate(jmodel, nets["params"], jax_synthetic_dataset(**EVAL_DATA),
                                output_dir=str(tmp_path / "jax"), verbose=False,
                                quant="int8-phase", quant_path=path)
    data = synthetic_dataset(**EVAL_DATA)
    got = evaluate(nets["bfloat16"], data, output_dir=str(tmp_path / "port"), verbose=False,
                   quant="int8-phase", quant_path=path)
    from PIL import Image
    for i in range(2):
        pred = np.asarray(Image.open(tmp_path / "port" / "preds" / f"pred{i}.tif"))
        jpred = np.asarray(Image.open(tmp_path / "jax" / "preds" / f"pred{i}.tif"))
        assert 0 < (pred > 0).mean() < 1
        np.testing.assert_array_equal(pred, jpred)
    for key in ("iou_mean", "iou_std", "pe_mean", "pe_std"):
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-6, atol=1e-7)


def test_evaluate_int8_calibrates_once_then_serves_from_disk(nets, tmp_path, monkeypatch):
    """A missing quant_path is calibrated and written; the next evaluate is
    served from the file with no calibration, and gives the same metrics;
    so is int8-phase. The int4 tiers serve too, and refuse the int8 file."""
    model = nets["bfloat16"]
    data = synthetic_dataset(**EVAL_DATA)
    calls = []
    real = tq.calibrate
    monkeypatch.setattr(tq, "calibrate", lambda *a, **k: calls.append(1) or real(*a, **k))
    path = str(tmp_path / "serve")
    first = evaluate(model, data, verbose=False, quant="int8", quant_path=path)
    assert calls == [1] and os.path.exists(path + ".npz")
    qp = tq.load_quant_params(path)
    assert qp.qnames == tq.default_quant_names(model.cfg)
    second = evaluate(model, data, verbose=False, quant="int8", quant_path=path)
    assert calls == [1]
    assert {k: v for k, v in first.items() if k != "seconds"} == \
        {k: v for k, v in second.items() if k != "seconds"}
    # int8-phase serves from the same file (item 8, ported): no calibration
    phase = evaluate(model, data, verbose=False, quant="int8-phase", quant_path=path)
    assert calls == [1] and np.isfinite(phase["pe_mean"]) and phase["num_images"] == 2
    for quant in ("int4", "int4-phase"):
        with pytest.raises(ValueError, match="holds an int8-tier QuantParams"):
            evaluate(model, data, verbose=False, quant=quant, quant_path=path)
        served = evaluate(model, data, verbose=False, quant=quant)
        assert served["num_images"] == 2 and np.isfinite(served["pe_mean"])
    with pytest.raises(ValueError, match="quant must be"):
        evaluate(model, data, verbose=False, quant="fp8")


@pytest.mark.parametrize("quant", ["int4", "int4-phase"])
def test_evaluate_int4_matches_jax(nets, tmp_path, quant):
    """evaluate(quant=...) served from the .npz JAX's evaluate calibrated
    and wrote (JAX run eagerly): class maps equal, metrics at rtol 1e-6.
    At base width 8, min_channels 128 leaves two int4 convs."""
    path = str(tmp_path / "qp.npz")
    jmodel = JaxUNet(jax_config(nets["bfloat16"].cfg))
    with jax.disable_jit():
        expected = jax_evaluate(jmodel, nets["params"], jax_synthetic_dataset(**EVAL_DATA),
                                output_dir=str(tmp_path / "jax"), verbose=False,
                                quant=quant, quant_path=path)
    assert tq.load_quant_params(path).q4names == {"bottleneck_conv2", "dec3_conv1"}
    got = evaluate(nets["bfloat16"], synthetic_dataset(**EVAL_DATA),
                   output_dir=str(tmp_path / "port"), verbose=False, quant=quant,
                   quant_path=path)
    for i in range(2):
        (pred,), (jpred,) = (read_tiff(str(tmp_path / side / "preds" / f"pred{i}.tif"))
                             for side in ("port", "jax"))
        assert 0 < (pred > 0).mean() < 1
        np.testing.assert_array_equal(pred, jpred)
    for key in ("iou_mean", "iou_std", "pe_mean", "pe_std"):
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-6, atol=1e-7)
