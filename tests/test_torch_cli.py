"""The port's command-line interface (tpu_unet_torch/cli.py) on the CPU: its
parser against the JAX package's, the cases of tests/test_cli.py mirrored
(the JAX CLI's training is never run here), and TESTING of one narrow
reference .pth through both CLIs."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_unet import cli as jax_cli
from tpu_unet.train.folds import fold_splits as jax_fold_splits
from tpu_unet_torch import cli
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.convert import NAME_MAP, load_reference_checkpoint
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.data.tiff import read_tiff
from tpu_unet_torch.infer import TileInference
from tpu_unet_torch.models import UNet
from tpu_unet_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--platform", "cpu"]
# the CLI's -d synthetic fixture
FIXTURE = dict(n_images=10, h=256, w=256, n_cells=5, crop=196, seed=0)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_action_for_action():
    port, ref = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert list(port) == list(ref)
    for dest, want in ref.items():
        got = port[dest]
        assert got.option_strings == want.option_strings, dest
        assert type(got) is type(want), dest
        assert got.required == want.required, dest
        if dest == "platform":          # the one exception: the device's names
            assert (got.default, got.choices) == ("cuda", ["cpu", "cuda"])
            assert want.choices == ["cpu", "tpu"]
            continue
        assert (got.default, got.choices) == (want.default, want.choices), dest


@pytest.mark.parametrize("argv", [
    ["-m", "TRAINING", "-d", "ISBI2012", "-f", "3", "-s", "7", "-sk", "1"],
    ["-m", "TESTING", "-d", "PhC-C2DH-U373", "-n", "x.pth", "--tile-out", "2372x1188",
     "--quant", "int8-phase", "--no-phase-level0", "--skip-variant", "paper"],
    ["-m", "TRAINING", "-d", "synthetic", "-sf", "--epochs", "3", "--batch-size", "4",
     "--synthetic", "--width-mult", "2", "--base-width", "8", "--dtype", "bfloat16",
     "--init", "parity", "--tile-out", "516", "--compile-cache", "c", "--no-compile-cache",
     "--nan-check", "--quiet", "--download", "--data-dir", "d", "--out-dir", "o"],
])
def test_parsers_read_the_same_arguments(argv):
    got = vars(cli.build_parser().parse_args(argv + CPU))
    want = vars(jax_cli.build_parser().parse_args(argv + CPU))
    assert got == want


def test_folds_over_5_rejected():
    with pytest.raises(SystemExit, match="Input a FOLDS value below 5"):
        cli.main(["-m", "TRAINING", "-d", "synthetic", "-f", "9"])


def test_testing_requires_network():
    with pytest.raises(SystemExit, match="Input a network path"):
        cli.main(["-m", "TESTING", "-d", "synthetic"] + CPU)


def test_no_card_exits_naming_platform_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        cli.main(["-m", "TESTING", "-d", "synthetic", "-n", "x"])


def test_no_card_exits_as_a_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "tpu_unet_torch", "-m", "TRAINING",
                           "-d", "synthetic"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--platform cpu" in proc.stderr and not proc.stdout


def test_training_folds_synthetic(tmp_path, capsys, monkeypatch):
    seen = []
    fit = Trainer.fit

    def recording_fit(self, train, val, epochs=None, resume=False):
        seen.append((self.out_dir, train.images, val.images, self.device))
        return fit(self, train, val, epochs=epochs, resume=resume)

    monkeypatch.setattr(Trainer, "fit", recording_fit)
    out = tmp_path / "models"
    assert cli.main(["-m", "TRAINING", "-d", "synthetic", "-f", "2", "-sk", "1",
                     "--epochs", "0", "--base-width", "2", "--out-dir", str(out)] + CPU) == 0
    assert "Skipping fold 0" in capsys.readouterr().out
    assert not os.path.isdir(out / "synthetic" / "fold0")
    fold1 = out / "synthetic" / "fold1"
    assert os.path.isdir(fold1 / "models" / "latest")
    assert os.path.exists(fold1 / "progress" / "loss.out")
    metrics = [json.loads(line) for line in open(fold1 / "progress" / "metrics.jsonl")]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])

    images = synthetic_dataset(**FIXTURE).images
    (_, tr_idx, va_idx), = [s for s in jax_fold_splits(len(images), 2, 0, 0.2) if s[0] == 1]
    (out_dir, train, val, device), = seen
    assert out_dir == str(fold1) and device == torch.device("cpu")
    np.testing.assert_array_equal(train, images[tr_idx])
    np.testing.assert_array_equal(val, images[va_idx])


def test_start_from_resumes_nonzero_epoch(tmp_path, capsys):
    out = str(tmp_path / "models")
    base = ["-m", "TRAINING", "-d", "synthetic", "--base-width", "2", "--out-dir", out] + CPU
    assert cli.main(base + ["--epochs", "1", "--quiet"]) == 0
    prog = tmp_path / "models" / "synthetic" / "all" / "progress"
    assert len(open(prog / "loss.out").readlines()) == 2          # epochs 0..1
    capsys.readouterr()
    assert cli.main(base + ["--epochs", "3", "-sf"]) == 0
    assert "Resumed from epoch 1" in capsys.readouterr().out
    assert len(open(prog / "loss.out").readlines()) == 4
    metrics = [json.loads(line) for line in open(prog / "metrics.jsonl")]
    assert [m["epoch"] for m in metrics] == [0, 1, 2, 3]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The 'best' checkpoint of a base-width-2 run of epoch 0 on the fixture."""
    out = str(tmp_path_factory.mktemp("cli") / "models")
    assert cli.main(["-m", "TRAINING", "-d", "synthetic", "--epochs", "0",
                     "--base-width", "2", "--quiet", "--out-dir", out] + CPU) == 0
    return os.path.join(out, "synthetic", "all", "models", "best")


def test_train_then_test_roundtrip(trained):
    assert os.path.isdir(trained)
    assert cli.main(["-m", "TESTING", "-d", "synthetic", "-n", trained, "--quiet"] + CPU) == 0
    assert os.path.exists(trained + "_test/test_iou.out")
    (pred,) = read_tiff(trained + "_test/preds/pred0.tif")
    assert pred.shape == (256, 256) and set(np.unique(pred)) <= {0, 255}


def test_compile_cache_flags_are_accepted_and_ignored(trained, tmp_path):
    cache = tmp_path / "cache"
    assert cli.main(["-m", "TESTING", "-d", "synthetic", "-n", trained, "--quiet",
                     "--compile-cache", str(cache), "--no-compile-cache"] + CPU) == 0
    assert cli.main(["-m", "TESTING", "-d", "synthetic", "-n", trained, "--quiet",
                     "--compile-cache", str(cache)] + CPU) == 0
    assert not cache.exists()


@pytest.mark.parametrize("quant", ["int4", "int4-phase"])
def test_int4_raises_naming_the_roadmap_item(trained, quant):
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(["-m", "TESTING", "-d", "synthetic", "-n", trained, "--quiet",
                  "--quant", quant] + CPU)


def test_pallas_checkpoint_with_phase_level0_raises_in_both_clis(trained, tmp_path):
    """phase_level0 needs conv_impl 'xla' in both packages, and the flag is
    on by default: TESTING a 'pallas' checkpoint raises the same ValueError
    in both CLIs until --no-phase-level0 is passed."""
    ck = str(tmp_path / "models" / "best")
    shutil.copytree(trained, ck)
    hs = os.path.join(ck, "host_state.json")
    host = json.load(open(hs))
    host["model_cfg"]["conv_impl"] = "pallas"
    json.dump(host, open(hs, "w"))
    argv = ["-m", "TESTING", "-d", "synthetic", "-n", ck, "--quiet"] + CPU
    with pytest.raises(ValueError, match="phase_level0 requires conv_impl='xla'"):
        cli.main(argv)
    with pytest.raises(ValueError, match="phase_level0 requires conv_impl='xla'"):
        jax_cli.main(argv + ["--no-compile-cache"])
    assert cli.main(argv + ["--no-phase-level0"]) == 0
    assert os.path.exists(ck + "_test/preds/pred9.tif")


def _reference_pth(path, base_width, seed):
    """A reference-named state_dict (NAME_MAP's names, PyTorch layouts) of
    a narrow U-Net, drawn with numpy, saved as a .pth."""
    shapes = UNet(ModelConfig(base_width=base_width)).state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for ref_name, (name, _) in NAME_MAP.items():
        w = shapes[f"{name}.weight"].shape
        sd[f"{ref_name}.weight"] = torch.from_numpy(
            (rng.randn(*w) * np.sqrt(2.0 / np.prod(w[1:]))).astype(np.float32))
        sd[f"{ref_name}.bias"] = torch.from_numpy(
            (rng.randn(shapes[f"{name}.bias"].shape[0]) * 0.1).astype(np.float32))
    torch.save(sd, path)


def test_testing_a_reference_pth_matches_the_jax_cli(tmp_path):
    """Both CLIs serve one narrow reference .pth on the synthetic fixture
    (its seed gives both classes on every image, ~72% foreground, at small
    margins): exported images and labels equal, predictions equal on >= 0.9999 of
    the pixels and only where the port's top-2 logit margin is under 1e-4
    of the logit scale (summation order), IoU and pixel error within
    1e-4."""
    outs = {}
    for side, main in (("jax", jax_cli.main), ("port", cli.main)):
        os.makedirs(tmp_path / side)
        pth = str(tmp_path / side / "narrow.pth")
        _reference_pth(pth, base_width=4, seed=1)
        assert main(["-m", "TESTING", "-d", "synthetic", "-n", pth, "--base-width", "4",
                     "--quiet", "--no-compile-cache"] + CPU) == 0
        outs[side] = pth[:-4] + "_test"
    jax_out, port_out = outs["jax"], outs["port"]
    for sub in ("images", "labels", "preds"):
        assert sorted(os.listdir(os.path.join(jax_out, sub))) == \
            sorted(os.listdir(os.path.join(port_out, sub)))
    for name in ("test_iou.out", "test_pe.out"):
        np.testing.assert_allclose(np.loadtxt(os.path.join(port_out, name)),
                                   np.loadtxt(os.path.join(jax_out, name)), rtol=0, atol=1e-4)

    model = UNet(ModelConfig(skip_variant="parity", base_width=4))
    model.load_state_dict(load_reference_checkpoint(str(tmp_path / "port" / "narrow.pth")))
    data = synthetic_dataset(**FIXTURE)
    engine = TileInference(model, 256, 256)
    n_pixels = n_diff = 0
    for i in range(len(data)):
        for sub, stem in (("images", "image"), ("labels", "label")):
            (got,), (want,) = (read_tiff(os.path.join(d, sub, f"{stem}{i}.tif"))
                               for d in (port_out, jax_out))
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        (got,), (want,) = (read_tiff(os.path.join(d, "preds", f"pred{i}.tif"))
                           for d in (port_out, jax_out))
        assert set(np.unique(want)) == {0, 255}     # both classes: not a constant map
        diff = got != want
        n_pixels += diff.size
        n_diff += int(diff.sum())
        if diff.any():
            with torch.no_grad():
                logits = engine.predict_logits(data.images[i])
            top2 = logits.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1]).numpy()
            scale = float(logits.abs().max())
            assert (margin[diff] < 1e-4 * scale).all(), (i, margin[diff], scale)
    assert n_diff <= 1e-4 * n_pixels, (n_diff, n_pixels)
