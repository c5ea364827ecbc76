"""The port imports no JAX and nothing of the JAX package: a fresh
interpreter imports every module of tpu_unet_torch, runs a tiny evaluate()
(float with its TIFF export, int8 and int8-phase), the phase-packed model, a
tiny research int8 forward (fused and paired), a tiny Trainer.fit() and the
CLI's TESTING of its checkpoint, and finds no `jax`, `triton`, `tpu_unet` or
`PIL` module loaded and no kernel library built."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, os, pkgutil, sys, tempfile
import tpu_unet_torch
from tpu_unet_torch.ops import _build

for mod in pkgutil.walk_packages(tpu_unet_torch.__path__, "tpu_unet_torch."):
    importlib.import_module(mod.name)
assert _build._lib is None, "a kernel library was loaded at import"
walked = {"tpu_unet_torch.ops.gather", "tpu_unet_torch.ops.enc0_stages",
          "tpu_unet_torch.probes.gather_probe", "tpu_unet_torch.probes.mosaic_probe",
          "tpu_unet_torch.cli", "tpu_unet_torch.data.download", "tpu_unet_torch.data.tiff",
          "tpu_unet_torch.ops.morphology", "tpu_unet_torch.utils.profiling",
          "tpu_unet_torch.utils.debug"}
assert walked <= set(sys.modules), walked - set(sys.modules)

from tpu_unet_torch.config import DatasetConfig, ModelConfig, TrainConfig
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.infer import evaluate
from tpu_unet_torch.models import UNet
from tpu_unet_torch.train import Trainer

model = UNet(ModelConfig(base_width=2, conv_impl="pallas"))
data = synthetic_dataset(n_images=2, h=48, w=48, n_cells=2, crop=20, seed=1)
out = tempfile.mkdtemp()
result = evaluate(model, data, tile_out=36, verbose=False, output_dir=out)
assert result["num_images"] == 2, result
from tpu_unet_torch.data.tiff import read_tiff
assert read_tiff(os.path.join(out, "preds", "pred1.tif"))[0].shape == (48, 48)
qpath = os.path.join(tempfile.mkdtemp(), "qp.npz")
wide = UNet(ModelConfig(base_width=8, conv_impl="pallas"))
result = evaluate(wide, data, tile_out=36, verbose=False, quant="int8", quant_path=qpath)
assert os.path.exists(qpath) and result["num_images"] == 2, result
result = evaluate(wide, data, tile_out=36, verbose=False, quant="int8-phase",
                  quant_path=qpath)
assert result["num_images"] == 2, result
import torch
phase = UNet(ModelConfig(base_width=2, phase_level0=True))
assert phase(torch.rand((1, 188, 188, 1))).shape == (1, 4, 4, 2)
from tpu_unet_torch.infer.quant import (add_concat_scales, calibrate, default_quant_names,
                                        prepare_quant_params)
from tpu_unet_torch.infer.quant_research import ResearchQuantInference
x = torch.rand((2, 188, 188, 1), generator=torch.Generator().manual_seed(0))
qp = prepare_quant_params(wide.cfg, wide, add_concat_scales(wide.cfg, calibrate(wide, x)),
                          default_quant_names(wide.cfg, 16))
for flags in ({"fused_enc0": True, "fused_concat": True}, {"pair_level0": True}):
    y = ResearchQuantInference(qp, device="cpu", **flags).apply(x)
    assert y.shape == (2, 4, 4, 2) and bool(torch.isfinite(y).all()), flags
ds = DatasetConfig(name="s", crop=20, metric="iou", weight_mode="distance",
                   goal=1.0, goal_direction="max")
run = tempfile.mkdtemp()
history = Trainer(ds, ModelConfig(base_width=2, conv_impl="pallas"),
                  TrainConfig(batch_size=2), out_dir=run,
                  verbose=False, device="cpu").fit(data, data, epochs=0)
assert len(history["loss"]) == 1, history
from tpu_unet_torch import cli
best = os.path.join(run, "models", "best")
assert cli.main(["-m", "TESTING", "-d", "synthetic", "-n", best, "--quiet",
                 "--platform", "cpu", "--no-phase-level0"]) == 0
assert os.path.exists(os.path.join(best + "_test", "preds", "pred9.tif"))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "triton", "tpu_unet", "PIL"))
assert not loaded, loaded
assert _build._lib is None and not os.path.exists(_build.library_path())
print("OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_module_of_the_port_imports_jax_or_triton():
    """No source file of tpu_unet_torch, and not chip_smoke.py, names jax,
    flax, optax, triton, PIL or the JAX package tpu_unet in an import, so no
    import of the port can reach them."""
    banned = {"jax", "flax", "optax", "triton", "tpu_unet", "PIL"}
    paths = sorted((REPO / "tpu_unet_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(paths) > 30
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
