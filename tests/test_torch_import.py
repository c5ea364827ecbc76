"""The port imports no JAX: a fresh interpreter imports tpu_unet_torch, runs
a tiny evaluate(), and finds no `jax` module loaded."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import tpu_unet_torch
from tpu_unet.config import ModelConfig
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.infer import evaluate
from tpu_unet_torch.models import UNet

model = UNet(ModelConfig(base_width=2, conv_impl="pallas"))
data = synthetic_dataset(n_images=2, h=48, w=48, n_cells=2, crop=20, seed=1)
result = evaluate(model, data, tile_out=36, verbose=False)
assert result["num_images"] == 2, result
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_module_of_the_port_imports_jax_or_triton():
    """No source file of tpu_unet_torch names jax, flax or triton in an
    import, so no import of the package can reach them."""
    banned = {"jax", "flax", "optax", "triton"}
    for path in (REPO / "tpu_unet_torch").rglob("*.py"):
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
