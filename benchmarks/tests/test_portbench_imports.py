"""Nothing under benchmarks/ imports JAX, Flax or the JAX package, and the
references import nothing of the program; names are compared whole, by
their top-level part, so tpu_unet_torch is not tpu_unet."""

import ast
import os
import subprocess
import sys

import pytest

from benchmarks import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.HERE) for f in fs
               if f.endswith(".py") and "__pycache__" not in d)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_and_a_reference_of_its_own(path):
    names = set(_top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "tpu_unet"}, names
    if os.sep + "reference" + os.sep in path:
        assert "tpu_unet_torch" not in names, names


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); from benchmarks import harness; "
            "[harness.load_driver(d) for d in ('serve', 'train', 'serve_mesh')]; "
            "import tpu_unet_torch.infer.tiles, tpu_unet_torch.train.trainer, "
            "tpu_unet_torch.infer.quant, tpu_unet_torch.parallel.mesh; "
            "print(harness.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_or_the_program_no_result(tmp_path):
    """With no card, or in a directory that holds only the benchmark, the
    command exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "serve-bf16-4x512",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout
