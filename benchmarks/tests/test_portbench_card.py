"""On the card: one short run of each one-card cell through the command,
which has to end with a result line that reads correct. Run there with
``python -m pytest -m cuda benchmarks/tests/test_portbench_card.py``."""

import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-bf16-4x512", "serve-int8-4x512", "train-hela-b8"])
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, os.path.join("benchmarks", "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 17), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line["checks"]
