"""`correct` has to come out false for the control and for each fault a
cell can have: the run's harness is driven on the CPU at a small size (the
look for a card skipped), with the timed path broken underneath."""

import os
import time

import pytest
import torch

from benchmarks import harness
from benchmarks.tests.tiny import SERVE, tiny_cell


def _run(cell, seed=2 ** 31 + 21, control=None, seconds=5.0):
    # a window long enough that both sampled requests are served on a CPU
    # shared with other test workers: one never sent reads as never come
    out = harness.load_driver(cell["traffic"]["driver"]).run(
        cell, seed, seconds, False, time.perf_counter(), device="cpu", control=control)
    ok, checks = harness.judge(out["numbers"], harness.limits(cell))
    return ok and out["failed"] == 0 and out["attempted"] > 0, out["numbers"]


@pytest.mark.parametrize("name", ["serve-bf16-4x512", "serve-int8-4x512"])
def test_serving_sound_and_control(name):
    cell = tiny_cell(name)
    ok, numbers = _run(cell)
    assert ok, numbers
    ok, numbers = _run(cell, control=cell["config"]["control"])
    assert not ok and numbers["logit_err_vs_control"] == pytest.approx(1.0, rel=1e-3)


def test_serving_answer_altered_where_produced(monkeypatch):
    from tpu_unet_torch.infer.tiles import TileInference

    evaluate = TileInference.evaluate_batch

    def flip_one_pixel(self, images, labels):
        metrics, maps = evaluate(self, images, labels)
        maps = maps.clone()
        maps[0, 3, 3] = 1 - maps[0, 3, 3]
        return metrics, maps

    monkeypatch.setattr(TileInference, "evaluate_batch", flip_one_pixel)
    ok, numbers = _run(tiny_cell("serve-bf16-4x512"))
    assert not ok and numbers["map_vs_own_logits"] >= 1


def test_serving_metric_altered_where_produced(monkeypatch):
    import tpu_unet_torch.infer.tiles as tiles

    real = tiles.batch_evaluation_metrics
    monkeypatch.setattr(tiles, "batch_evaluation_metrics", lambda p, l: real(p, l) * 1.001)
    ok, numbers = _run(tiny_cell("serve-bf16-4x512"))
    assert not ok and numbers["metrics_off"] >= 1


def _mesh_cell():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.make_cell(bench, {"name": "mesh", "config": "unet2015-bf16",
                                     "traffic": "serve-16x512-mesh4", "chips": 2})
    cell["config"]["model"]["base_width"] = 8
    cell["traffic"].update(SERVE, frames_per_request=4, batch_tiles=36)
    return cell


def test_mesh_sound_and_exchange_left_out(tmp_path, monkeypatch):
    ok, numbers = _run(_mesh_cell(), seconds=1.0)
    assert ok, numbers
    (tmp_path / "sitecustomize.py").write_text(
        "import torch\n"
        "import tpu_unet_torch.infer.tiles as tiles\n"
        "from tpu_unet_torch.parallel.mesh import axis_size\n"
        "tiles.all_gather_cat = lambda t, mesh, axis: torch.cat([t] * axis_size(mesh, axis))\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    ok, numbers = _run(_mesh_cell(), seconds=1.0)
    assert not ok and numbers["map_vs_own_logits"] >= 1


def test_training_control_and_faults(monkeypatch):
    import tpu_unet_torch.train.trainer as trainer

    cell = tiny_cell("train-hela-b8")
    _, sound = _run(cell)
    limits = harness.limits(cell)
    assert sound["loss_rel_err"] < limits["loss_rel_err"]
    ok, numbers = _run(cell, control="fp8")
    assert not ok
    # the first gradient's gap is reported, not compared: the control does
    # not read three times the program's largest on the card
    assert "grad_norm_err" in numbers and "grad_norm_err" not in limits
    assert numbers["update_norm_err"] > limits["update_norm_err"]

    real = trainer.weighted_bce_with_logits

    def half_batch(logits, labels, weights, broadcast="intended", reduction="mean"):
        n = max(1, logits.shape[0] // 2)
        return real(logits[:n], labels[:n], weights[:n], broadcast, reduction)

    with monkeypatch.context() as m:
        m.setattr(trainer, "weighted_bce_with_logits", half_batch)
        ok, numbers = _run(cell)
    assert not ok and numbers["loss_rel_err"] > limits["loss_rel_err"]

    with monkeypatch.context() as m:
        m.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
        ok, numbers = _run(cell)
    assert not ok and numbers["update_norm_err"] == pytest.approx(1.0)
