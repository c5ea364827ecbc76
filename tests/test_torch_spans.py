"""The port's own profiler spans (`utils/profiling.py::span`): the tile
engine's (`tiles.*`), the int8 tier's (`quant.*`) and the training step's
(`train.*`) land in `trace_capture`'s Chrome trace, nested as the work is,
change no number the program computes, open nothing outside a profile, and
never open inside the five calls a caller may wrap in ranges of its own (K1,
K3, the mesh gather, the augmentation and the weight maps)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpu_unet_torch.infer.quant as quant
import tpu_unet_torch.infer.tiles as tiles
import tpu_unet_torch.models.unet as unet
from tpu_unet_torch.config import AugmentConfig, DatasetConfig, LossConfig, ModelConfig, TrainConfig
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.infer.quant import build_quant_inference
from tpu_unet_torch.infer.tiles import TileInference
from tpu_unet_torch.models import UNet
from tpu_unet_torch.train.trainer import Trainer, make_train_step
from tpu_unet_torch.utils import profiling
from tpu_unet_torch.utils.profiling import span, trace_capture

ENGINE = ("tiles.upload", "tiles.cut", "tiles.argmax", "tiles.stitch", "tiles.metrics")
PROGRAM = ("tiles.", "quant.", "train.")


def _ranges(log_dir):
    """(name, start, end, tid) of every `record_function` range written to
    `{log_dir}/trace.json`."""
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"))
            for e in events if e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _engine(mesh=None):
    model = UNet(ModelConfig(base_width=2, conv_impl="pallas"),
                 generator=torch.Generator().manual_seed(5))
    return TileInference(model, 60, 60, tile_out=36, batch_tiles=4, mesh=mesh)


def _frames(n=2):
    rng = np.random.RandomState(7)
    return rng.rand(n, 60, 60).astype(np.float32), (rng.rand(n, 60, 60) > 0.5).astype(np.uint8)


def _quant_engine(impl):
    model = UNet(ModelConfig(base_width=8), generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.RandomState(4).rand(1, 188, 188, 1).astype(np.float32))
    return build_quant_inference(model, x, min_channels=16, impl=impl), x


def _trainer():
    ds = DatasetConfig(name="synthetic", crop=20, metric="iou", weight_mode="distance",
                       goal=0.999, goal_direction="max")
    return Trainer(ds, model_cfg=ModelConfig(base_width=2, conv_impl="pallas"),
                   train_cfg=TrainConfig(batch_size=2),
                   aug_cfg=AugmentConfig(crop=20),
                   loss_cfg=LossConfig(weight_mode="distance", max_objects=8),
                   verbose=False, device="cpu")


def _train_arrays():
    data = synthetic_dataset(n_images=4, h=64, w=64, n_cells=3, crop=20, seed=0)
    arrays = tuple(torch.from_numpy(a) for a in (data.images, data.targets,
                                                  data.crop_log_probs, data.crop_pairs))
    return arrays, np.arange(4).reshape(2, 2)


def test_evaluate_batch_spans_and_the_same_results(tmp_path):
    engine = _engine()
    frames, labels = _frames()
    metrics, maps = engine.evaluate_batch(frames, labels)
    with trace_capture(str(tmp_path)):
        got = [engine.evaluate_batch(frames, labels) for _ in range(2)]
    for m, p in got:
        torch.testing.assert_close(m, metrics, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(p, maps, rtol=0, atol=0)
    ranges = _ranges(tmp_path)
    calls = _named(ranges, "tiles.evaluate")
    assert len(calls) == 2
    for call in calls:
        inner = {r[0] for r in ranges if r is not call and _inside(r, call)}
        assert set(ENGINE) <= inner, inner
        # the frames' upload and the labels'
        assert len([r for r in _named(ranges, "tiles.upload") if _inside(r, call)]) == 2
    assert all(any(_inside(r, c) for c in calls) for r in ranges if r[0] in ENGINE)


def test_quant_apply_spans_and_the_same_logits(tmp_path):
    qi, x = _quant_engine("xla")
    want = qi.apply(x)
    with trace_capture(str(tmp_path)):
        got = qi.apply(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    names = [r[0] for r in _ranges(tmp_path)]
    # each decoder level dequantizes before its upconv and builds its
    # concat in int8
    assert names.count("quant.convert") >= 2 * qi.qp.cfg.depth, names
    # once for each float conv, each upconv and the head
    assert names.count("quant.float") == len(qi.qp.fconv), names
    assert not [n for n in names if n.startswith(PROGRAM) and not n.startswith("quant.")]


def test_run_epoch_spans_and_the_same_losses(tmp_path):
    arrays, order = _train_arrays()
    want, want_m = _trainer().run_epoch(arrays, order, 0)
    with trace_capture(str(tmp_path)):
        got, got_m = _trainer().run_epoch(arrays, order, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_m, want_m, rtol=0, atol=0, equal_nan=True)
    names = [r[0] for r in _ranges(tmp_path)]
    # one forward a batch; the step's other work opens no span of its own
    assert names.count("train.forward") == len(order), names
    assert not [n for n in names if n.startswith(PROGRAM) and n != "train.forward"], names


def test_no_span_outside_a_profile():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("tiles.cut"), span("train.forward")
    assert a is b is profiling._NO_SPAN
    with a:
        pass
    with trace_capture() as prof:
        assert span("tiles.cut") is not profiling._NO_SPAN
    assert not [e for e in prof.events() if e.name.startswith(PROGRAM)]


def test_no_span_in_a_profile_of_the_card_alone(monkeypatch):
    """Every profiler session starts through the wrapped
    `profile._start_trace`, which notes whether it records the host; a
    session that does not (`use_cpu` False: the card's activity alone)
    opens no range."""
    start_trace = torch.autograd.profiler.profile._start_trace
    assert start_trace.__wrapped__ is not None
    started = []
    noting = profiling._noting_host_activity(started.append)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(profiling, "_records_host", True)
    card_only, host = SimpleNamespace(use_cpu=False), SimpleNamespace(use_cpu=True)
    noting(card_only)
    assert span("tiles.cut") is profiling._NO_SPAN
    noting(host)
    assert isinstance(span("tiles.cut"), profiling._Range)
    assert started == [card_only, host]


@pytest.fixture
def one_rank_mesh(tmp_path):
    from tpu_unet_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(axes=("data",), shape=(1,), device="cpu")
    finally:
        dist.destroy_process_group()


def test_no_span_opens_inside_a_wrapped_call(tmp_path, monkeypatch, one_rank_mesh):
    """Each of the five calls replaced, as a benchmark's harness replaces
    them, by itself inside a marker range: every marker is reached, and no
    program range lies inside a marker's."""
    markers = []

    def wrap(owner, attr, marker):
        fn = getattr(owner, attr)
        markers.append(marker)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(marker):
                return fn(*args, **kwargs)
        monkeypatch.setattr(owner, attr, wrapped)

    wrap(unet, "conv3x3_bias_relu", "k1")
    wrap(quant, "conv3x3_fused", "k3")
    wrap(tiles, "all_gather_cat", "gather")
    engine = _engine(mesh=one_rank_mesh)
    qi, x = _quant_engine("pallas")
    arrays, order = _train_arrays()
    t = _trainer()
    wrap(t, "pipe", "augment")
    wrap(t, "weight_fn", "weights")
    t.train_step = make_train_step(t.model, t.weight_fn, t.loss_cfg.weight_broadcast, t.opt)
    with trace_capture(str(tmp_path)):
        engine.evaluate_batch(*_frames(1))
        qi.apply(x)
        t.run_epoch(arrays, order, 0)
    ranges = _ranges(tmp_path)
    program = [r for r in ranges if r[0].startswith(PROGRAM)]
    assert program
    for marker in markers:
        calls = _named(ranges, marker)
        assert calls, marker
        assert not [r for r in program for c in calls if _inside(r, c)], marker
