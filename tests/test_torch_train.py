"""The port's training path (tpu_unet_torch/train/, the K1 gradient, remat)
against the JAX package on the same weights and numpy inputs: the
autograd.Function's gradients against the custom VJP of the Pallas kernel
(interpret mode), one train step's loss and gradients against JAX's
`make_train_step`, the plateau scheduler and SGD against torch's own, and
`Trainer.fit` end to end with resume and goal stops, mirroring
tests/test_train.py."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_unet.config import OptimConfig as JaxOptimConfig
from tpu_unet.models import UNet as JaxUNet
from tpu_unet.ops.conv_pallas import conv3x3_bias_relu as jax_conv
from tpu_unet.train.optimizer import make_optimizer as jax_make_optimizer
from tpu_unet.train.trainer import TrainState
from tpu_unet.train.trainer import make_train_step as jax_make_train_step
from tpu_unet.losses.weights import make_weight_fn as jax_make_weight_fn
from tpu_unet_torch.config import (AugmentConfig, DatasetConfig, LossConfig, ModelConfig,
                                   OptimConfig, TrainConfig)
from tpu_unet_torch.convert import state_dict_from_jax_params
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.losses.weights import make_weight_fn
from tpu_unet_torch.models import UNet
from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
from tpu_unet_torch.train import (Trainer, make_optimizer, plateau_init, plateau_step,
                                  set_learning_rate)
from tpu_unet_torch.train.checkpoint import Checkpointer
from tpu_unet_torch.train.trainer import make_train_step
from tests.test_torch_model import jax_config, numpy_params


def _scale_close(got, expected, tol):
    got, expected = np.asarray(got, np.float32), np.asarray(expected, np.float32)
    assert got.shape == expected.shape
    scale = max(np.abs(expected).max(), 1e-30)
    assert np.abs(got - expected).max() <= tol * scale, (
        np.abs(got - expected).max(), scale)


# ------------------------------------------------------------ K1 gradient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout", [((2, 13, 16, 4), 8), ((1, 10, 34, 16), 32),
                                        ((2, 12, 15, 1), 8)])
def test_conv_gradient_matches_jax_custom_vjp(shape, cout, dtype):
    """dx, dw, db of the autograd.Function against jax.vjp through the
    Pallas kernel's custom VJP: f32 at rtol 1e-4; bf16 at 2e-2 of each
    gradient's scale (the two round to bf16 at other places)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], cout) * 0.3).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(shape[0], shape[1] - 2, shape[2] - 2, cout).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in (x, w, b)]
    _, vjp = jax.vjp(lambda *a: jax_conv(*a, interpret=True), *jargs)
    expected = vjp(jnp.asarray(g, jdt))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, w, b)]
    conv3x3_bias_relu(*targs).backward(torch.from_numpy(g).to(tdt))
    for t, e in zip(targs, expected):
        assert t.grad.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), rtol=1e-4,
                                       atol=1e-4 * np.abs(np.asarray(e)).max())
        else:
            _scale_close(t.grad.float().numpy(), np.asarray(e, np.float32), 2e-2)


@pytest.mark.parametrize("conv_impl", ["pallas", "xla"])
def test_remat_gives_the_same_gradients(conv_impl):
    cfg = ModelConfig(base_width=2, conv_impl=conv_impl)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 188, 188, 1).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = UNet(ModelConfig(**{**cfg.__dict__, "remat": remat}),
                     generator=torch.Generator().manual_seed(4))
        model(x).square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


# -------------------------------------------------------------- train step


def _blob_labels(b, n, size, seed):
    rng = np.random.RandomState(seed)
    out = np.zeros((b, size, size), np.int32)
    yy, xx = np.mgrid[0:size, 0:size]
    for k in range(b):
        for _ in range(n):
            cy, cx, r = rng.randint(0, size), rng.randint(0, size), rng.randint(1, 4)
            out[k][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    return out


@pytest.mark.parametrize("conv_impl,base_width", [("pallas", 2), ("xla", 4)])
def test_train_step_matches_jax(conv_impl, base_width):
    """One step from the same weights and batch, distance weight maps: the
    loss at rtol 1e-4, and the gradients (the momentum buffers after one
    step, against optax's trace) at 1e-4 of each tensor's scale. The
    updated params are not compared: at lr 1e-4 they would hide any
    gradient error. 'xla' trains the split-concat decoder convs."""
    cfg = ModelConfig(base_width=base_width, conv_impl=conv_impl)
    inp = np.random.RandomState(2).rand(2, 380, 380, 1).astype(np.float32)
    gt = _blob_labels(2, 5, 20, 3)
    jmodel = JaxUNet(jax_config(cfg))
    params = numpy_params(jmodel, 380, 5)
    tx = jax_make_optimizer(JaxOptimConfig())
    jstep = jax_make_train_step(jmodel, jax_make_weight_fn("distance", max_objects=8),
                                "intended", tx)
    jstate, jloss, jmetrics = jstep(TrainState(params, tx.init(params)),
                                    jnp.asarray(inp), jnp.asarray(gt))
    trace = state_dict_from_jax_params(jstate.opt_state.inner_state[0].trace)

    model = UNet(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    opt = make_optimizer(model.parameters(), OptimConfig())
    step = make_train_step(model, make_weight_fn("distance", max_objects=8),
                           "intended", opt)
    loss, metrics = step(torch.from_numpy(inp), torch.from_numpy(gt))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics), rtol=1e-6)
    for name, p in model.named_parameters():
        _scale_close(opt.state[p]["momentum_buffer"].numpy(), trace[name].numpy(), 1e-4)


# ------------------------------------------------ scheduler and optimizer


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plateau_matches_torch(seed):
    cfg = OptimConfig(lr=0.1, plateau_factor=0.5, plateau_patience=3,
                      plateau_threshold=1e-3, plateau_eps=1e-8)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=cfg.lr)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=cfg.plateau_factor, patience=cfg.plateau_patience,
        threshold=cfg.plateau_threshold, threshold_mode="rel", eps=cfg.plateau_eps)
    state = plateau_init(cfg)
    rng = np.random.RandomState(seed)
    metric = 1.0
    for step in range(60):
        if rng.rand() < 0.15:
            metric *= 0.8
        sched.step(metric)
        state, _ = plateau_step(state, metric, cfg)
        assert state.lr == pytest.approx(opt.param_groups[0]["lr"], rel=1e-9), step


def test_plateau_eps_floor():
    cfg = OptimConfig(lr=1e-7, plateau_factor=0.1, plateau_patience=0,
                      plateau_eps=1e-7)
    state, _ = plateau_step(plateau_init(cfg), 1.0, cfg)
    state, reduced = plateau_step(state, 1.0, cfg)
    assert state.lr == 1e-7 and not reduced


def test_sgd_momentum_and_lr_match_optax():
    """The port's SGD against the JAX package's optax SGD over five steps,
    with the learning rate changed before the last (set_learning_rate)."""
    w0 = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    grads = [np.random.RandomState(i + 1).randn(4, 3).astype(np.float32)
             for i in range(5)]
    cfg = OptimConfig(lr=0.01, momentum=0.99)
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer([p], cfg)
    from tpu_unet.train.optimizer import set_learning_rate as jax_set_lr

    tx = jax_make_optimizer(jax_config(cfg, JaxOptimConfig))
    params = jnp.asarray(w0)
    state = tx.init(params)
    for k, g in enumerate(grads):
        if k == 4:
            set_learning_rate(opt, 0.05)
            state = jax_set_lr(state, 0.05)
        p.grad = torch.tensor(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = params + updates
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-5,
                               atol=1e-6)
    assert opt.param_groups[0]["lr"] == 0.05


# --------------------------------------------------------------------- fit


def _ds(goal=0.999, weight_mode="class_balance", name="synthetic"):
    return DatasetConfig(name=name, crop=20, metric="iou", weight_mode=weight_mode,
                         goal=goal, goal_direction="max")


def _trainer(tmp_path, ds=None, conv_impl="xla", **train):
    ds = ds or _ds()
    return Trainer(ds, model_cfg=ModelConfig(base_width=2, conv_impl=conv_impl),
                   train_cfg=TrainConfig(**{"batch_size": 2, "checkpoint_every": 1,
                                            **train}),
                   aug_cfg=AugmentConfig(crop=20),
                   loss_cfg=LossConfig(weight_mode=ds.weight_mode, max_objects=8),
                   out_dir=str(tmp_path / "run"), verbose=False, device="cpu")


def test_fit_synthetic_end_to_end(tmp_path):
    """Distance weights and the kernel's path (its plain version here)."""
    data = synthetic_dataset(n_images=4, h=64, w=64, n_cells=3, crop=20, seed=0)
    history = _trainer(tmp_path, _ds(weight_mode="distance"), conv_impl="pallas"
                       ).fit(data, data, epochs=2)
    assert len(history["loss"]) == 3 and all(np.isfinite(history["loss"]))
    for f in ["train_eval_iou.out", "train_eval_pe.out", "val_eval_iou.out",
              "val_eval_pe.out", "loss.out", "loss_val.out", "metrics.jsonl"]:
        assert os.path.exists(tmp_path / "run" / "progress" / f)
    assert os.path.isdir(tmp_path / "run" / "models" / "latest")


def test_fit_resume(tmp_path):
    data = synthetic_dataset(n_images=2, h=64, w=64, n_cells=2, crop=20, seed=1)
    hist1 = _trainer(tmp_path, epochs=1).fit(data, data, epochs=1)
    hist = _trainer(tmp_path, epochs=1).fit(data, data, epochs=3, resume=True)
    assert len(hist["loss"]) == 4
    assert hist["loss"][:2] == pytest.approx(hist1["loss"], rel=1e-6)


def test_fit_double_resume(tmp_path):
    data = synthetic_dataset(n_images=2, h=64, w=64, n_cells=2, crop=20, seed=1)
    hist1 = _trainer(tmp_path).fit(data, data, epochs=1)
    hist2 = _trainer(tmp_path).fit(data, data, epochs=3, resume=True)
    hist3 = _trainer(tmp_path).fit(data, data, epochs=5, resume=True)
    assert len(hist3["loss"]) == 6
    assert hist2["loss"][:2] == pytest.approx(hist1["loss"], rel=1e-6)
    assert hist3["loss"][:4] == pytest.approx(hist2["loss"], rel=1e-6)
    curve = np.loadtxt(tmp_path / "run" / "progress" / "loss.out")
    assert curve == pytest.approx(np.asarray(hist3["loss"]), rel=1e-6)
    with open(tmp_path / "run" / "progress" / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == list(range(6))


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """One image fills each batch the same way in every epoch, so the
    resumed epochs see the batches of the uninterrupted run: params,
    momentum, LR and the (seed, epoch, batch) draws make them equal."""
    data = synthetic_dataset(n_images=1, h=64, w=64, n_cells=2, crop=20, seed=3)
    whole = _trainer(tmp_path / "a").fit(data, data, epochs=2)
    _trainer(tmp_path / "b").fit(data, data, epochs=0)
    resumed = _trainer(tmp_path / "b").fit(data, data, epochs=2, resume=True)
    assert resumed["loss"] == whole["loss"]
    assert resumed["loss_val"] == whole["loss_val"]


def test_fit_stops_on_goal(tmp_path):
    data = synthetic_dataset(n_images=2, h=64, w=64, n_cells=2, crop=20, seed=2)
    trainer = _trainer(tmp_path, _ds(goal=-1.0, name="synthgoal"), epochs=10,
                       checkpoint_every=100, stop_on_goal=True, goal_patience=2)
    history = trainer.fit(data, data, epochs=10)
    assert len(history["loss"]) == 3, history["loss"]
    assert os.path.isdir(tmp_path / "run" / "models" / "goal_synthgoal")


def test_folds_and_eval_arrays_match_jax():
    """`fold_splits`/`subset` and `prepare_eval_arrays` (square crop,
    mirror pad, normalisation) against the JAX package's."""
    from tpu_unet.data.synthetic import synthetic_dataset as jax_synthetic
    from tpu_unet.train.folds import fold_splits as jax_folds
    from tpu_unet.train.trainer import prepare_eval_arrays as jax_prepare
    from tpu_unet_torch.train.folds import fold_splits, subset
    from tpu_unet_torch.train.trainer import prepare_eval_arrays

    for (f, tr, va), (jf, jtr, jva) in zip(fold_splits(11, 4, 3), jax_folds(11, 4, 3)):
        assert f == jf and tr.tolist() == jtr.tolist() and va.tolist() == jva.tolist()
    data = synthetic_dataset(n_images=3, h=40, w=56, n_cells=2, crop=20, seed=4)
    part = subset(data, np.array([2, 0]), "-val")
    assert part.name.endswith("-val") and np.array_equal(part.images, data.images[[2, 0]])
    inp, lab = prepare_eval_arrays(part)
    jinp, jlab = jax_prepare(jax_synthetic(n_images=3, h=40, w=56, n_cells=2, crop=20,
                                           seed=4))
    np.testing.assert_allclose(inp, jinp[[2, 0]], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(lab, jlab[[2, 0]])


# ------------------------------------------------------- async checkpoints


def test_save_async_copies_at_queue_time_and_latest_wins(tmp_path, monkeypatch):
    """A queued save writes the values of when it was queued, though the
    tensor is updated in place before the write; later saves of a tag
    replace a pending one (coalescing), and the newest one is on disk."""
    ckpt = Checkpointer(str(tmp_path / "models"))
    orig_save = Checkpointer.save
    gate = threading.Event()
    saved = []

    def slow_save(self, tag, state, host_state):
        gate.wait(10)
        time.sleep(0.01)
        saved.append(host_state["epoch"])
        return orig_save(self, tag, state, host_state)

    monkeypatch.setattr(Checkpointer, "save", slow_save)
    w = torch.zeros(4)
    ckpt.save_async("latest", {"w": w}, {"epoch": 0})
    w.add_(1.0)                                 # the next step, in place
    for epoch in range(1, 20):
        ckpt.save_async("best", {"w": w}, {"epoch": epoch})
        w.add_(1.0)
    gate.set()
    ckpt.wait()
    state, host = ckpt.restore("latest")
    assert host["epoch"] == 0 and torch.equal(state["w"], torch.zeros(4))
    state, host = ckpt.restore("best")
    assert host["epoch"] == 19 and torch.equal(state["w"], torch.full((4,), 19.0))
    assert saved.count(0) == 1 and len(saved) < 20 and saved[-1] == 19


def test_save_async_wait_reraises(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path / "models"))

    def boom(self, tag, state, host_state):
        raise RuntimeError("disk full")

    monkeypatch.setattr(Checkpointer, "save", boom)
    ckpt.save_async("best", {"x": torch.zeros(2)}, {"epoch": 0})
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt.wait()
    monkeypatch.undo()
    ckpt.save_async("best", {"x": torch.ones(2)}, {"epoch": 1})
    state, host = ckpt.restore("best")
    assert host["epoch"] == 1 and torch.equal(state["x"], torch.ones(2))
    assert ckpt.exists("best") and not ckpt.exists("latest")
