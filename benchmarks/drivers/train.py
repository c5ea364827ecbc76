"""Training cells: `Trainer.run_epoch` over epochs of a fixed number of
steps, the losses read back once an epoch, as `Trainer.fit` does without
its validation and checkpoints.

Set-up builds one Trainer, loads the weights made from the seed, makes the
training frames from the seed, and drives the first steps through
`run_epoch` itself (one epoch of one step, then one of two), keeping what
the check needs; then one more epoch warms the rest. The window runs
epochs from that same Trainer for `--seconds`. After the window the
reference follows the checked steps (train_check.py).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmarks import generator, harness
from benchmarks.reference import lowp
from benchmarks.reference import train_check as tc
from benchmarks.reference import unet as ru
from benchmarks.reference.tiles import crop_input

#: Steps the reference follows: one epoch of one step, then one of two.
CHECKED_STEPS = 3
#: Epochs in each of the `--trace 1` run's two profiles.
TRACED_EPOCHS = 3


class TrainRun:
    def __init__(self, cell: dict, seed: int, device):
        from tpu_unet_torch.config import DATASETS, AugmentConfig, ModelConfig, TrainConfig
        from tpu_unet_torch.train.trainer import Trainer

        cfg, tr = cell["config"], cell["traffic"]
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mcfg = cfg["model"]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from tpu_unet_torch.ops import _build
            _build.load_library()
        harness.log(f"set-up: kernel library {time.perf_counter() - t0:.2f} s")
        ds = DATASETS[tr["dataset"]]
        self.trainer = Trainer(ds, ModelConfig(**self.mcfg),
                               TrainConfig(batch_size=tr["batch"], seed=seed),
                               aug_cfg=AugmentConfig(crop=tr["crop"]), verbose=False,
                               device=self.device)
        harness.log(f"set-up: trainer {time.perf_counter() - t0:.2f} s")
        self.params0 = ru.make_params(self.mcfg, harness.sub_seed(seed, "weights"), self.device)
        self.trainer.model.load_state_dict(self.params0)
        harness.log(f"set-up: trainer and weights {time.perf_counter() - t0:.2f} s")
        h, w = tr["frame_hw"]
        # a training set is fixed: every seed trains on the same frames, so
        # the work per step (components, objects) is the same from seed to seed
        gen = torch.Generator(device=self.device).manual_seed(tr["frames_seed"])
        images, inst = generator.make_frames(tr["train_frames"], h, w, tr["cells_per_frame"], gen)
        targets = generator.separated_targets(inst, tr["cells_per_frame"])
        aug = self.trainer.aug_cfg
        log_probs, pairs = generator.crop_distribution(
            targets, aug.crop, aug.crop_grid_skip, aug.crop_fg_lo, aug.crop_fg_hi,
            aug.crop_pdf_loc, aug.crop_pdf_scale)
        self.arrays = (images, targets, log_probs, pairs)
        self.rng = np.random.default_rng(harness.sub_seed(seed, "order"))
        self.n_frames, self.batch, self.steps = tr["train_frames"], tr["batch"], tr["steps_per_epoch"]
        harness.log(f"set-up: frames {time.perf_counter() - t0:.2f} s")
        self.epoch = 0
        self.failed = 0

    def order(self, steps: int) -> np.ndarray:
        return self.rng.permutation(self.n_frames)[:steps * self.batch].reshape(steps, self.batch)

    def run_epoch(self, order: np.ndarray) -> torch.Tensor:
        """One epoch through the program; its losses on the host."""
        losses, _ = self.trainer.run_epoch(self.arrays, order, self.epoch)
        self.epoch += 1
        losses = losses.cpu()
        if not bool(torch.isfinite(losses).all()):
            self.failed += len(order)
        return losses

    def checked_steps(self, n: int) -> dict:
        """The first `n` steps, one epoch of one step and one of n - 1, with
        what the check compares kept."""
        from tpu_unet_torch.train.trainer import make_train_step

        t = self.trainer
        rows = self.order(n)
        kept: dict = {"inp": [], "gt": [], "w": [], "steps": []}
        pipe, step, weight_fn = t.pipe, t.train_step, t.weight_fn

        def keep_pipe(*args):
            inp, gt = pipe(*args)
            kept["inp"].append(inp[..., 0].cpu().numpy())
            kept["gt"].append(gt.cpu().numpy())
            return inp, gt

        def keep_weights(gt):
            w = weight_fn(gt)
            kept["w"].append(w.cpu().numpy())
            return w

        t.pipe = keep_pipe
        t.train_step = make_train_step(t.model, keep_weights, t.loss_cfg.weight_broadcast, t.opt)
        try:
            losses = [self.run_epoch(rows[:1])]
            # no buffer: the optimizer never stepped, its first gradient is nought
            kept["g1"] = {name: t.opt.state[p].get("momentum_buffer", torch.zeros_like(p))
                          .detach().clone() for name, p in t.model.named_parameters()}
            losses.append(self.run_epoch(rows[1:]))
        finally:
            t.pipe, t.train_step = pipe, step
        kept["steps"] = [(0, 0, rows[0])] + [(1, b, r) for b, r in enumerate(rows[1:])]
        kept["loss"] = [float(v) for v in torch.cat(losses)]
        kept["theta"] = {name: p.detach().clone() for name, p in t.model.named_parameters()}
        return kept

    def free(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kept: dict, control: Optional[str] = None,
              half_batch: bool = False) -> Dict[str, float]:
        """The numbers `correct` compares. `control` ('fp8'): the reference
        in the lower precision in the program's place; `half_batch`: the
        reference with the fault of a loss over half the batch there."""
        images, targets, log_probs, pairs = self.arrays
        data = {"images": images.cpu().numpy(), "targets": targets.cpu().numpy(),
                "log_probs": log_probs, "pairs": pairs.cpu().numpy()}
        tr = self.cell["traffic"]
        aug = dict(tr["augment"], crop=tr["crop"],
                   size=crop_input(tr["crop"], self.mcfg["depth"]))
        loss, optim = tr["loss"], tr["optim"]
        ref = tc.reference_steps(self.params0, data, kept["steps"], self.seed, self.mcfg,
                                 aug, loss, optim, self.device)
        if control or half_batch:
            quant = lowp.for_config(self.cell["config"], control) if control else None
            kept = tc.reference_steps(self.params0, data, kept["steps"], self.seed, self.mcfg,
                                      aug, loss, optim, self.device, quant, half_batch)
        return tc.judge(kept, ref, self.params0, loss["w0"], loss)


def spans_for(run: TrainRun, spans: harness.Spans) -> None:
    from tpu_unet_torch.train.trainer import make_train_step

    t = run.trainer
    spans.wrap(t, "pipe", "augment")
    spans.wrap(t, "weight_fn", "weights")
    t.train_step = make_train_step(t.model, t.weight_fn, t.loss_cfg.weight_broadcast, t.opt)


def traced(cell: dict, run: TrainRun, epochs: int) -> dict:
    """Profile `epochs` epochs on the card alone, then as many on host and
    card with the spans; the cell's per-layer metrics and the breakdown."""
    with harness.profiled(host=False) as plain:
        for _ in range(epochs):
            run.run_epoch(run.order(run.steps))
    spans, step = harness.Spans(), run.trainer.train_step
    spans_for(run, spans)
    try:
        with harness.profiled() as prof:
            for _ in range(epochs):
                run.run_epoch(run.order(run.steps))
    finally:
        spans.restore()
        run.trainer.train_step = step
    steps = epochs * run.steps
    counters = {"steps": steps, "crops": steps * run.batch, "chips": 1}
    trace = harness.Trace(prof["events"], (plain["events"], plain["window_s"]), counters,
                          spans.calls, {"model": run.mcfg,
                                        "tile_in": crop_input(cell["traffic"]["crop"],
                                                              run.mcfg["depth"])})
    return {"metrics": harness.per_layer(cell, trace), "breakdown": harness.breakdown(trace),
            "busy_s": trace.busy_s, "window_s": trace.window_s}


def run(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", control: Optional[str] = None) -> dict:
    r = TrainRun(cell, seed, device)
    kept = r.checked_steps(CHECKED_STEPS)
    r.run_epoch(r.order(r.steps))                     # warm-up
    if r.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up: done {setup_s:.2f} s")
    out: dict = {}
    if trace:
        out = traced(cell, r, TRACED_EPOCHS)
    steps, start, epochs = 0, time.perf_counter(), []
    while True:
        t = time.perf_counter()
        r.run_epoch(r.order(r.steps))
        epochs.append(time.perf_counter() - t)
        steps += r.steps
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            break
    q = np.percentile(epochs, [0, 25, 50, 75, 100]) * 1e3 / r.steps
    harness.log("window: ms a step by epoch, min q1 median q3 max: "
                + " ".join(f"{v:.2f}" for v in q))
    peak = torch.cuda.max_memory_allocated() if r.device.type == "cuda" else 0
    r.free()
    t = time.perf_counter()
    numbers = r.check(kept, control)
    harness.log(f"check: {time.perf_counter() - t:.2f} s")
    e2e = {"train_crops_per_s": (steps - r.failed) * r.batch / elapsed, "setup_s": setup_s}
    return {"attempted": steps, "failed": r.failed, "e2e": e2e, "numbers": numbers,
            "memory_peak": peak, "trace": out}


def readings(cell: dict, seed: int, control: str, device="cuda") -> dict:
    """The program's numbers, the control's and the half-batch fault's on
    the checked steps of `seed`, without a window (control.py)."""
    r = TrainRun(cell, seed, device)
    kept = r.checked_steps(CHECKED_STEPS)
    r.free()
    return {"program": r.check(kept), "control": r.check(kept, control),
            "half_batch": r.check(kept, half_batch=True)}
