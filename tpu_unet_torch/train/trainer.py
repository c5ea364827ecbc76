"""The training engine (counterpart of ``tpu_unet/train/trainer.py``).

One train step on the device: weight maps from the labels, forward,
weighted BCE, backward, SGD update, per-sample metrics. The epoch is a
Python loop over steps (PyTorch runs eagerly: there is no `jit` and no
`scan`), fed by the augmentation pipeline on the device; the host reads
the losses and metrics once per epoch.

As in the JAX package: per-epoch means are true means, the distance weight
map is reachable, goal saves are direction-aware, resume restores params,
momentum, LR, plateau scheduler and epoch, SIGTERM/SIGINT checkpoint
'latest' at the next epoch boundary, and the batch order is the JAX
package's ``RandomState(seed)`` permutation. The augmentation of batch b of
epoch e is drawn from a generator seeded by (seed, e, b), so a resumed run
draws what an uninterrupted one would.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_unet_torch.config import (AugmentConfig, DatasetConfig, LossConfig, ModelConfig,
                                   TrainConfig)
from tpu_unet_torch.core.geometry import input_size_compute
from tpu_unet_torch.data.augment import AugmentPipeline
from tpu_unet_torch.data.ingest import SegmentationData, square_crop
from tpu_unet_torch.losses.bce import weighted_bce_with_logits
from tpu_unet_torch.losses.metrics import batch_evaluation_metrics
from tpu_unet_torch.losses.weights import make_weight_fn
from tpu_unet_torch.models.unet import UNet, center_crop_or_pad
from tpu_unet_torch.ops.pad import reflect_pad
from tpu_unet_torch.train.checkpoint import Checkpointer
from tpu_unet_torch.train.optimizer import (PlateauState, make_optimizer, plateau_init,
                                            plateau_step, set_learning_rate)
from tpu_unet_torch.train.progress import ProgressWriter
from tpu_unet_torch.utils.profiling import span

StepFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def make_train_step(model: UNet, weight_fn, broadcast: str,
                    opt: torch.optim.Optimizer) -> StepFn:
    """One SGD step: (inp [B, S, S, 1], gt [B, c, c]) -> (loss [] f32,
    metrics [B, 2]), both on the device; updates `model` and `opt` in
    place. Metrics come from the logits before the update, as in JAX."""

    def step(inp: torch.Tensor, gt: torch.Tensor):
        with torch.no_grad():
            weights = weight_fn(gt)
        opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = center_crop_or_pad(model(inp), gt.shape[1:3])
        loss = weighted_bce_with_logits(logits, gt, weights, broadcast)
        loss.backward()
        opt.step()
        with torch.no_grad():
            metrics = batch_evaluation_metrics(logits.argmax(-1), gt)
        return loss.detach(), metrics

    return step


def make_eval_step(model: UNet, weight_fn, broadcast: str) -> StepFn:
    """Whole-image evaluation: (inp, gt) -> (per-sample losses [B], metrics
    [B, 2]); per-sample losses let a padded tail batch be trimmed exactly."""

    @torch.no_grad()
    def step(inp: torch.Tensor, gt: torch.Tensor):
        logits = center_crop_or_pad(model(inp), gt.shape[1:3])
        loss = weighted_bce_with_logits(logits, gt, weight_fn(gt), broadcast,
                                        reduction="per_sample")
        return loss, batch_evaluation_metrics(logits.argmax(-1), gt)

    return step


def prepare_eval_arrays(data: SegmentationData) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-image eval inputs: square-crop non-square frames, mirror-pad to
    the network input size, min/ptp-normalise; labels binarised to {0, 1}.
    Returns (inputs [N, S, S, 1] f32, labels [N, c, c] int32)."""
    inputs, labels = [], []
    for img, tgt in zip(data.images, data.targets):
        img, tgt = square_crop(img, tgt)
        _, input_size, _ = input_size_compute(img.shape[-1])
        pad = (input_size - img.shape[-1]) // 2
        padded = reflect_pad(torch.from_numpy(np.asarray(img)), pad).numpy()
        padded = (padded - padded.min()) / max(np.ptp(padded), 1e-12)
        inputs.append(padded.astype(np.float32))
        labels.append((tgt > 127).astype(np.int32))
    return np.stack(inputs)[..., None], np.stack(labels)


@dataclasses.dataclass
class EpochStats:
    loss: float
    iou: float
    pixel_error: float


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """The augmentation seed of batch `batch` of epoch `epoch`."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + batch) % (2 ** 63)


class Trainer:
    """End-to-end training for one fold/run, on `device` (default 'cuda';
    without a card pass ``device='cpu'``)."""

    def __init__(
        self,
        dataset_cfg: DatasetConfig,
        model_cfg: ModelConfig = ModelConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        loss_cfg: Optional[LossConfig] = None,
        aug_cfg: Optional[AugmentConfig] = None,
        out_dir: str = "runs/default",
        verbose: bool = True,
        nan_check: bool = False,
        device=None,
    ):
        self.dataset_cfg = dataset_cfg
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.loss_cfg = loss_cfg or dataset_cfg.loss()
        self.aug_cfg = aug_cfg or dataset_cfg.augment()
        self.out_dir = out_dir
        self.verbose = verbose
        self.nan_check = nan_check
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" to train on the CPU")
        self.device = torch.device(device or "cuda")

        gen = torch.Generator().manual_seed(train_cfg.seed ^ 0xBEEF)
        self.model = UNet(model_cfg, generator=gen).to(self.device)
        self.weight_fn = make_weight_fn(
            self.loss_cfg.weight_mode,
            **(dict(w0=self.loss_cfg.w0, sigma2=self.loss_cfg.sigma2,
                    max_objects=self.loss_cfg.max_objects)
               if self.loss_cfg.weight_mode == "distance" else {}),
        )
        self.opt = make_optimizer(self.model.parameters(), train_cfg.optim)
        self.pipe = AugmentPipeline(self.aug_cfg)
        self.train_step = make_train_step(self.model, self.weight_fn,
                                          self.loss_cfg.weight_broadcast, self.opt)
        self.eval_step = make_eval_step(self.model, self.weight_fn,
                                        self.loss_cfg.weight_broadcast)

    def _log(self, *args):
        if self.verbose:
            print(*args, flush=True)

    def state(self) -> Dict[str, dict]:
        """The checkpointed device state: model and optimizer state_dicts."""
        return {"model": self.model.state_dict(), "optimizer": self.opt.state_dict()}

    def load_state(self, state: Dict[str, dict]) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])

    def run_epoch(self, arrays, order: np.ndarray, epoch: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train on the [n_batches, bs] index rows of `order`; returns
        (losses [n_batches], metrics [n_batches * bs, 2]) on the device."""
        images, targets, log_probs, pairs = arrays
        losses, metrics = [], []
        for b, idx in enumerate(order):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(batch_seed(self.train_cfg.seed, epoch, b))
            inp, gt = self.pipe(images, targets, log_probs, pairs, idx, gen)
            loss, m = self.train_step(inp, gt)
            losses.append(loss)
            metrics.append(m)
        return torch.stack(losses), torch.cat(metrics)

    def fit(self, train_data: SegmentationData, val_data: SegmentationData,
            epochs: Optional[int] = None, resume: bool = False
            ) -> Dict[str, List[float]]:
        cfg = self.train_cfg
        epochs = cfg.epochs if epochs is None else epochs
        bs = cfg.batch_size
        ckpt = Checkpointer(os.path.join(self.out_dir, "models"))

        # SIGTERM/SIGINT set a flag; the loop checkpoints 'latest' at the
        # next epoch boundary and exits, so `fit(resume=True)` continues.
        preempted = {"flag": False}
        prev_handlers = {}

        def _on_signal(signum, frame):
            preempted["flag"] = True

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            prev_handlers = {}  # not in the main thread

        dev = self.device
        arrays = (torch.from_numpy(train_data.images).to(dev),
                  torch.from_numpy(train_data.targets).to(dev),
                  torch.from_numpy(train_data.crop_log_probs).to(dev),
                  torch.from_numpy(train_data.crop_pairs).to(dev))
        val_inp, val_gt = prepare_eval_arrays(val_data)
        val_inp = torch.from_numpy(val_inp).to(dev)
        val_gt = torch.from_numpy(val_gt).to(dev)

        plateau = plateau_init(cfg.optim)
        best_val_loss = float("inf")
        goal_saved = False
        goal_epoch: Optional[int] = None
        epoch0 = 0
        last_best_save = -(10 ** 9)

        if resume and ckpt.exists("latest"):
            state, host = ckpt.restore("latest")
            self.load_state(state)
            plateau = PlateauState(**host["plateau"])
            best_val_loss = host["best_val_loss"]
            goal_saved = host.get("goal_saved", False)
            goal_epoch = host.get("goal_epoch")
            if goal_saved and goal_epoch is None:
                goal_epoch = host["epoch"]
            epoch0 = host["epoch"] + 1
            self._log(f"Resumed from epoch {host['epoch']}")

        # after resume: a resumed run preloads the finished epochs' curves
        prog = ProgressWriter(self.out_dir, resume_epochs=epoch0)

        perm_rng = np.random.RandomState(cfg.seed)
        n = len(train_data)
        stop = False

        for epoch in range(epoch0, epochs + 1):
            t0 = time.time()
            set_learning_rate(self.opt, plateau.lr)

            order = perm_rng.permutation(n)
            if n < bs:  # tiny dataset: wrap around to fill one batch
                order = np.resize(order, bs)
            n_batches = max(1, len(order) // bs)
            order = order[: n_batches * bs].reshape(n_batches, bs)

            losses, metrics = self.run_epoch(arrays, order, epoch)
            train_loss = float(losses.mean())
            train_metrics = metrics.cpu().numpy()
            if self.nan_check and not np.isfinite(train_loss):
                raise FloatingPointError(f"non-finite training loss at epoch {epoch}")
            train_stats = EpochStats(train_loss,
                                     float(np.nanmean(train_metrics[:, 0])),
                                     float(np.mean(train_metrics[:, 1])))

            val_stats = self.evaluate_arrays(val_inp, val_gt, bs)
            plateau, _ = plateau_step(plateau, val_stats.loss, cfg.optim)

            improved = val_stats.loss < best_val_loss * (1.0 - cfg.optim.plateau_threshold)
            if improved:
                best_val_loss = val_stats.loss
            host = {
                "epoch": epoch,
                "plateau": plateau._asdict(),
                "best_val_loss": best_val_loss,
                "goal_saved": goal_saved,
                "goal_epoch": goal_epoch,
                "model_cfg": dataclasses.asdict(self.model_cfg),
            }
            if improved:
                if epoch - last_best_save >= cfg.best_save_min_interval:
                    ckpt.save_async("best", self.state(), host)
                    last_best_save = epoch
                self._log(f"Epoch {epoch}: new best (val loss {val_stats.loss:.6f})")

            goal_metric = (val_stats.iou if self.dataset_cfg.metric == "iou"
                           else val_stats.pixel_error)
            hit = (goal_metric > self.dataset_cfg.goal
                   if self.dataset_cfg.goal_direction == "max"
                   else goal_metric < self.dataset_cfg.goal)
            if hit and not goal_saved:
                goal_saved = True
                goal_epoch = epoch
                host["goal_saved"] = True
                host["goal_epoch"] = goal_epoch
                ckpt.save_async(f"goal_{self.dataset_cfg.name}", self.state(), host)
                self._log(f"Epoch {epoch}: paper goal reached "
                          f"({goal_metric:.4f} vs {self.dataset_cfg.goal})")

            if (cfg.stop_on_goal and goal_epoch is not None
                    and epoch - goal_epoch >= cfg.goal_patience):
                self._log(f"Goal reached at epoch {goal_epoch}; stopping "
                          f"after goal_patience={cfg.goal_patience}")
                stop = True

            if epoch % cfg.checkpoint_every == 0:
                ckpt.save_async("latest", self.state(), host)

            prog.append(
                loss=train_stats.loss, loss_val=val_stats.loss,
                train_iou=train_stats.iou, train_pe=train_stats.pixel_error,
                val_iou=val_stats.iou, val_pe=val_stats.pixel_error,
            )
            self._log(
                f"Epoch {epoch:4d} lr {plateau.lr:.2e} "
                f"loss {train_stats.loss:.5f}/{val_stats.loss:.5f} "
                f"IoU {train_stats.iou:.4f}/{val_stats.iou:.4f} "
                f"PE {train_stats.pixel_error:.4f}/{val_stats.pixel_error:.4f} "
                f"patience {plateau.num_bad_epochs}/{cfg.optim.plateau_patience} "
                f"{time.time() - t0:.1f}s"
            )

            if (plateau.lr < 10 * cfg.optim.plateau_eps
                    and plateau.num_bad_epochs >= cfg.optim.plateau_patience):
                self._log(f"LR below floor at epoch {epoch}; stopping")
                stop = True

            if preempted["flag"]:
                self._log(f"Preemption signal at epoch {epoch}: "
                          f"checkpointing 'latest' and exiting cleanly")
                stop = True

            if stop or epoch == epochs:
                ckpt.save_async("latest", self.state(), host)
            if stop:
                break

        ckpt.wait()
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if preempted["flag"] and prev_handlers:
            raise KeyboardInterrupt("training preempted (state checkpointed)")
        return prog.history

    def evaluate_arrays(self, val_inp: torch.Tensor, val_gt: torch.Tensor,
                        batch_size: int) -> EpochStats:
        """Loss and metrics of the current model over whole-image arrays, in
        batches of `batch_size`; a short tail batch is padded by repetition
        (the 'parity' broadcast needs the full batch) and trimmed."""
        n = val_inp.shape[0]
        losses, metrics = [], []
        for i in range(0, n, batch_size):
            take = torch.arange(i, i + batch_size, device=val_inp.device) % n
            li, mi = self.eval_step(val_inp[take], val_gt[take])
            losses.append(li[: n - i])
            metrics.append(mi[: n - i])
        m = torch.cat(metrics).cpu().numpy()
        return EpochStats(float(torch.cat(losses).mean()),
                          float(np.nanmean(m[:, 0])), float(np.mean(m[:, 1])))
