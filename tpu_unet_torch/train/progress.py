"""Per-epoch progress artifacts (counterpart of
``tpu_unet/train/progress.py``, which cannot be imported without JAX since
``tpu_unet/train/__init__.py`` pulls in the optimizer).

Keeps the reference's flat-file contract (``trainer.py:178-183``: six
``np.savetxt`` curves rewritten each epoch under ``<fold_dir>/progress/``)
and adds a structured JSONL metric stream (``metrics.jsonl``, one appended
object per epoch) for tooling — the structured writer SURVEY.md §5.5 calls
for."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np

FILES = {
    "train_iou": "train_eval_iou.out",
    "train_pe": "train_eval_pe.out",
    "val_iou": "val_eval_iou.out",
    "val_pe": "val_eval_pe.out",
    "loss": "loss.out",
    "loss_val": "loss_val.out",
}


class ProgressWriter:
    def __init__(self, fold_dir: str, resume_epochs: int = 0):
        """`resume_epochs` > 0: preload epochs 0..resume_epochs-1 from the
        on-disk ``metrics.jsonl`` so a resumed run (trainer ``resume=True``)
        CONTINUES the curves instead of truncating them to the post-resume
        epochs — the per-epoch rewrite below starts from in-memory history,
        which would otherwise restart empty in the new process. Rows past
        the restored checkpoint's epoch (a crash may land between the
        progress append and the checkpoint) are dropped; the resumed
        trajectory rewrites them."""
        self.progress_dir = os.path.join(fold_dir, "progress")
        os.makedirs(self.progress_dir, exist_ok=True)
        self.history: Dict[str, List[float]] = {k: [] for k in FILES}
        self._jsonl = os.path.join(self.progress_dir, "metrics.jsonl")
        if resume_epochs > 0 and os.path.exists(self._jsonl):
            records = []
            with open(self._jsonl) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        [float(rec[k]) for k in FILES]
                    except (ValueError, KeyError, TypeError):
                        continue
                    records.append(rec)
            records = records[:resume_epochs]
            for rec in records:
                for k in self.history:
                    self.history[k].append(float(rec[k]))
            with open(self._jsonl, "w") as f:
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
            for key, fname in FILES.items():
                np.savetxt(os.path.join(self.progress_dir, fname),
                           np.asarray(self.history[key]))

    def append(self, **values: float) -> None:
        for key, val in values.items():
            if key not in self.history:
                raise KeyError(f"unknown progress key {key!r}")
            self.history[key].append(float(val))
        for key, fname in FILES.items():
            np.savetxt(os.path.join(self.progress_dir, fname),
                       np.asarray(self.history[key]))
        record = {"epoch": len(self.history["loss"]) - 1, "time": time.time()}
        record.update({k: float(v) for k, v in values.items()})
        with open(self._jsonl, "a") as f:
            f.write(json.dumps(record) + "\n")
