"""Cross-validation folds (counterpart of ``tpu_unet/train/folds.py``, on the
port's `SegmentationData`): one permutation drawn with the run seed,
rotated by the validation-set size per fold; the validation split keeps
its last element."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from tpu_unet_torch.data.ingest import SegmentationData


def subset(data: SegmentationData, idx: np.ndarray, name_suffix: str = ""
           ) -> SegmentationData:
    return SegmentationData(
        images=data.images[idx],
        targets=data.targets[idx],
        crop_log_probs=None if data.crop_log_probs is None else data.crop_log_probs[idx],
        crop_pairs=data.crop_pairs,
        name=data.name + name_suffix,
    )


def fold_splits(n: int, folds: int, seed: int, val_fraction: float = 0.2
                ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield (fold, train_indices, val_indices): samp_tr/samp_val rounding
    with an overflow guard, a ``RandomState(seed)`` shuffle, and the order
    rotated by samp_val per fold."""
    samp_tr = int(np.round((1.0 - val_fraction) * n))
    samp_val = int(np.round(val_fraction * n))
    while samp_tr + samp_val > n:
        samp_val -= 1
    rng = np.random.RandomState(seed)
    order = np.arange(n)
    rng.shuffle(order)
    for fold in range(folds):
        yield fold, order[:samp_tr].copy(), order[samp_tr:].copy()
        order = np.append(order[samp_val:], order[:samp_val])
