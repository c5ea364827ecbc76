"""Deterministic synthetic fixture datasets (counterpart of
``tpu_unet/data/synthetic.py``; the same seed gives the same arrays).

Cell-like instance masks and matching grayscale images, routed through the
same ingest path as real data (preprocess_gt -> binarize ->
crop_distribution).
"""

from __future__ import annotations

import numpy as np

from tpu_unet_torch.data.ingest import (
    SegmentationData,
    binarize_gt,
    crop_distribution,
    preprocess_gt,
)


def synthetic_instances(h: int, w: int, n_cells: int, rng: np.random.RandomState
                        ) -> np.ndarray:
    """Instance-labeled mask of soft elliptical 'cells' (labels 1..n)."""
    mask = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    for k in range(1, n_cells + 1):
        cy = rng.randint(int(0.1 * h), int(0.9 * h))
        cx = rng.randint(int(0.1 * w), int(0.9 * w))
        ry = rng.randint(max(4, h // 16), max(6, h // 6))
        rx = rng.randint(max(4, w // 16), max(6, w // 6))
        theta = rng.rand() * np.pi
        c, s = np.cos(theta), np.sin(theta)
        u = (yy - cy) * c + (xx - cx) * s
        v = -(yy - cy) * s + (xx - cx) * c
        cell = (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
        mask[cell] = k
    return mask


def _render_image(instances: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Grayscale image: per-cell intensity + noise, 3x3 box-smoothed."""
    h, w = instances.shape
    img = np.full((h, w), 60.0)
    for k in np.unique(instances):
        if k == 0:
            continue
        img[instances == k] = 120.0 + 80.0 * rng.rand()
    img += rng.randn(h, w) * 12.0
    p = np.pad(img, 1, mode="edge")
    img = sum(
        p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)
    ) / 9.0
    return np.clip(img, 0, 255).astype(np.float32)


def synthetic_dataset(
    n_images: int = 6,
    h: int = 256,
    w: int = 256,
    n_cells: int = 5,
    crop: int = 196,
    seed: int = 0,
    name: str = "synthetic",
) -> SegmentationData:
    """Fixture dataset flowing through the real ingest path."""
    rng = np.random.RandomState(seed)
    images, targets = [], []
    for _ in range(n_images):
        inst = synthetic_instances(h, w, n_cells, rng)
        gt, _ = preprocess_gt(inst)
        targets.append(binarize_gt(gt))
        images.append(_render_image(inst, rng))
    images = np.stack(images)
    targets = np.stack(targets)
    log_probs, pairs = crop_distribution(targets, crop)
    return SegmentationData(images, targets, log_probs, pairs, name=name)
