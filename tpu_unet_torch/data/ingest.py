"""Host-side ingest that serving needs: the dataset container,
ground-truth preprocessing, the crop distribution and the square crop
(counterpart of the parts of ``tpu_unet/data/ingest.py`` that the
evaluation entry point uses; numpy only). The CTC/ISBI loaders are ROADMAP
queue 1, item 7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SegmentationData:
    """A dense dataset.

    images:  [N, H, W] float32 raw intensities
    targets: [N, H, W] float32 binary {0, 255} (post `preprocess_gt` +
             threshold)
    crop_log_probs: [N, P] float32 log-probabilities over candidate crop
             origins (−inf where gated out)
    crop_pairs: [P, 2] int32 candidate crop origins (row, col)
    """

    images: np.ndarray
    targets: np.ndarray
    crop_log_probs: Optional[np.ndarray]
    crop_pairs: Optional[np.ndarray]
    name: str = ""

    def __len__(self) -> int:
        return len(self.images)


def _maximum_filter(mask: np.ndarray, size: int) -> np.ndarray:
    """Windowed max with zero border."""
    pad = size // 2
    padded = np.pad(mask, pad, mode="constant")
    out = mask.copy()
    h, w = mask.shape
    for dy in range(size):
        for dx in range(size):
            np.maximum(out, padded[dy:dy + h, dx:dx + w], out)
    return out


def preprocess_gt(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Separating-border trick on an instance-labeled mask: per instance,
    binarize to 255, dilate twice with a 5x5 rect kernel, accumulate
    (dilated - instance) into a global edge mask; subtract the edge mask from
    the labels and clip at 0.

    Returns (gt, edge_mask). Uses the shared native C++ kernel
    (``tpu_unet.native``) when it builds; numpy otherwise."""
    from tpu_unet import native

    if native.has_native() and np.issubdtype(np.asarray(img).dtype, np.integer):
        gt, edge = native.preprocess_gt(np.asarray(img, np.int32))
        return gt.astype(np.float64), edge.astype(np.float64)
    return _preprocess_gt_py(img)


def _preprocess_gt_py(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    img = np.asarray(img)
    mask_global = np.zeros(img.shape, np.float64)
    for cls in np.unique(img):
        if cls == 0:
            continue
        mask_cls = np.where(img == cls, 255.0, 0.0)
        dilated = _maximum_filter(_maximum_filter(mask_cls, 5), 5)
        mask_global += dilated - mask_cls
    gt = img.astype(np.float64) - mask_global
    gt[gt < 0] = 0
    return gt, mask_global


def binarize_gt(gt: np.ndarray) -> np.ndarray:
    """Threshold at 0: objects -> 255."""
    return np.where(gt > 0, 255.0, 0.0).astype(np.float32)


def _norm_pdf(x: float, loc: float, scale: float) -> float:
    return float(np.exp(-0.5 * ((x - loc) / scale) ** 2) / (scale * np.sqrt(2 * np.pi)))


def crop_distribution(
    targets: np.ndarray,
    crop: int,
    skip: int = 10,
    fg_lo: float = 0.1,
    fg_hi: float = 0.9,
    pdf_loc: float = 0.5,
    pdf_scale: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Foreground-balanced crop-origin distribution: candidate origins on a
    `skip`-stride grid; candidate probability 10*norm.pdf(fg_fraction, .5,
    .05) when the fg fraction is in (fg_lo, fg_hi), else 0; normalized per
    image with a uniform fallback when all candidates are gated out.

    Returns (log_probs [N, P], pairs [P, 2])."""
    n, h, w = targets.shape
    pairs = np.array(
        [(ii, jj) for ii in range(0, h - crop, skip) for jj in range(0, w - crop, skip)],
        np.int32,
    )
    if len(pairs) == 0 and h >= crop and w >= crop:
        # an exactly crop-sized image has one valid origin
        pairs = np.zeros((1, 2), np.int32)
    if len(pairs) == 0:
        raise ValueError(f"image {h}x{w} smaller than crop {crop}")
    log_probs = np.zeros((n, len(pairs)), np.float32)
    for i in range(n):
        p = np.zeros(len(pairs), np.float64)
        for k, (ii, jj) in enumerate(pairs):
            x = float(np.mean(targets[i, ii:ii + crop, jj:jj + crop])) / 255.0
            if fg_lo < x < fg_hi:
                p[k] = 10.0 * _norm_pdf(x, pdf_loc, pdf_scale)
        s = p.sum()
        if s == 0:
            p[:] = 1.0 / len(p)
        else:
            p /= s
        with np.errstate(divide="ignore"):
            log_probs[i] = np.where(p > 0, np.log(p), -np.inf)
    return log_probs, pairs


def square_crop(image: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Center-crop a non-square image (and its labels) to square."""
    h, w = image.shape
    if h == w:
        return image, gt
    c = abs(h - w) // 2
    if h > w:
        return image[c:w + c, :], gt[c:w + c, :]
    return image[:, c:h + c], gt[:, c:h + c]
