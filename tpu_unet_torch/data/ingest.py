"""Host-side dataset ingest (counterpart of ``tpu_unet/data/ingest.py``;
numpy only): the dataset container, ground-truth preprocessing, the crop
distribution, the square crop, and the CTC (Cell Tracking Challenge) and
ISBI2012 loaders, which decode their TIFFs with the port's own codec
(`tpu_unet_torch.data.tiff`).

As in the JAX package, the CTC training loader excludes the frames that
have gold truth from the silver-truth listing (the reference deletes them
from disk and copies them back), and sequence directories are matched for
any count of them.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tpu_unet_torch.data.tiff import read_tiff


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

    Returns (gt, edge_mask). Uses the native C++ kernel
    (`tpu_unet_torch.native`) for integer ids when it builds; numpy
    otherwise, with the same result."""
    from tpu_unet_torch import native

    if np.issubdtype(np.asarray(img).dtype, np.integer):
        out = native.preprocess_gt(np.asarray(img, np.int32))
        if out is not None:
            return out[0].astype(np.float64), out[1].astype(np.float64)
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


# ------------------------------------------------------------------ loaders


def _imread(path: str) -> np.ndarray:
    """The first page of the TIFF at `path`."""
    return read_tiff(path)[0]


def _sequence_dirs(root_dir: str) -> List[str]:
    """CTC sequence directories: pure-numeric names (01, 02, ...)."""
    return sorted(
        d for d in os.listdir(root_dir)
        if re.fullmatch(r"\d+", d) and os.path.isdir(os.path.join(root_dir, d))
    )


def _load_pairs(
    root_dir: str, seq: str, seg_kind: str, exclude: Sequence[str] = ()
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load (image, instance-label) pairs for one sequence.

    seg_kind: 'ST' (silver truth) or 'GT' (gold truth); the label
    ``man_seg*`` goes with the image ``t*``."""
    image_dir = os.path.join(root_dir, seq)
    seg_dir = os.path.join(root_dir, f"{seq}_{seg_kind}", "SEG")
    images, labels = [], []
    for fname in sorted(os.listdir(seg_dir)):
        if fname in exclude:
            continue
        image_name = fname.replace("man_seg", "t")
        images.append(np.asarray(_imread(os.path.join(image_dir, image_name)), np.float32))
        labels.append(_imread(os.path.join(seg_dir, fname)))
    return images, labels


def _build(images, raw_labels, crop: Optional[int], name: str) -> SegmentationData:
    targets = [binarize_gt(preprocess_gt(lab)[0]) for lab in raw_labels]
    images = np.stack(images).astype(np.float32)
    targets = np.stack(targets)
    if crop is not None:
        log_probs, pairs = crop_distribution(targets, crop)
    else:
        log_probs, pairs = None, None
    return SegmentationData(images, targets, log_probs, pairs, name=name)


def load_ctc_training(root_dir: str, crop: int, name: str = "") -> SegmentationData:
    """CTC training set: silver-truth (ST) labels, excluding the frames that
    have gold truth (reserved for evaluation; the files stay on disk)."""
    all_images, all_labels = [], []
    for seq in _sequence_dirs(root_dir):
        gt_dir = os.path.join(root_dir, f"{seq}_GT", "SEG")
        exclude = os.listdir(gt_dir) if os.path.isdir(gt_dir) else ()
        imgs, labs = _load_pairs(root_dir, seq, "ST", exclude=exclude)
        all_images += imgs
        all_labels += labs
    return _build(all_images, all_labels, crop, name or root_dir)


def load_ctc_test(root_dir: str, name: str = "") -> SegmentationData:
    """Evaluation set: gold-truth (GT) labels only, of the training
    sequences (the challenge sets have no public labels)."""
    all_images, all_labels = [], []
    for seq in _sequence_dirs(root_dir):
        imgs, labs = _load_pairs(root_dir, seq, "GT")
        all_images += imgs
        all_labels += labs
    return _build(all_images, all_labels, None, name or root_dir)


def load_isbi_training(root_dir: str, crop: int, name: str = "ISBI2012") -> SegmentationData:
    """ISBI2012: the single sequence '01' with GT labels, which the
    downloader made instance masks by connected components; ingest
    re-applies `preprocess_gt`."""
    imgs, labs = _load_pairs(root_dir, "01", "GT")
    return _build(imgs, labs, crop, name)


def square_crop(image: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Center-crop a non-square image (and its labels) to square."""
    h, w = image.shape
    if h == w:
        return image, gt
    c = abs(h - w) // 2
    if h > w:
        return image[c:w + c, :], gt[c:w + c, :]
    return image[:, c:h + c], gt[:, c:h + c]
