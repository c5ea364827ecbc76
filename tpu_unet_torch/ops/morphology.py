"""Morphological ops in PyTorch (counterpart of ``tpu_unet/ops/morphology.py``):
grayscale dilation with a rectangular structuring element, and the binary
threshold. Ground-truth preprocessing on the host has its own numpy copy
(`data/ingest.py::preprocess_gt`)."""

from __future__ import annotations

import functools

import torch


def dilate(img: torch.Tensor, ksize: int = 5, iterations: int = 1) -> torch.Tensor:
    """Grayscale dilation of the last two dims with a ksize x ksize
    rectangle, `iterations` times: the windowed max over a border of -inf
    (floating dtypes) or the dtype's minimum (integer dtypes), so the border
    never wins. An even `ksize` grows each dim by one, as JAX's does."""
    pad = ksize // 2
    fill = (-torch.inf if img.dtype.is_floating_point else torch.iinfo(img.dtype).min)
    out = img
    for _ in range(iterations):
        h, w = out.shape[-2:]
        padded = out.new_full((*out.shape[:-2], h + 2 * pad, w + 2 * pad), fill)
        padded[..., pad:pad + h, pad:pad + w] = out
        oh, ow = h + 2 * pad - ksize + 1, w + 2 * pad - ksize + 1
        out = functools.reduce(torch.maximum, (padded[..., dy:dy + oh, dx:dx + ow]
                                               for dy in range(ksize)
                                               for dx in range(ksize)))
    return out


def binary_threshold(img: torch.Tensor, thresh: float, maxval: float = 255.0
                     ) -> torch.Tensor:
    """OpenCV's THRESH_BINARY: `maxval` where img > thresh, else 0, in
    img's dtype."""
    return torch.where(img > thresh, img.new_full((), maxval), img.new_zeros(()))
