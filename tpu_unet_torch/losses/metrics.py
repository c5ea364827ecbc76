"""Evaluation metrics: IoU and pixel error (counterpart of
``tpu_unet/losses/metrics.py``)."""

from __future__ import annotations

import torch


def iou(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Intersection-over-union of nonzero masks. NaN when both masks are
    empty (0/0), matching the reference's numpy division semantics."""
    p = pred != 0
    l = label != 0
    inter = torch.logical_and(p, l).sum()
    union = torch.logical_or(p, l).sum()
    return inter.float() / union.float()


def pixel_error(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference between prediction and label masks."""
    return torch.mean(torch.abs(pred.float() - label.float()))


def evaluation_metrics(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """[2] vector of (iou, pixel_error) for one sample."""
    return torch.stack([iou(pred, label), pixel_error(pred, label)])


def batch_evaluation_metrics(preds: torch.Tensor, labels: torch.Tensor
                             ) -> torch.Tensor:
    """[B, 2] per-sample (iou, pixel_error) over a batch of class-id maps:
    the IoU of the nonzero masks, and the share of pixels whose class
    differs (for two classes the mean absolute difference, bit for bit)."""
    p = (preds != 0).flatten(1)
    l = (labels != 0).flatten(1)
    inter = torch.logical_and(p, l).sum(1).float()
    union = torch.logical_or(p, l).sum(1).float()
    pe = (preds != labels).flatten(1).float().mean(1)
    return torch.stack([inter / union, pe], dim=1)
