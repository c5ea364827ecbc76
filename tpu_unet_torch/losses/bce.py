"""Per-pixel weighted binary cross-entropy with logits (counterpart of
``tpu_unet/losses/bce.py``): per-channel sigmoid BCE over a 2-channel
one-hot target, as ``torch.nn.BCEWithLogitsLoss(weight=w)`` in the
reference's training step.

Two weight broadcasts: 'intended' weights pixel (b, i, j) of every class
channel by sample b's map; 'parity' reproduces the reference's accident,
where a [B, H, W] weight against [B, 2, H, W] input is read as
[1, B, H, W], so sample i / channel j takes sample j's map (batch must
equal the number of classes).
"""

from __future__ import annotations

import torch


def one_hot_targets(labels: torch.Tensor) -> torch.Tensor:
    """[B, h, w] int {0, 1} -> [B, h, w, 2] f32: channel 0 background
    (1 - y), channel 1 cell (y)."""
    y = labels.float()
    return torch.stack([1.0 - y, y], dim=-1)


def binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unweighted per-element BCE of logits [..., C] against
    one_hot(labels [...]), f32 [..., C]."""
    z = one_hot_targets(labels)
    x = logits.float()
    # stable BCE with logits: max(x, 0) - x z + log(1 + exp(-|x|))
    return torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-torch.abs(x)))


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             weights: torch.Tensor, broadcast: str = "intended",
                             reduction: str = "mean") -> torch.Tensor:
    """Mean of w * BCE(logits, one_hot(labels)).

    logits [B, h, w, C] (C = 2), labels [B, h, w] int in {0, 1}, weights
    [B, h, w] f32. reduction 'mean' -> scalar; 'per_sample' -> [B]
    per-sample means (their mean is the overall mean)."""
    bce = binary_cross_entropy(logits, labels)
    if broadcast == "intended":
        w = weights[..., None]
    elif broadcast == "parity":
        if logits.shape[0] != logits.shape[-1]:
            raise ValueError(
                "parity broadcast requires batch == num_classes "
                f"(got batch={logits.shape[0]}, classes={logits.shape[-1]}); "
                "it reproduces the reference's [B,H,W] weight against "
                "[B,2,H,W] input")
        w = torch.movedim(weights, 0, -1)[None]             # [1, h, w, B=C]
    else:
        raise ValueError(f"unknown broadcast mode: {broadcast}")
    if reduction == "per_sample":
        return (w * bce).mean(dim=(1, 2, 3))
    if reduction != "mean":
        raise ValueError(f"unknown reduction: {reduction}")
    return (w * bce).mean()
