"""Reflect padding and coordinate folding (counterpart of
``tpu_unet/ops/pad.py``).

`reflect_pad` is one index gather with multi-bounce reflection, so a pad may
exceed the image side: the whole-image tile plan pads by 92 px or more even
around small images, which ``F.pad(mode='reflect')`` refuses.
"""

from __future__ import annotations

import torch


def fold_reflect(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold coordinates into [0, n-1] by repeated reflection about the edges
    (no edge duplication — numpy 'reflect' mode). Works for float sampling
    coordinates and integer indices alike."""
    if n == 1:
        return torch.zeros_like(coord)
    period = 2 * (n - 1)
    p = torch.remainder(torch.abs(coord), period)
    return torch.minimum(p, period - p)


def reflect_pad(img: torch.Tensor, pad) -> torch.Tensor:
    """Reflect-pad the last two axes (any pad size, multi-bounce).

    `pad` is an int (same on all sides) or ((top, bottom), (left, right)).
    Equivalent to ``np.pad(img, pad, mode='reflect')`` on 2D input.
    """
    if isinstance(pad, int):
        pad = ((pad, pad), (pad, pad))
    (pt, pb), (pl, pr) = pad
    h, w = img.shape[-2], img.shape[-1]
    rows = fold_reflect(torch.arange(-pt, h + pb, device=img.device), h)
    cols = fold_reflect(torch.arange(-pl, w + pr, device=img.device), w)
    return img[..., rows, :][..., :, cols]
