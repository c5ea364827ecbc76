"""Exact Euclidean distance transform (counterpart of ``tpu_unet/ops/edt.py``).

Two separable phases. Rows: the distance to the nearest object pixel of the
same row, from a forward running max of object columns and a backward
running min. Columns: D2[i, j] = min_r g2[r, j] + (i - r)^2, the (min, +)
pass that `ops.edt_pallas.column_pass` runs (the Hopper kernel on a CUDA
tensor, its plain scan on a CPU tensor). Pixels with no object anywhere in
the plane get +inf.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_unet_torch.ops.edt_pallas import (NumValid, _column_pass_from_g2,
                                           column_pass)

_BIG = 2 ** 30


def _row_distance(mask: torch.Tensor) -> torch.Tensor:
    """Per-row distance to the nearest True pixel of the same row.

    mask: [..., H, W] bool. Returns [..., H, W] f32 (+inf where the row has
    no True)."""
    w = mask.shape[-1]
    col = torch.arange(w, dtype=torch.int32, device=mask.device)
    # nearest True at or left of each pixel: running max of True columns
    left = torch.cummax(torch.where(mask, col, -1), dim=-1).values
    d_left = torch.where(left >= 0, (col - left).float(), float("inf"))
    # nearest True at or right of it: running min from the right
    right = torch.where(mask, col, _BIG).flip(-1)
    right = torch.cummin(right, dim=-1).values.flip(-1)
    d_right = torch.where(right < _BIG, (right - col).float(), float("inf"))
    return torch.minimum(d_left, d_right)


def _squared(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(g), float("inf"), g * g)


def edt(mask: torch.Tensor) -> torch.Tensor:
    """[H, W] bool -> [H, W] f32 distance from every pixel to the nearest
    True pixel: 0 on the object, +inf if the mask is empty."""
    return torch.sqrt(_column_pass_from_g2(_squared(_row_distance(mask))))


def edt_batch(masks: torch.Tensor, num_valid: NumValid = None,
              band: Optional[int] = None) -> torch.Tensor:
    """[..., N, H, W] bool -> [..., N, H, W] f32 exact EDT of each plane.

    `num_valid` (an int, or an integer tensor of the leading shape ``[...]``):
    planes at index >= num_valid are known empty and come back +inf without
    work. `band` restricts the column pass to vertical offsets <= band:
    distances above `band` may come back larger (up to +inf), exact below
    it."""
    g2 = _squared(_row_distance(masks)).contiguous()       # squares: +0, > 0 or +inf
    return torch.sqrt(column_pass(g2, num_valid=num_valid, band=band))
