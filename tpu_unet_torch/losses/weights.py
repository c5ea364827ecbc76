"""Per-pixel loss weight maps, on the device (counterpart of
``tpu_unet/losses/weights.py``).

* `class_balance`: background weight n_cell / n_background, cell weight 1.
* `weighted_map`: the full HeLa map (Ronneberger et al. Eq. 2): class
  balance plus the border term w0 * exp(-(d1 + d2)^2 / (2 sigma^2)) on
  background pixels, d1 and d2 the exact Euclidean distances to the two
  nearest cells. Components (ops/cc.py) and the per-object EDT (ops/edt.py,
  whose column pass is the Hopper kernel on a CUDA tensor) run on the
  device with a static `max_objects` plane bound.

JAX's vmap over the batch is a batch dimension here: planes are
[B, K, H, W] and the object counts [B] stay on the device. As in the JAX
package: a single-class map degrades to all-ones class weights,
`parity_int_wc` truncates the class weight as the reference's integer
tensor does, and d2 is 0 when only one object exists.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from tpu_unet_torch.ops.cc import component_planes
from tpu_unet_torch.ops.edt import edt_batch


def _class_weights(gt: torch.Tensor) -> torch.Tensor:
    """[B, H, W] labels -> [B, H, W] f32: background n_cell/n_bg, cells 1;
    all ones where either class is absent."""
    g = gt != 0
    n_cell = g.sum((-2, -1)).float()[..., None, None]
    n_bg = (~g).sum((-2, -1)).float()[..., None, None]
    bg_w = torch.where(n_bg > 0, n_cell / torch.clamp_min(n_bg, 1.0), 1.0)
    w = torch.where(g, 1.0, bg_w)
    return torch.where((n_cell > 0) & (n_bg > 0), w, torch.ones_like(w))


def class_balance(gt_batch: torch.Tensor) -> torch.Tensor:
    """[B, H, W] binary labels -> [B, H, W] f32 class-frequency weights."""
    return _class_weights(gt_batch)


def weighted_map(gt_batch: torch.Tensor, w0: float = 20.0, sigma2: float = 25.0,
                 max_objects: int = 32, parity_int_wc: bool = False,
                 edt_band: Optional[int] = 40) -> torch.Tensor:
    """[B, H, W] binary labels -> [B, H, W] f32 distance weight maps (w0=20,
    sigma^2=25). `edt_band=None` runs the exact column pass; the default
    band of 40 changes the border term by < 3e-13 of w0 anywhere, since
    exp(-40^2 / 50) is zero to f32."""
    fg = gt_batch != 0
    w_c = _class_weights(gt_batch)
    if parity_int_wc:
        w_c = torch.trunc(w_c)
    planes, num = component_planes(fg, max_objects)          # [B, K, H, W], [B]
    dists = edt_batch(planes, num_valid=num, band=edt_band)  # +inf past num
    d1, arg1 = dists.min(dim=1)
    k = torch.arange(dists.shape[1], device=dists.device)[:, None, None]
    d2 = torch.where(k == arg1[:, None], float("inf"), dists).amin(dim=1)
    d2 = torch.where(num[:, None, None] > 1, d2, 0.0)       # one object: d2 = 0
    s = d1 + d2
    border = w0 * torch.exp(-(s * s) / (2.0 * sigma2))
    border = torch.where(torch.isfinite(border), border, 0.0)  # no objects
    return w_c + torch.where(fg, 0.0, border)


def make_weight_fn(mode: str, **kwargs):
    """'distance' | 'class_balance' -> batch weight function."""
    if mode == "distance":
        return partial(weighted_map, **kwargs)
    if mode == "class_balance":
        return class_balance
    raise ValueError(f"unknown weight mode: {mode}")
