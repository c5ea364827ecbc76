"""The benchmark's synthetic microscopy frames, made from a seed on the
device: its own frozen copy of the fixture generator of
``tpu_unet_torch/data/synthetic.py`` and of the ingest steps after it
(separating borders, binarising, the crop-origin distribution), vectorised
so that a pool of frames takes a few launches.

A frame holds `n_cells` soft elliptical cells (centres in the middle 80%,
radii h/16 .. h/6, any orientation; a later cell covers an earlier one),
each of intensity 120 + 80 u over a background of 60, Gaussian noise of
sigma 12, a 3x3 box blur and a clip to [0, 255]. Its target keeps the
pixels of each cell that no other cell's 9x9 dilation reaches (the
reference's separating border: two 5x5 dilations), at 255.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _uniform_int(lo: int, hi: int, shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def make_frames(n: int, h: int, w: int, n_cells: int, gen: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images [n, h, w] f32 in [0, 255], instance labels [n, h, w] int64,
    0 for the background and 1..n_cells), on the generator's device."""
    dev = gen.device
    cy = _uniform_int(int(0.1 * h), int(0.9 * h), (n, n_cells), gen).float()
    cx = _uniform_int(int(0.1 * w), int(0.9 * w), (n, n_cells), gen).float()
    ry = _uniform_int(max(4, h // 16), max(6, h // 6), (n, n_cells), gen).float()
    rx = _uniform_int(max(4, w // 16), max(6, w // 6), (n, n_cells), gen).float()
    theta = torch.rand((n, n_cells), generator=gen, device=dev) * math.pi
    level = 120.0 + 80.0 * torch.rand((n, n_cells), generator=gen, device=dev)
    noise = torch.randn((n, h, w), generator=gen, device=dev) * 12.0
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    labels = torch.zeros((n, h, w), dtype=torch.int64, device=dev)
    for k in range(n_cells):                       # later cells cover earlier ones
        c, s = torch.cos(theta[:, k]), torch.sin(theta[:, k])
        dy = yy[None] - cy[:, k, None, None]
        dx = xx[None] - cx[:, k, None, None]
        u = dy * c[:, None, None] + dx * s[:, None, None]
        v = -dy * s[:, None, None] + dx * c[:, None, None]
        inside = (u / ry[:, k, None, None]) ** 2 + (v / rx[:, k, None, None]) ** 2 <= 1.0
        labels = torch.where(inside, k + 1, labels)
    shade = torch.cat([torch.full((n, 1), 60.0, device=dev), level], dim=1)
    img = torch.gather(shade, 1, labels.flatten(1)).reshape(n, h, w) + noise
    img = F.avg_pool2d(F.pad(img[:, None], (1, 1, 1, 1), mode="replicate"), 3, stride=1)
    return img[:, 0].clamp(0.0, 255.0), labels


def separated_targets(labels: torch.Tensor, n_cells: int) -> torch.Tensor:
    """[n, h, w] instance labels -> [n, h, w] f32 targets in {0, 255}: a
    cell pixel stays foreground unless another cell's 9x9 dilation covers
    it."""
    covered = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    for k in range(1, n_cells + 1):
        m = (labels == k).float()[:, None]
        ring = (F.max_pool2d(m, 9, stride=1, padding=4) - m)[:, 0]
        covered += (ring > 0).int()
    return torch.where((labels > 0) & (covered == 0), 255.0, 0.0)


def crop_distribution(targets: torch.Tensor, crop: int, skip: int = 10,
                      fg_lo: float = 0.1, fg_hi: float = 0.9, pdf_loc: float = 0.5,
                      pdf_scale: float = 0.05) -> Tuple[torch.Tensor, torch.Tensor]:
    """Foreground-balanced crop origins: candidates on a `skip` grid, each
    weighted 10 * N(fg share; 0.5, 0.05) inside (fg_lo, fg_hi) and 0
    outside, normalised per image, uniform where every candidate is gated
    out. Returns (log_probs [n, P] f32, -inf where 0; origins [P, 2]
    int32)."""
    n, h, w = targets.shape
    dev = targets.device
    ys = torch.arange(0, max(h - crop, 1), skip, device=dev)
    xs = torch.arange(0, max(w - crop, 1), skip, device=dev)
    pairs = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    fg = (targets > 0).double()
    integral = F.pad(fg.cumsum(1).cumsum(2), (1, 0, 1, 0))
    y0, x0 = pairs[:, 0], pairs[:, 1]
    total = (integral[:, y0 + crop, x0 + crop] - integral[:, y0, x0 + crop]
             - integral[:, y0 + crop, x0] + integral[:, y0, x0])
    share = total / (crop * crop)
    pdf = torch.exp(-0.5 * ((share - pdf_loc) / pdf_scale) ** 2) / (pdf_scale * math.sqrt(2 * math.pi))
    p = torch.where((share > fg_lo) & (share < fg_hi), 10.0 * pdf, 0.0)
    s = p.sum(1, keepdim=True)
    p = torch.where(s > 0, p / torch.where(s > 0, s, 1.0), 1.0 / p.shape[1])
    return torch.log(p).float(), pairs.int()
