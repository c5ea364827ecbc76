"""The training crops worked out again, plainly, for the check of a training
cell: the DIC-HeLa augmentation of Ronneberger et al. 2015 as the program
configures it (a foreground-balanced crop, a rotation by a multiple of 30
degrees and a Simard elastic deformation of alpha 200 and sigma 10 in one
bilinear sample, the labels thresholded at 127 and the input min/ptp
normalised). It imports nothing of the program.

The random values are drawn from a `torch.Generator` seeded per step, in
the order the program's data order fixes (`draw`), so that both sides see
the same draws; everything after the draws is this file's own, in float64:
SciPy's Gaussian filter for the elastic fields, NumPy-style reflection for
coordinates outside the crop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from scipy import ndimage


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """The seed of the generator of step `batch` of epoch `epoch`."""
    return ((seed * 1_000_003 + epoch) * 1_000_003 + batch) % (2 ** 63)


class Draws(NamedTuple):
    cid: int
    jitter: Tuple[int, int]
    angle: float
    u1: np.ndarray
    u2: np.ndarray


def draw(gen: torch.Generator, log_probs: torch.Tensor, size: int, rotate_step: int,
         skip: int) -> Draws:
    """One sample's random values, in the program's order: a crop origin
    id from softmax(log_probs), a jitter in [-skip/2, skip/2]^2, an angle
    of rotate_step x U{0 .. 360/rotate_step - 1}, two U(-1, 1) fields."""
    dev = gen.device
    probs = torch.softmax(log_probs.to(dev).double(), dim=-1)
    cid = torch.multinomial(probs, 1, generator=gen)[0]
    jitter = torch.randint(-(skip // 2), skip // 2 + 1, (2,), generator=gen, device=dev)
    angle = torch.randint(0, 360 // rotate_step, (), generator=gen, device=dev) * rotate_step
    u1 = torch.rand((size, size), generator=gen, device=dev) * 2.0 - 1.0
    u2 = torch.rand((size, size), generator=gen, device=dev) * 2.0 - 1.0
    return Draws(int(cid), (int(jitter[0]), int(jitter[1])), float(angle),
                 u1.double().cpu().numpy(), u2.double().cpu().numpy())


def _reflect(c: np.ndarray, n: int) -> np.ndarray:
    """Fold coordinates into [0, n-1] by reflection about the edges, the
    edge pixel not repeated."""
    period = 2 * (n - 1)
    p = np.remainder(np.abs(c), period)
    return np.minimum(p, period - p)


def augment_one(image: np.ndarray, target: np.ndarray, pairs: np.ndarray, d: Draws,
                crop: int, size: int, alpha: float, sigma: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """image, target [H, W] (target in {0, 255}) -> (input [size, size]
    in [0, 1], labels [crop, crop] in {0, 1})."""
    h, w = image.shape
    oy = int(np.clip(pairs[d.cid][0] + d.jitter[0], 0, h - crop))
    ox = int(np.clip(pairs[d.cid][1] + d.jitter[1], 0, w - crop))
    src = np.stack([image[oy:oy + crop, ox:ox + crop],
                    target[oy:oy + crop, ox:ox + crop]], -1).astype(np.float64)
    dx = ndimage.gaussian_filter(d.u1, sigma, mode="constant", truncate=4.0) * alpha
    dy = ndimage.gaussian_filter(d.u2, sigma, mode="constant", truncate=4.0) * alpha
    ar = np.arange(size, dtype=np.float64)
    pi = ar[:, None] + dx                     # the elastic displacement of the canvas
    pj = ar[None, :] + dy
    inside = (pi >= 0) & (pi <= size - 1) & (pj >= 0) & (pj <= size - 1)
    theta = math.radians(d.angle)
    c, s = math.cos(theta), math.sin(theta)
    mid = (size - 1) / 2.0
    si = _reflect(c * (pi - mid) + s * (pj - mid) + (crop - 1) / 2.0, crop)
    sj = _reflect(-s * (pi - mid) + c * (pj - mid) + (crop - 1) / 2.0, crop)
    i0 = np.clip(np.floor(si).astype(np.int64), 0, crop - 2)
    j0 = np.clip(np.floor(sj).astype(np.int64), 0, crop - 2)
    fi, fj = (si - i0)[..., None], (sj - j0)[..., None]
    val = (src[i0, j0] * (1 - fi) * (1 - fj) + src[i0, j0 + 1] * (1 - fi) * fj
           + src[i0 + 1, j0] * fi * (1 - fj) + src[i0 + 1, j0 + 1] * fi * fj)
    val = np.where(inside[..., None], val, 0.0)
    pad = (size - crop) // 2
    labels = (val[pad:pad + crop, pad:pad + crop, 1] > 127.0).astype(np.int32)
    inp = val[..., 0]
    inp = (inp - inp.min()) / max(inp.max() - inp.min(), 1e-12)
    return inp, labels
