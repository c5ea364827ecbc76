"""The overlap-tile strategy (Ronneberger et al. 2015, Fig. 2) written
plainly, in NumPy: where the tiles lie, how a frame becomes tiles, how
tile outputs become a map, and the per-image metrics. It imports nothing
of the program.

Output tiles start on multiples of one pooling period (2^depth), at a
stride of the tile rounded down to it, the last start rounded up past
``extent - tile``; the frame is min/ptp normalised and mirror-padded by
the network's context / 2, so the input window of an output tile starts
at the tile's own origin in padded coordinates. A later tile overwrites
an earlier one where they overlap.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def valid_output(size: int, depth: int) -> int:
    """The output side of a valid-conv U-Net on a size x size input."""
    s = size
    for _ in range(depth):
        s = (s - 4) // 2
    s -= 4
    for _ in range(depth):
        s = 2 * s - 4
    return s


def tile_input(tile_out: int, depth: int) -> int:
    """The input side whose output is `tile_out`."""
    s = tile_out
    while valid_output(s, depth) < tile_out:
        s += 2
    if valid_output(s, depth) != tile_out:
        raise ValueError(f"{tile_out} is not a valid U-Net output side at depth {depth}")
    return s


def crop_input(crop: int, depth: int) -> int:
    """The training input side for a `crop` x `crop` supervision window:
    the smallest valid input, searched from a bottleneck side of 20 up in
    steps of 2, whose output covers the crop (572 for 388)."""
    b = 20
    while True:
        s_in, s_out = b, b - 4
        for _ in range(depth):
            s_in, s_out = 2 * s_in + 4, 2 * s_out - 4
        if s_out >= crop:
            return s_in
        b += 2


def starts(extent: int, tile: int, align: int) -> List[int]:
    if extent <= tile:
        return [0]
    stride = max(align, (tile // align) * align)
    last = -(-(extent - tile) // align) * align
    return list(range(0, last, stride)) + [last]


class Plan:
    def __init__(self, h: int, w: int, tile_out: int, depth: int):
        self.h, self.w, self.tile_out = h, w, tile_out
        self.tile_in = tile_input(tile_out, depth)
        self.pad = (self.tile_in - tile_out) // 2
        ys, xs = starts(h, tile_out, 2 ** depth), starts(w, tile_out, 2 ** depth)
        self.origins: List[Tuple[int, int]] = [(y, x) for y in ys for x in xs]
        self.canvas = (ys[-1] + tile_out, xs[-1] + tile_out)

    @property
    def num_tiles(self) -> int:
        return len(self.origins)

    def tiles(self, frames: np.ndarray) -> np.ndarray:
        """[N, H, W] frames -> [N * T, tile_in, tile_in, 1] f32 tiles."""
        f = frames.astype(np.float64)
        lo = f.min(axis=(1, 2), keepdims=True)
        f = (f - lo) / np.maximum(f.max(axis=(1, 2), keepdims=True) - lo, 1e-12)
        p = self.pad
        f = np.pad(f, ((0, 0), (p, p + self.canvas[0] - self.h),
                       (p, p + self.canvas[1] - self.w)), mode="reflect")
        ti = self.tile_in
        t = np.stack([f[:, y:y + ti, x:x + ti] for (y, x) in self.origins], axis=1)
        return t.reshape(-1, ti, ti, 1).astype(np.float32)

    def stitch(self, tile_maps: np.ndarray) -> np.ndarray:
        """[N * T, to, to] -> [N, H, W], later tiles over earlier ones."""
        to = self.tile_out
        per = tile_maps.reshape(-1, self.num_tiles, to, to)
        out = np.zeros((per.shape[0],) + self.canvas, tile_maps.dtype)
        for i, (y, x) in enumerate(self.origins):
            out[:, y:y + to, x:x + to] = per[:, i]
        return out[:, :self.h, :self.w]


def metrics(maps: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """[N, 2] per image: IoU of the nonzero masks and pixel error (the mean
    absolute difference of the two {0, 1} maps), in float64."""
    p = (maps != 0).reshape(maps.shape[0], -1)
    g = (labels != 0).reshape(labels.shape[0], -1)
    inter = (p & g).sum(1).astype(np.float64)
    union = (p | g).sum(1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / union
    pe = np.abs(maps.astype(np.float64) - labels.astype(np.float64)).reshape(maps.shape[0], -1).mean(1)
    return np.stack([iou, pe], axis=1)
