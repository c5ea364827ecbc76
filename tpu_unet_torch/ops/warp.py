"""Geometric warps on the device: Gaussian smoothing, bilinear and cubic
resampling, rotation and Simard elastic fields (counterpart of the parts of
``tpu_unet/ops/warp.py`` that the augmentation uses).

* ``scipy.ndimage.gaussian_filter(x, sigma, mode='constant')`` ->
  `gaussian_filter`, as banded blur matrices (Bv @ x @ Bh^T).
* ``scipy.ndimage.map_coordinates(x, coords, order=1, mode='constant')``
  -> `map_coordinates_bilinear`, with scipy's hard fill outside [0, n-1].
* order 3 -> `map_coordinates_cubic`: B-spline prefilter as a dense
  matrix, 16 taps with mirror-folded indices.

Every function takes [H, W] images, and leading batch dimensions where its
docstring says so. Random fields are drawn from a `torch.Generator`, or
passed in, so that tests can feed both packages the same numbers.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_unet_torch.ops.pad import fold_reflect


def _gaussian_kernel1d_np(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _blur_matrix(n: int, sigma: float, truncate: float, device: torch.device
                 ) -> torch.Tensor:
    k = _gaussian_kernel1d_np(sigma, truncate)
    r = (len(k) - 1) // 2
    b = np.zeros((n, n), np.float32)
    for off in range(-r, r + 1):
        b += np.diag(np.full(n - abs(off), k[off + r], np.float32), off)
    return torch.from_numpy(b).to(device)


def gaussian_blur_matrix(n: int, sigma: float, truncate: float = 4.0,
                         device=None) -> torch.Tensor:
    """[n, n] banded Toeplitz matrix B with B[i, j] = kernel[j - i + r]
    (zero outside the band): B @ x blurs along an axis with the constant-0
    boundary of scipy's 'constant' mode (radius int(truncate*sigma + 0.5)).

    Built once per (n, sigma, truncate, device) and shared: the caller must
    not write to it (JAX builds it once per trace; rebuilding it on the host
    at every call cost more than the rest of the augmentation)."""
    return _blur_matrix(n, float(sigma), float(truncate), torch.device(device or "cpu"))


def gaussian_filter(img: torch.Tensor, sigma: float, truncate: float = 4.0
                    ) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] images with constant-0
    boundary: Bv @ img @ Bh^T."""
    h, w = img.shape[-2:]
    bv = gaussian_blur_matrix(h, sigma, truncate, img.device)
    bh = gaussian_blur_matrix(w, sigma, truncate, img.device)
    return (bv @ img.float()) @ bh.T


def map_coordinates_bilinear(img: torch.Tensor,
                             coords: Tuple[torch.Tensor, torch.Tensor],
                             cval: float = 0.0) -> torch.Tensor:
    """Bilinear resampling of an [H, W] image at coordinates (ci, cj) of any
    one shape, with scipy's hard `cval` fill for any coordinate outside
    [0, n-1] (no blending of `cval` at the border)."""
    h, w = img.shape
    x = img.float()
    ci, cj = coords
    fi, fj = torch.floor(ci), torch.floor(cj)
    wi1, wj1 = ci - fi, cj - fj
    wi0, wj0 = 1 - wi1, 1 - wj1
    i0, j0 = fi.long(), fj.long()
    out = 0
    for ii, wi in ((i0, wi0), (i0 + 1, wi1)):
        for jj, wj in ((j0, wj0), (j0 + 1, wj1)):
            valid = (ii >= 0) & (ii < h) & (jj >= 0) & (jj < w)
            v = x[ii.clamp(0, h - 1), jj.clamp(0, w - 1)]
            out = out + (wi * wj) * torch.where(valid, v, cval)
    inside = (ci >= 0) & (ci <= h - 1) & (cj >= 0) & (cj <= w - 1)
    return torch.where(inside, out, cval)


def _bspline3_collocation_np(n: int) -> np.ndarray:
    """[n, n] cubic B-spline collocation matrix with mirror boundary."""
    b = np.zeros((n, n), np.float64)
    for i in range(n):
        for off, wgt in ((-1, 1 / 6), (0, 4 / 6), (1, 1 / 6)):
            j = i + off
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * (n - 1) - j
            b[i, j] += wgt
    return b


@functools.lru_cache(maxsize=16)
def _spline_matrix(n: int, device: torch.device) -> torch.Tensor:
    f = np.linalg.inv(_bspline3_collocation_np(n)).astype(np.float32)
    return torch.from_numpy(f).to(device)


def spline_filter_matrix(n: int, device=None) -> torch.Tensor:
    """[n, n] dense cubic-spline prefilter F = B^-1 (mirror boundary), as
    ``scipy.ndimage.spline_filter1d(order=3)``. Built once per (n, device)
    and shared: the caller must not write to it."""
    return _spline_matrix(n, torch.device(device or "cpu"))


def _bspline3_weights(t: torch.Tensor):
    """Cubic B-spline weights of the taps at offsets (-1, 0, 1, 2) around
    the integer part, t the fractional part in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w_0 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w_p1 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w_p2 = t3 / 6.0
    return (w_m1, w_0, w_p1, w_p2)


def _mirror_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect integer indices into [0, n-1] (mirror without edge repeat)."""
    idx = torch.abs(idx)
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def map_coordinates_cubic(img: torch.Tensor,
                          coords: Tuple[torch.Tensor, torch.Tensor],
                          cval: float = 0.0, prefiltered: bool = False
                          ) -> torch.Tensor:
    """Cubic B-spline resampling of an [H, W] image, as
    ``scipy.ndimage.map_coordinates(img, coords, order=3, mode='constant')``
    for coordinates at least one knot inside the image. `prefiltered`: `img`
    already holds the spline coefficients."""
    h, w = img.shape
    x = img.float()
    if not prefiltered:
        x = (spline_filter_matrix(h, x.device) @ x) @ spline_filter_matrix(w, x.device).T
    ci, cj = coords
    i0 = torch.floor(ci).long()
    j0 = torch.floor(cj).long()
    wi = _bspline3_weights(ci - i0)
    wj = _bspline3_weights(cj - j0)
    flat = x.reshape(-1)
    out = torch.zeros(ci.shape, dtype=torch.float32, device=x.device)
    rows = [_mirror_index(i0 + di, h) for di in (-1, 0, 1, 2)]
    cols = [_mirror_index(j0 + dj, w) for dj in (-1, 0, 1, 2)]
    for a in range(4):
        row_base = rows[a] * w
        for b in range(4):
            out = out + wi[a] * wj[b] * flat[row_base + cols[b]]
    inside = (ci >= 0) & (ci <= h - 1) & (cj >= 0) & (cj <= w - 1)
    return torch.where(inside, out, cval)


def _angle_trig(angle_deg) -> Tuple[torch.Tensor, torch.Tensor]:
    theta = torch.deg2rad(torch.as_tensor(angle_deg).float())
    return torch.cos(theta), torch.sin(theta)


def rotation_coords(out_size: int, in_shape: Tuple[int, int], angle_deg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates sampling an `out_size`^2 window rotated by
    `angle_deg` (counterclockwise, scipy's convention) about the input's
    center."""
    h, w = in_shape
    cos, sin = _angle_trig(angle_deg)
    o = torch.arange(out_size, dtype=torch.float32, device=cos.device) - (out_size - 1) / 2.0
    gi, gj = torch.meshgrid(o, o, indexing="ij")
    # inverse rotation: an output pixel pulls from R(-theta) p
    src_i = cos * gi + sin * gj + (h - 1) / 2.0
    src_j = -sin * gi + cos * gj + (w - 1) / 2.0
    return src_i, src_j


def rotate_about_center(img: torch.Tensor, angle_deg, out_size: int,
                        order: int = 1) -> torch.Tensor:
    """Rotate an [H, W] image about its center and return the central
    `out_size`^2 window, reflect-folding the source coordinates (so the
    reflect padding around the image never materialises). order 1 bilinear,
    3 cubic B-spline."""
    si, sj = rotation_coords(out_size, img.shape, torch.as_tensor(angle_deg,
                                                                  device=img.device))
    si = fold_reflect(si, img.shape[0])
    sj = fold_reflect(sj, img.shape[1])
    if order == 3:
        return map_coordinates_cubic(img, (si, sj))
    return map_coordinates_bilinear(img, (si, sj))


def draw_uniform_fields(shape: Tuple[int, ...], generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two U(-1, 1) f32 fields of `shape`, drawn in turn from `generator`,
    on its device."""
    u1 = torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0
    u2 = torch.rand(shape, generator=generator, device=generator.device) * 2.0 - 1.0
    return u1, u2


def elastic_fields(shape: Tuple[int, int], alpha: float, sigma: float,
                   generator: Optional[torch.Generator] = None,
                   u1: Optional[torch.Tensor] = None,
                   u2: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simard-2003 elastic displacement fields: dx = gaussian_filter(u1,
    sigma) * alpha, dy likewise from u2, with u1, u2 ~ U(-1, 1) of `shape`,
    given or drawn from `generator`."""
    if u1 is None or u2 is None:
        if generator is None:
            raise ValueError("elastic_fields needs u1 and u2, or a generator")
        u1, u2 = draw_uniform_fields(shape, generator)
    if tuple(u1.shape[-2:]) != tuple(shape) or u1.shape != u2.shape:
        raise ValueError(f"fields {tuple(u1.shape)}, {tuple(u2.shape)} are not {shape}")
    return gaussian_filter(u1, sigma) * alpha, gaussian_filter(u2, sigma) * alpha


def elastic_warp(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor
                 ) -> torch.Tensor:
    """out[i, j] = img[i + dx, j + dy], bilinear, constant 0 outside."""
    h, w = img.shape
    gi, gj = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img.device),
                            torch.arange(w, dtype=torch.float32, device=img.device),
                            indexing="ij")
    return map_coordinates_bilinear(img, (gi + dx, gj + dy))
