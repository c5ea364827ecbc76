"""Augmentation on the device (counterpart of ``tpu_unet/data/augment.py``).

Per sample, as in the JAX package:
  1. a foreground-balanced random crop: a categorical draw over the image's
     crop-origin log-probs (-inf entries are never drawn), +-skip/2
     jitter, clamped to the image;
  2. a rotation by a multiple of `rotate_step` degrees about the crop
     center, with reflect-folded context, composed with
  3. a joint Simard elastic deformation of image and target (one smoothed
     displacement field for both);
  4. the target center-cropped to the supervision window and binarised at
     127; the image min/ptp-normalised.

`_augment_one` of the JAX package is split in two here: `draw_augment`
takes a `torch.Generator` and returns the random values (crop id, jitter,
angle and the two uniform fields), and `_augment_one` is the deterministic
core that takes them. JAX's random bits differ from torch's, so the tests
feed the core the values drawn from a JAX key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu_unet_torch.config import AugmentConfig
from tpu_unet_torch.ops.pad import fold_reflect
from tpu_unet_torch.ops.warp import (_angle_trig, _bspline3_weights, _mirror_index,
                                     draw_uniform_fields, elastic_fields, elastic_warp,
                                     map_coordinates_bilinear, rotate_about_center,
                                     spline_filter_matrix)


class AugmentDraws(NamedTuple):
    """The random values of one sample's augmentation (device tensors)."""

    cid: torch.Tensor      # [] int64 crop-origin id
    jitter: torch.Tensor   # [2] int64
    angle: torch.Tensor    # [] f32 degrees
    u1: torch.Tensor       # [S, S] f32 in [-1, 1)
    u2: torch.Tensor       # [S, S] f32 in [-1, 1)


def draw_augment(generator: torch.Generator, log_probs: torch.Tensor, *,
                 input_size: int, rotate_step: int, skip: int) -> AugmentDraws:
    """One sample's draws from `generator`, on the generator's device:
    crop id ~ categorical(log_probs), jitter ~ U{-skip//2 .. skip//2}^2,
    angle = rotate_step * U{0 .. 360//rotate_step - 1}, two U(-1, 1)
    fields. No host sync."""
    dev = generator.device
    probs = torch.softmax(log_probs.to(dev).double(), dim=-1)
    cid = torch.multinomial(probs, 1, generator=generator)[0]
    jitter = torch.randint(-(skip // 2), skip // 2 + 1, (2,), generator=generator,
                           device=dev)
    n_angles = 360 // rotate_step
    angle = (torch.randint(0, n_angles, (), generator=generator, device=dev)
             * rotate_step).float()
    u1, u2 = draw_uniform_fields((input_size, input_size), generator)
    return AugmentDraws(cid, jitter, angle, u1, u2)


_GATHERS = ("stacked", "take4")


def _bilinear_multi(src: torch.Tensor, si: torch.Tensor, sj: torch.Tensor,
                    gather: str = "stacked") -> torch.Tensor:
    """Bilinear sample of a channel-stacked source [H, W, C] at shared
    coordinates already folded into [0, n-1].

    gather='stacked': the four neighbour-shifted copies of the flat source
    stacked along channels, one gather of [H*W, 4C]. The rolls' wrapped
    tail rows are never addressed: base <= h*w - w - 2 by the clamps.
    gather='take4': one gather per tap. The taps, weights and sums are the
    same, so the two agree bit for bit. Another name raises ValueError
    (JAX takes any other string as 'stacked')."""
    if gather not in _GATHERS:
        raise ValueError(f"gather must be one of {_GATHERS}, got {gather!r}")
    h, w, c = src.shape
    i0 = torch.clamp(torch.floor(si).long(), 0, h - 2)
    j0 = torch.clamp(torch.floor(sj).long(), 0, w - 2)
    fi = (si - i0)[..., None]
    fj = (sj - j0)[..., None]
    flat = src.reshape(h * w, c)
    base = i0 * w + j0
    if gather == "take4":
        v00, v01, v10, v11 = flat[base], flat[base + 1], flat[base + w], flat[base + w + 1]
    else:
        nb = torch.cat([flat, torch.roll(flat, -1, 0), torch.roll(flat, -w, 0),
                        torch.roll(flat, -(w + 1), 0)], dim=1)         # [h*w, 4c]
        g = nb[base]
        v00, v01 = g[..., 0:c], g[..., c:2 * c]
        v10, v11 = g[..., 2 * c:3 * c], g[..., 3 * c:]
    return (v00 * (1 - fi) * (1 - fj) + v01 * (1 - fi) * fj
            + v10 * fi * (1 - fj) + v11 * fi * fj)


def _cubic_multi(coeffs: torch.Tensor, si: torch.Tensor, sj: torch.Tensor
                 ) -> torch.Tensor:
    """Cubic B-spline sample of channel-stacked prefiltered coefficients
    [H, W, C] at shared coordinates (16 taps, mirror-folded near edges)."""
    h, w, c = coeffs.shape
    i0 = torch.floor(si).long()
    j0 = torch.floor(sj).long()
    wi = _bspline3_weights(si - i0)
    wj = _bspline3_weights(sj - j0)
    flat = coeffs.reshape(h * w, c)
    out = torch.zeros(si.shape + (c,), dtype=torch.float32, device=coeffs.device)
    for a in range(4):
        row = _mirror_index(i0 + (a - 1), h) * w
        for b in range(4):
            taps = flat[row + _mirror_index(j0 + (b - 1), w)]
            out = out + (wi[a] * wj[b])[..., None] * taps
    return out


def _composite_coords(shape: Tuple[int, int], angle_deg: torch.Tensor, dx: torch.Tensor,
                      dy: torch.Tensor, canvas_size: int, offset: int, out_size: int):
    """Source coordinates (si, sj) of the composite rotate-then-elastic
    sample over the canvas window [offset, offset + out_size), folded into
    the [H, W] source, and the mask of points whose displaced position stays
    inside the canvas."""
    h, w = shape
    ar = torch.arange(out_size, dtype=torch.float32, device=dx.device) + offset
    pi = ar[:, None] + dx
    pj = ar[None, :] + dy
    inb = (pi >= 0) & (pi <= canvas_size - 1) & (pj >= 0) & (pj <= canvas_size - 1)
    cos, sin = _angle_trig(angle_deg)
    co = (canvas_size - 1) / 2.0
    qi = pi - co
    qj = pj - co
    si = fold_reflect(cos * qi + sin * qj + (h - 1) / 2.0, h)
    sj = fold_reflect(-sin * qi + cos * qj + (w - 1) / 2.0, w)
    return si, sj, inb


def _fused_rotate_elastic_multi(src: torch.Tensor, angle_deg: torch.Tensor,
                                dx: torch.Tensor, dy: torch.Tensor,
                                canvas_size: int, order: int = 1,
                                gather: str = "stacked") -> torch.Tensor:
    """Rotate-then-elastic of a channel-stacked source [H, W, C] as one
    sample of the composite coordinate: out(p) = rotated(p + d), with
    rotated(q) = src[fold(R(q - c_out) + c_in)] and the elastic warp's
    constant-0 fill outside the rotated canvas. order 3 samples with the
    cubic B-spline kernel on prefiltered coefficients; order 1 gathers as
    `gather` says (see `_bilinear_multi`)."""
    h, w, _ = src.shape
    si, sj, inb = _composite_coords((h, w), angle_deg, dx, dy, canvas_size, 0, canvas_size)
    if order == 3:
        fv = spline_filter_matrix(h, src.device)
        fh = spline_filter_matrix(w, src.device)
        coeffs = torch.einsum("im,jn,mnc->ijc", fv, fh, src.float())
        val = _cubic_multi(coeffs, si, sj)
    else:
        val = _bilinear_multi(src.float(), si, sj, gather=gather)
    return torch.where(inb[..., None], val, 0.0)


def _fused_rotate_elastic(img: torch.Tensor, angle_deg: torch.Tensor,
                          dx: torch.Tensor, dy: torch.Tensor, canvas_size: int,
                          offset: int = 0, out_size: Optional[int] = None) -> torch.Tensor:
    """Rotate-then-elastic of one image [H, W] as one bilinear sample of the
    composite coordinate (`_fused_rotate_elastic_multi` for a single
    channel, through `map_coordinates_bilinear`).

    `canvas_size` is the rotated canvas's extent (the network input size);
    `offset` and `out_size` evaluate only the window [offset, offset +
    out_size) of it, and `dx`/`dy` must already be that window's slice."""
    out_size = canvas_size if out_size is None else out_size
    si, sj, inb = _composite_coords(img.shape, angle_deg, dx, dy, canvas_size, offset,
                                    out_size)
    val = map_coordinates_bilinear(img, (si, sj))
    return torch.where(inb, val, 0.0)


def _augment_one(image: torch.Tensor, target: torch.Tensor, draws: AugmentDraws,
                 *, pairs: torch.Tensor, crop: int, input_size: int, alpha: float,
                 sigma: float, fused_warp: bool, rotate_order: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic core: image [H, W] f32, target [H, W] f32 in
    {0, 255}, and one sample's draws -> (input [S, S, 1] f32, labels
    [crop, crop] int32)."""
    dev = image.device
    origin = pairs[draws.cid].to(dev) + draws.jitter.to(dev)
    oy = torch.clamp(origin[0], 0, image.shape[0] - crop)
    ox = torch.clamp(origin[1], 0, image.shape[1] - crop)
    span = torch.arange(crop, device=dev)
    rows, cols = oy + span, ox + span                 # device offsets: no sync
    img_c = image[rows][:, cols]
    tgt_c = target[rows][:, cols]

    dx, dy = elastic_fields((input_size, input_size), alpha, sigma,
                            u1=draws.u1.to(dev), u2=draws.u2.to(dev))
    angle = draws.angle.to(dev)
    pad = (input_size - crop) // 2
    if fused_warp:
        out = _fused_rotate_elastic_multi(torch.stack([img_c, tgt_c], -1), angle,
                                          dx, dy, input_size, order=rotate_order)
        inp = out[..., 0]
        gt_w = out[pad:pad + crop, pad:pad + crop, 1]
    else:
        img_r = rotate_about_center(img_c, angle, input_size, order=rotate_order)
        tgt_r = rotate_about_center(tgt_c, angle, input_size, order=rotate_order)
        inp = elastic_warp(img_r, dx, dy)
        gt_w = elastic_warp(tgt_r, dx, dy)[pad:pad + crop, pad:pad + crop]
    gt = (gt_w > 127.0).to(torch.int32)
    # a constant crop has ptp 0: guard the division
    lo = inp.min()
    inp = (inp - lo) / torch.clamp_min(inp.max() - lo, 1e-12)
    return inp[..., None], gt


class AugmentPipeline:
    """Batched augmentation over device-resident stacks."""

    def __init__(self, aug: AugmentConfig):
        self.aug = aug
        self.crop = aug.crop
        self.input_size = aug.input_size

    def draw(self, generator: torch.Generator, log_probs: torch.Tensor
             ) -> AugmentDraws:
        return draw_augment(generator, log_probs, input_size=self.input_size,
                            rotate_step=self.aug.rotate_step_deg,
                            skip=self.aug.crop_grid_skip)

    def __call__(self, images: torch.Tensor, targets: torch.Tensor,
                 log_probs: torch.Tensor, pairs: torch.Tensor, indices,
                 generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        """images/targets [N, H, W], log_probs [N, P], pairs [P, 2], indices
        [B] (host ints), generator -> (inputs [B, S, S, 1] f32, labels
        [B, c, c] int32). Sample k of the batch takes the k-th draws from
        `generator`."""
        aug = self.aug
        inputs, labels = [], []
        for i in [int(i) for i in indices]:
            draws = self.draw(generator, log_probs[i])
            inp, gt = _augment_one(
                images[i], targets[i], draws, pairs=pairs, crop=self.crop,
                input_size=self.input_size, alpha=aug.elastic_alpha,
                sigma=aug.elastic_sigma, fused_warp=aug.fused_warp, rotate_order=aug.rotate_order)
            inputs.append(inp)
            labels.append(gt)
        return torch.stack(inputs), torch.stack(labels)
