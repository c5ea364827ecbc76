"""Spatial (strip) parallelism with a halo exchange (counterpart of
``tpu_unet/parallel/halo.py``): the convnet's context parallelism, for
images whose activations do not fit one device.

One image's rows are split over the ``spatial`` axis. Each rank computes
the valid U-Net output of its strip, which needs ``CONTEXT // 2`` (92) rows
of receptive field above and below it: the neighbours' edge rows, or a
local mirror at the image's border. Columns are whole on every rank and
mirrored locally.

The JAX package moves the halo with ``ppermute`` between ring neighbours.
Here every rank all-gathers its top and bottom 92 input rows inside its
``spatial`` group and picks its neighbours' (92 x W x 4 bytes of the
one-channel input a rank), one formulation that NCCL and gloo both take
(gloo has no send/recv of CUDA tensors). The exchanged rows are input
pixels, so no gradient flows through the exchange; the one gradient
collective is the parameter all-reduce.

The train steps divide each rank's weighted sum by the *global* count, so
their parameter gradients are summed over the mesh, not averaged.

Constraints (raised): `strip_h` + 184 and `width` + 184 are valid input
sizes, and `strip_h` > 92 so one neighbour supplies the halo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_unet_torch.core.geometry import CONTEXT, output_size_for_input
from tpu_unet_torch.losses.bce import binary_cross_entropy
from tpu_unet_torch.parallel.mesh import (all_gather_cat, all_gather_list, all_reduce_grads,
                                          axis_size)

PAD = CONTEXT // 2


def _check_strips(strip_h: int, width: int) -> None:
    # strip + context must be a valid input size; raises otherwise
    output_size_for_input(strip_h + CONTEXT)
    output_size_for_input(width + CONTEXT)
    if strip_h <= PAD:
        raise ValueError(
            f"strip height {strip_h} <= halo {PAD}: one neighbour cannot supply the "
            f"receptive field (and edge mirrors need pad+1 rows); use fewer ranks "
            f"or larger strips")


def _halo_forward_local(model, strips: torch.Tensor, mesh: DeviceMesh,
                        axis: str) -> torch.Tensor:
    """strips [b, s, W], this rank's rows of b images -> logits [b, s, W, C]:
    the neighbours' rows above and below (mirrored at the image's border),
    columns mirrored locally, then the network."""
    n, i = axis_size(mesh, axis), mesh.get_local_rank(axis)
    edges = all_gather_list(torch.cat([strips[:, :PAD], strips[:, -PAD:]], dim=1),
                            mesh, axis)                        # n x [b, 2 PAD, W]
    top = strips[:, 1:PAD + 1].flip(1) if i == 0 else edges[i - 1][:, PAD:]
    bottom = strips[:, -PAD - 1:-1].flip(1) if i == n - 1 else edges[i + 1][:, :PAD]
    x = torch.cat([top, strips, bottom], dim=1)
    x = torch.cat([x[:, :, 1:PAD + 1].flip(2), x, x[:, :, -PAD - 1:-1].flip(2)], dim=2)
    return model(x[..., None])


def _weighted_sum_and_counts(model, strips, gts, mesh, axis):
    """The shared part of both train steps: this rank's weighted BCE sum
    (class balance from each image's counts over the `axis` group), its
    element count, and each image's [n_cell, n_bg, inter, union, |pred - gt|]
    summed over the group (f32; exact, summed in f64)."""
    logits = _halo_forward_local(model, strips, mesh, axis)        # [b, s, W, C]
    with torch.no_grad():
        pred = logits.argmax(-1)
        y = gts.float()
        counts = torch.stack([
            y.sum((1, 2)), (1.0 - y).sum((1, 2)),
            ((pred != 0) & (gts != 0)).sum((1, 2)).float(),
            ((pred != 0) | (gts != 0)).sum((1, 2)).float(),
            (pred - gts).abs().sum((1, 2)).float()], dim=1).double()
        dist.all_reduce(counts, group=mesh.get_group(axis))
        counts = counts.float()
        n_cell, n_bg = counts[:, 0], counts[:, 1]
        bg_w = torch.where(n_bg > 0, n_cell / torch.clamp_min(n_bg, 1.0), 1.0)
        bg_w = torch.where((n_cell > 0) & (n_bg > 0), bg_w, 1.0)
        w = torch.where(gts != 0, 1.0, bg_w[:, None, None])[..., None]
    bce = binary_cross_entropy(logits, gts)
    return (w * bce).sum(), bce.numel(), counts


def _global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def make_halo_train_step(model, opt: torch.optim.Optimizer, mesh: DeviceMesh,
                         strip_h: int, width: int, axis: str = "spatial"):
    """Train on one image whose rows are split over `axis`.

    step(strip [strip_h, width] f32, gt [strip_h, width] int) with this
    rank's rows -> (loss, (iou, pixel_error)), equal on every rank: class
    balance from the image's global counts, the loss the global weighted
    sum over the global count, IoU and pixel error exact over the image.
    The IoU divides by the union unguarded (NaN when it is 0), as the JAX
    package's does. Updates `model` and `opt` in place."""
    _check_strips(strip_h, width)
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)

    def step(strip: torch.Tensor, gt: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        loss_sum, size, counts = _weighted_sum_and_counts(model, strip[None], gt[None],
                                                          mesh, axis)
        count = float(n * size)
        (loss_sum / count).backward()
        all_reduce_grads(model.parameters(), group)
        opt.step()
        inter, union, pe = counts[0, 2], counts[0, 3], counts[0, 4]
        loss = _global_sum(loss_sum, group) / count
        return loss, (inter / union, pe / float(n * strip_h * width))

    return step


def make_dp_halo_train_step(model, opt: torch.optim.Optimizer, mesh: DeviceMesh,
                            strip_h: int, width: int, data_axis: str = "data",
                            spatial_axis: str = "spatial"):
    """Train on a batch of images split over `data_axis`, each image's rows
    over `spatial_axis` (a 2-D mesh).

    step(strips [b, strip_h, width], gts [b, strip_h, width]) with this
    rank's block of images and rows -> (loss, (mean IoU, mean pixel error)),
    equal on every rank: class balance from each image's counts over
    `spatial_axis`, the loss and the parameter gradients summed over both
    axes, metrics per image, then averaged over the global batch."""
    _check_strips(strip_h, width)
    n_s, n_d = axis_size(mesh, spatial_axis), axis_size(mesh, data_axis)

    def step(strips: torch.Tensor, gts: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        loss_sum, size, counts = _weighted_sum_and_counts(model, strips, gts, mesh,
                                                          spatial_axis)
        count = float(n_d * n_s * size)
        (loss_sum / count).backward()
        all_reduce_grads(model.parameters())                    # the whole mesh
        opt.step()
        inter, union, pe = counts[:, 2], counts[:, 3], counts[:, 4]
        per_image = torch.stack([(inter / torch.clamp_min(union, 1.0)).sum(),
                                 (pe / float(n_s * strip_h * width)).sum()])
        means = _global_sum(per_image, mesh.get_group(data_axis)) / float(strips.shape[0] * n_d)
        loss = _global_sum(loss_sum) / count
        return loss, (means[0], means[1])

    return step


def halo_strip_inference(model, mesh: DeviceMesh, strip_h: int, width: int,
                         axis: str = "spatial"):
    """fwd(strip [strip_h, width] f32, this rank's rows of an image already
    normalized) -> the whole image's logits [n * strip_h, width, C], on
    every rank."""
    _check_strips(strip_h, width)

    @torch.inference_mode()
    def fwd(strip: torch.Tensor) -> torch.Tensor:
        if tuple(strip.shape) != (strip_h, width):
            raise ValueError(f"expected a strip of {(strip_h, width)}, got {tuple(strip.shape)}")
        return all_gather_cat(_halo_forward_local(model, strip[None], mesh, axis)[0],
                              mesh, axis)

    return fwd
