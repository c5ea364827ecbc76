"""Overlap-tile inference engine (counterpart of ``tpu_unet/infer/tiles.py``).

The paper's overlap-tile strategy: tile the output domain
(``tpu_unet_torch.core.geometry.plan_tiles``), mirror-pad each tile's
receptive-field context, run the valid-conv network per tile, stitch. With
`tile_out` >= the image size it is one whole-image tile. The model plans its
own tiles (``model.tile_plan``): a same-padded network such as TransUNet
takes each frame whole, as one tile with no margin
(``core.geometry.whole_frame_plan``).

The batch entry points gather tiles across all images into one flat batch,
run it through the model in chunks of `batch_tiles`, take the argmax per
tile and stitch int32 class maps per image. Tile origins are aligned to the
pooling period, so overlapping tiles agree and argmax-then-stitch is exact.

Everything runs on the model's device under ``torch.inference_mode()``.
On a mesh, each chunk's tiles are spread over the ranks of one axis and the
results gathered, so every rank returns the whole result.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_unet_torch.core.geometry import TilePlan
from tpu_unet_torch.losses.metrics import batch_evaluation_metrics
from tpu_unet_torch.models.unet import center_crop_or_pad
from tpu_unet_torch.ops.pad import reflect_pad
from tpu_unet_torch.parallel.mesh import all_gather_cat, axis_size
from tpu_unet_torch.utils.profiling import span


class TileInference:
    """Overlap-tile predictor for a fixed image shape."""

    def __init__(self, model, image_h: int, image_w: int,
                 tile_out=None, batch_tiles: int = 16,
                 normalize: bool = True, mesh=None, mesh_axis: str = "data",
                 apply_fn=None):
        """`model`: a network holding its weights on the device to run on,
        whose ``tile_plan(image_h, image_w, tile_out)`` plans its tiles: a
        `tpu_unet_torch.models.UNet` (valid convs) its overlap tiles, where
        tile_out=None plans one whole-image tile and an (h, w) pair
        rectangular strip tiles; a same-padded network such as
        `models.transunet.TransUNet` the whole frame as one tile, with no
        margin. `batch_tiles` tiles go through the model per forward, on
        every entry point.

        `mesh`: a ``DeviceMesh`` (parallel/mesh.py::make_mesh) whose
        `mesh_axis` spreads each chunk of tiles over its ranks: each rank
        runs its block, the results are gathered, and every rank stitches
        and returns the whole result. batch_tiles is rounded up to a
        multiple of the axis size.

        `apply_fn(tiles) -> logits` replaces the model's forward for the
        tile batches, e.g. an int8 `QuantInference.apply` (infer/quant.py);
        the model then only names the device."""
        if mesh is not None and mesh_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {mesh_axis!r} "
                             f"(axes {mesh.mesh_dim_names})")
        if batch_tiles < 1:
            raise ValueError(f"batch_tiles must be >= 1, got {batch_tiles}")
        self.model = model
        self.apply_fn = apply_fn
        self.device = next(model.parameters()).device
        self.plan: TilePlan = model.tile_plan(image_h, image_w, tile_out)
        self.batch_tiles = batch_tiles
        self.normalize = normalize
        self.mesh, self.mesh_axis = mesh, mesh_axis
        if mesh is not None:
            n = axis_size(mesh, mesh_axis)
            self.batch_tiles = -(-batch_tiles // n) * n

    def _on_device(self, a, dtype=None) -> torch.Tensor:
        with span("tiles.upload"):
            if not torch.is_tensor(a):
                a = torch.from_numpy(np.asarray(a))
            return a.to(self.device, dtype)

    def _forward(self, tile_batch: torch.Tensor) -> torch.Tensor:
        """[b, ti_h, ti_w, 1] -> [b, to_h, to_w, C] f32 logits."""
        fwd = self.model if self.apply_fn is None else self.apply_fn
        return center_crop_or_pad(fwd(tile_batch), self.plan.tile_out_hw)

    def _flat_tiles(self, images: torch.Tensor) -> torch.Tensor:
        """[N, H, W] f32 -> [N*T, ti_h, ti_w, 1] gathered input tiles."""
        p = self.plan
        ti_h, ti_w = p.tile_in_hw
        with span("tiles.cut"):
            if self.normalize:
                # guard: a constant image has ptp 0 -> NaN logits otherwise
                lo = images.amin(dim=(1, 2), keepdim=True)
                ptp = images.amax(dim=(1, 2), keepdim=True) - lo
                images = (images - lo) / torch.clamp(ptp, min=1e-12)
            padded = reflect_pad(
                images,
                ((p.pad, p.pad + p.canvas_h - p.image_h),
                 (p.pad, p.pad + p.canvas_w - p.image_w)),
            )
            tiles = torch.stack([padded[:, y:y + ti_h, x:x + ti_w]
                                 for (y, x) in p.origins], dim=1)
            return tiles.reshape(-1, ti_h, ti_w, 1)

    def _chunks(self, flat: torch.Tensor):
        """Split `flat` into `batch_tiles`-sized chunks; the last is filled
        up by cycling the real tiles, so every forward sees one batch size.
        On a mesh a chunk stays a positive multiple of the axis size, filled
        up from fewer tiles than that too."""
        m = flat.shape[0]
        c = min(self.batch_tiles, m)
        if self.mesh is not None:
            n = axis_size(self.mesh, self.mesh_axis)
            c = min(self.batch_tiles, -(-m // n) * n)
        n_chunks = -(-m // c)
        pad_m = n_chunks * c - m
        with span("tiles.cut"):
            if pad_m:
                reps = -(-pad_m // m)
                flat = torch.cat([flat, flat.repeat(reps, 1, 1, 1)[:pad_m]], dim=0)
            return flat.split(c)

    def _sharded(self, fn, chunk: torch.Tensor) -> torch.Tensor:
        """fn(chunk); on a mesh, fn of this rank's block of the chunk, the
        blocks gathered in order."""
        if self.mesh is None:
            return fn(chunk)
        b = chunk.shape[0] // axis_size(self.mesh, self.mesh_axis)
        i = self.mesh.get_local_rank(self.mesh_axis)
        return all_gather_cat(fn(chunk[i * b:(i + 1) * b]), self.mesh, self.mesh_axis)

    def _ids(self, tile_batch: torch.Tensor) -> torch.Tensor:
        logits = self._forward(tile_batch)
        with span("tiles.argmax"):
            return torch.argmax(logits, dim=-1).int()

    @torch.inference_mode()
    def predict_logits(self, image) -> torch.Tensor:
        """[H, W] -> [H, W, C] f32 logits."""
        p = self.plan
        flat = self._flat_tiles(self._on_device(image, torch.float32)[None])
        out = torch.cat([self._sharded(self._forward, c) for c in self._chunks(flat)])
        canvas = torch.zeros((p.canvas_h, p.canvas_w, out.shape[-1]),
                             dtype=out.dtype, device=out.device)
        to_h, to_w = p.tile_out_hw
        for i, (y, x) in enumerate(p.out_origins):
            canvas[y:y + to_h, x:x + to_w] = out[i]
        return canvas[:p.image_h, :p.image_w]

    def predict(self, image) -> torch.Tensor:
        """[H, W] -> [H, W] int32 class map (argmax)."""
        return torch.argmax(self.predict_logits(image), dim=-1).int()

    def _forward_flat_ids(self, flat: torch.Tensor) -> torch.Tensor:
        """[M, ti_h, ti_w, 1] -> [M, to_h, to_w] int32 argmax class ids."""
        ids = [self._sharded(self._ids, c) for c in self._chunks(flat)]
        with span("tiles.stitch"):
            return torch.cat(ids)[:flat.shape[0]]

    def _stitch_ids(self, tile_ids: torch.Tensor) -> torch.Tensor:
        """[T, to_h, to_w] int32 -> [H, W] int32 stitched class map (inside
        `predict_batch`'s 'tiles.stitch' span)."""
        p = self.plan
        canvas = torch.zeros((p.canvas_h, p.canvas_w), dtype=torch.int32,
                             device=tile_ids.device)
        to_h, to_w = p.tile_out_hw
        for i, (y, x) in enumerate(p.out_origins):
            canvas[y:y + to_h, x:x + to_w] = tile_ids[i]
        return canvas[:p.image_h, :p.image_w]

    @torch.inference_mode()
    def predict_batch(self, images) -> torch.Tensor:
        """[N, H, W] -> [N, H, W] int32 class maps, tiles flat-batched
        across images."""
        p = self.plan
        images = self._on_device(images, torch.float32)
        ids = self._forward_flat_ids(self._flat_tiles(images))
        with span("tiles.stitch"):
            per = ids.reshape(images.shape[0], p.num_tiles, *p.tile_out_hw)
            return torch.stack([self._stitch_ids(t) for t in per])

    @torch.inference_mode()
    def evaluate_batch(self, images, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W] images + [N, H, W] class-id labels -> ([N, 2] per-image
        (iou of the nonzero masks, pixel_error: the share of pixels whose
        class differs), [N, H, W] int32 preds), both on the device."""
        with span("tiles.evaluate"):
            preds = self.predict_batch(images)
            labels = self._on_device(labels)
            with span("tiles.metrics"):
                metrics = batch_evaluation_metrics(preds, labels)
            return metrics, preds


def make_tile_batch_forward(model, tile_in: int, batch: int):
    """The raw throughput path: a forward over input tiles
    [batch, tile_in, tile_in, 1] -> argmax [batch, tout, tout]."""

    @torch.inference_mode()
    def fwd(tiles: torch.Tensor) -> torch.Tensor:
        if tuple(tiles.shape[:3]) != (batch, tile_in, tile_in):
            raise ValueError(f"expected tiles [{batch}, {tile_in}, {tile_in}, 1], "
                             f"got {tuple(tiles.shape)}")
        return torch.argmax(model(tiles), dim=-1)

    return fwd
