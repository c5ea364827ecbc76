"""Evaluation entry point: per-shape-group tile inference, prediction export and
metric aggregation (counterpart of ``tpu_unet/infer/tester.py``).

The model holds its weights on its device, so `evaluate` takes no params.
Engines are built per call: in eager PyTorch a `TileInference` holds only
its tile plan, so there is nothing compiled to keep between calls. Nor is
a calibrated int8 engine cached by the model's identity: `quant_path` keeps
the calibration on disk instead.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np

from tpu_unet_torch.data.ingest import SegmentationData, square_crop
from tpu_unet_torch.data.tiff import write_tiff
from tpu_unet_torch.infer.tiles import TileInference


def _save_tiff(path: str, array: np.ndarray) -> None:
    """Write `array` as a uint8 TIFF, min-max scaled to 0..255 unless it is
    uint8 already."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / (hi - lo) * 255.0 if hi > lo else arr * 0.0).astype(np.uint8)
    write_tiff(path, arr)


def export_predictions(output_dir: str, idx: int, image: np.ndarray,
                       label: np.ndarray, pred: np.ndarray) -> None:
    """Write {output_dir}/images/image{idx}.tif, labels/label{idx}.tif and
    preds/pred{idx}.tif."""
    for sub in ("images", "preds", "labels"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
    _save_tiff(os.path.join(output_dir, "images", f"image{idx}.tif"), image)
    _save_tiff(os.path.join(output_dir, "labels", f"label{idx}.tif"), label)
    _save_tiff(os.path.join(output_dir, "preds", f"pred{idx}.tif"), pred)


def _get_quant_inference(model, prepared, quant_path: Optional[str],
                         phase_level0: Optional[str] = None):
    """The int8 engine for `model` (level 0 phase-packed under
    `phase_level0`). An existing `quant_path` (.npz, either package's) is
    served from disk with no calibration; otherwise the model is calibrated
    on the eval images, and the result saved to `quant_path` when one is
    given.

    K3 serves when ``model.cfg.conv_impl == 'pallas'``, the int8 library
    route otherwise. (The JAX package always builds ``impl='xla'``, which
    it measured faster on its TPU; the two routes give equal results.)"""
    from tpu_unet_torch.infer.quant import (QuantInference, build_quant_inference,
                                            calibration_batch, load_quant_params,
                                            save_quant_params)

    impl = "pallas" if model.cfg.conv_impl == "pallas" else "xla"
    device = next(model.parameters()).device
    if quant_path is not None and (os.path.exists(quant_path)
                                   or os.path.exists(quant_path + ".npz")):
        return QuantInference(load_quant_params(quant_path), impl=impl,
                              phase_level0=phase_level0, device=device)
    qi = build_quant_inference(model, calibration_batch([p[0] for p in prepared]),
                               impl=impl, phase_level0=phase_level0)
    if quant_path is not None:
        save_quant_params(quant_path, qi.qp)
    return qi


def evaluate(
    model,
    data: SegmentationData,
    output_dir: Optional[str] = None,
    tile_out: Optional[int] = None,
    verbose: bool = True,
    quant: Optional[str] = None,
    quant_path: Optional[str] = None,
) -> Dict[str, float]:
    """Evaluate on gold-truth frames; returns mean/std IoU and pixel error
    and, with `output_dir`, writes the prediction TIFFs and ``test_iou.out``
    / ``test_pe.out``. Same-shaped frames (after the square crop) run as one
    flat tile batch.

    `quant='int8'` serves through the post-training-quantized forward
    (infer/quant.py); `quant='int8-phase'` also runs level 0 phase-packed,
    its packed convs in int8 (``phase_level0='int8'``); `quant_path` serves
    from, or writes, the calibrated parameters (.npz, the same file for
    both)."""
    if quant in ("int4", "int4-phase"):
        raise NotImplementedError(f"quant={quant!r} is not ported yet (ROADMAP "
                                  f"queue 1, item 10)")
    if quant not in (None, "int8", "int8-phase"):
        raise ValueError(f"quant must be None, 'int8', 'int8-phase', 'int4' or "
                         f"'int4-phase', got {quant!r}")
    start = time.time()
    prepared = [square_crop(data.images[i], data.targets[i])
                for i in range(len(data))]
    apply_fn = None
    if quant is not None:
        phase = "int8" if quant == "int8-phase" else None
        apply_fn = _get_quant_inference(model, prepared, quant_path, phase).apply
    groups: Dict[tuple, list] = {}
    for idx, (img, _tgt) in enumerate(prepared):
        groups.setdefault(img.shape, []).append(idx)

    per_image = [None] * len(data)
    for shape, indices in groups.items():
        engine = TileInference(model, shape[0], shape[1], tile_out=tile_out,
                               apply_fn=apply_fn)
        imgs = np.stack([prepared[i][0] for i in indices]).astype(np.float32)
        labels = (np.stack([prepared[i][1] for i in indices]) > 127).astype(np.uint8)
        ms_dev, preds_dev = engine.evaluate_batch(imgs, labels)
        ms = ms_dev.cpu().numpy()
        preds = preds_dev.cpu().numpy() if output_dir is not None else None
        for k, idx in enumerate(indices):
            per_image[idx] = ms[k]
            if output_dir is not None:
                export_predictions(output_dir, idx, prepared[idx][0],
                                   labels[k] * 255, preds[k] * 255)
    metrics = np.stack(per_image)                      # [N, 2]
    result = {
        "iou_mean": float(np.nanmean(metrics[:, 0])),
        "iou_std": float(np.nanstd(metrics[:, 0])),
        "pe_mean": float(np.mean(metrics[:, 1])),
        "pe_std": float(np.std(metrics[:, 1])),
        "seconds": time.time() - start,
        "num_images": len(data),
    }
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        np.savetxt(os.path.join(output_dir, "test_iou.out"),
                   [result["iou_mean"], result["iou_std"]])
        np.savetxt(os.path.join(output_dir, "test_pe.out"),
                   [result["pe_mean"], result["pe_std"]])
    if verbose:
        print(f"Mean IoU testing: {result['iou_mean']:.6f}")
        print(f"Mean PE testing : {result['pe_mean']:.6f}")
        print(f"Testing took    : {result['seconds']:.2f}s")
    return result
