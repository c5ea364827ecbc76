"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device, the kernel build (from tpu_unet_torch/csrc, on first use)
     and the card's name and power limit;
  2. the fused 3x3 conv + bias + ReLU kernel against its plain PyTorch
     version at every conv shape of a 572x572 U-Net tile (bf16), at ragged
     shapes, and in f32 with TF32 off;
  3. the full-width bf16 U-Net (conv_impl='pallas', random weights from
     seed 0) served through evaluate() on a synthetic set: the kernel's
     launch count, finite metrics, and its logits against the same weights
     under conv_impl='xla' (cuDNN);
  4. times, with CUDA events after a warm-up: evaluate_batch under 'pallas'
     and 'xla', and each conv shape under the kernel, the plain version and
     cuDNN in bf16.
The line before the last is a JSON summary of the kernel; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line. There is no CPU path.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TILE_IN, TILE_OUT = 572, 388
BATCH_TILES = 16
# bf16: kernel and plain version read the same bf16 inputs and both sum in
# f32, so they differ by summation order and the final bf16 rounding (one
# bf16 ulp is 2^-8 of a value): held at 2e-2 of the output's scale, the bar
# tests/test_conv_pallas.py sets for the Pallas kernel in bf16.
BF16_TOL = 2e-2
# f32 (TF32 off on both sides): summation order only.
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# Whole-model logits, 'pallas' vs 'xla' (cuDNN), both bf16 through 23
# layers: the two round to bf16 at different places (the split-concat
# decoder convs round each half), so the bar is relative to the logits'
# scale. The class maps must then agree wherever the 'xla' top-2 margin
# exceeds twice the largest logit difference, which no rounding can flip.
MODEL_TOL = 5e-2


def log(*args) -> None:
    print(*args, flush=True)


def phase1_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    import tpu_unet_torch
    from tpu_unet_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(tpu_unet_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"tpu_unet_torch imported from {pkg}, not this checkout")
    log(f"phase 1: device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    prebuilt = os.path.exists(_build.library_path())
    t0 = time.perf_counter()
    _build.load_library()
    log(f"phase 1: kernel library {_build.library_path()} "
        f"{'loaded (already built)' if prebuilt else 'built'} in "
        f"{time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)


def conv_shapes(cfg, size: int):
    """(layer name, input H=W, Cin, Cout) of every 3x3 conv of the U-Net on
    a size x size tile, in forward order."""
    w, s, cin, out = cfg.widths, size, cfg.in_channels, []
    for d in range(cfg.depth):
        out += [(f"enc{d}_conv1", s, cin, w[d]), (f"enc{d}_conv2", s - 2, w[d], w[d])]
        s, cin = (s - 4) // 2, w[d]
    out += [("bottleneck_conv1", s, cin, w[-1]),
            ("bottleneck_conv2", s - 2, w[-1], w[-1])]
    s -= 4
    for d in reversed(range(cfg.depth)):
        s *= 2
        out += [(f"dec{d}_conv1", s, 2 * w[d], w[d]),
                (f"dec{d}_conv2", s - 2, w[d], w[d])]
        s -= 4
    return out, s


def _conv_inputs(shape, cout, dtype, gen):
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=DEVICE)
         / math.sqrt(9 * cin)).to(dtype)
    b = (torch.randn((cout,), generator=gen, device=DEVICE) * 0.1).to(dtype)
    return x, w, b


def _compare(shape, cout, dtype, gen) -> float:
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    x, w, b = _conv_inputs(shape, cout, dtype, gen)
    got = conv3x3_bias_relu(x, w, b)
    ref = conv3x3_bias_relu_plain(x, w, b)
    torch.cuda.synchronize()
    if got.dtype != dtype or got.shape != ref.shape:
        raise AssertionError(f"{shape}->{cout}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {dtype} {tuple(ref.shape)}")
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    if dtype == torch.bfloat16:
        bound = BF16_TOL * max(ref.abs().max().item(), 1.0)
        if not err <= bound:
            raise AssertionError(f"bf16 {shape}->{cout}: max |err| {err} > {bound}")
    else:
        torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_ATOL)
    return err


@torch.inference_mode()
def phase2_kernel_vs_plain(cfg) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    shapes, out = conv_shapes(cfg, TILE_IN)
    if out != TILE_OUT or len(shapes) != 18:
        raise AssertionError(f"conv shape list: {len(shapes)} convs to {out}")
    max_err = 0.0
    for name, s, cin, cout in shapes:
        rows = min(s, 34)                     # H cut; W and channels full
        err = _compare((2, rows, s, cin), cout, torch.bfloat16, gen)
        max_err = max(max_err, err)
        log(f"phase 2: {name:17s} x[2,{rows},{s},{cin}] -> {cout}: bf16 max|err| {err:.3g}")
    # the full enc0_conv2 activation of one 16-tile chunk (~333 M elements)
    name, s, cin, cout = shapes[1]
    err = _compare((BATCH_TILES, s, s, cin), cout, torch.bfloat16, gen)
    max_err = max(max_err, err)
    log(f"phase 2: {name} x[{BATCH_TILES},{s},{s},{cin}] -> {cout}: bf16 max|err| {err:.3g}")
    for shape, cout in [((2, 37, 45, 64), 64), ((3, 13, 29, 128), 200),
                        ((2, 11, 19, 3), 20), ((1, 5, 130, 8), 72)]:
        err = _compare(shape, cout, torch.bfloat16, gen)
        max_err = max(max_err, err)
        log(f"phase 2: ragged x{list(shape)} -> {cout}: bf16 max|err| {err:.3g}")
    for shape, cout in [((1, 18, 20, 8), 16), ((2, 13, 16, 4), 8),
                        ((1, 10, 34, 16), 32), ((2, 12, 15, 1), 8),
                        ((1, 9, 23, 3), 5), ((2, 20, 70, 64), 128)]:
        err = _compare(shape, cout, torch.float32, gen)
        log(f"phase 2: f32 x{list(shape)} -> {cout}: max|err| {err:.3g}")
    log(f"phase 2: ok, bf16 tolerance {BF16_TOL} of the output scale, "
        f"f32 rtol {F32_RTOL} atol {F32_ATOL} (TF32 off)")
    return max_err


def phase3_serve(cfg):
    from tpu_unet_torch.data import synthetic_dataset
    from tpu_unet_torch.infer import TileInference, evaluate
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu

    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    data = synthetic_dataset(n_images=4, h=512, w=512, crop=TILE_OUT, seed=0)
    engine = TileInference(model, 512, 512, tile_out=TILE_OUT)
    n_tiles = len(data) * engine.plan.num_tiles
    n_chunks = -(-n_tiles // engine.batch_tiles)
    if engine.plan.tile_in != TILE_IN:
        raise AssertionError(f"tile_in {engine.plan.tile_in}")

    conv3x3_bias_relu.launches = 0
    result = evaluate(model, data, tile_out=TILE_OUT, verbose=False)
    torch.cuda.synchronize()
    launches = conv3x3_bias_relu.launches
    log(f"phase 3: evaluate() on {len(data)} images, {n_tiles} tiles of "
        f"{TILE_IN}^2 in {n_chunks} chunk(s) of {engine.batch_tiles}: "
        f"{launches} kernel launches; {json.dumps(result)}")
    if launches != 18 * n_chunks:
        raise AssertionError(f"{launches} launches, want 18 x {n_chunks}")

    labels = (data.targets > 127).astype(np.uint8)
    ms, preds = engine.evaluate_batch(data.images, labels)
    ms, preds = ms.cpu().numpy(), preds.cpu().numpy()
    log(f"phase 3: per-image (iou, pixel error) {ms.tolist()}")
    for k in range(len(data)):
        both_empty = not preds[k].any() and not labels[k].any()
        if not np.isfinite(ms[k, 1]) or (np.isnan(ms[k, 0]) and not both_empty):
            raise AssertionError(f"image {k}: metrics {ms[k]}")
    if not (np.isfinite(result["pe_mean"]) and np.isfinite(result["iou_mean"])):
        raise AssertionError(f"evaluate() result {result}")

    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(DEVICE)
    xla.load_state_dict(model.state_dict())
    xengine = TileInference(xla, 512, 512, tile_out=TILE_OUT)
    lp = engine.predict_logits(data.images[0])
    lx = xengine.predict_logits(data.images[0])
    torch.cuda.synchronize()
    if lp.shape != (512, 512, 2) or not torch.isfinite(lp).all():
        raise AssertionError(f"pallas logits {tuple(lp.shape)} not finite or misshapen")
    scale = lx.abs().max().item()
    err = (lp - lx).abs().max().item()
    same = lp.argmax(-1) == lx.argmax(-1)
    top2 = lx.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    log(f"phase 3: logits 'pallas' vs 'xla' on image 0: max|err| {err:.4g} "
        f"(scale {scale:.4g}, bound {MODEL_TOL} x scale); argmax agrees on "
        f"{same.float().mean().item():.5f} of pixels, and on "
        f"{same[decided].float().mean().item():.5f} of the "
        f"{decided.float().mean().item():.5f} whose margin exceeds 2 x max|err|")
    if not (err <= MODEL_TOL * scale and bool(same[decided].all())):
        raise AssertionError("'pallas' and 'xla' logits disagree")
    log("phase 3: ok")
    return model, xla, data, labels, launches


def _time_ms(fn, reps: int) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase4_time(cfg, model, xla, data, labels):
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy(labels).to(DEVICE)
    engines = {"pallas": TileInference(model, 512, 512, tile_out=TILE_OUT),
               "xla": TileInference(xla, 512, 512, tile_out=TILE_OUT)}
    n_tiles = len(data) * engines["pallas"].plan.num_tiles
    times = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times[impl].append(_time_ms(lambda: engines[impl].evaluate_batch(images, lab), 3))
    tiles_s = {}
    for impl, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[impl] = n_tiles / (ms / 1e3)
        log(f"phase 4: evaluate_batch conv_impl={impl!r}: {ms:.2f} ms for {n_tiles} "
            f"tiles of {TILE_IN}^2 = {tiles_s[impl]:.1f} tiles/s (runs {ts})")

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    shapes, _ = conv_shapes(cfg, TILE_IN)
    total = {"kernel": 0.0, "plain": 0.0, "cudnn": 0.0}
    with torch.inference_mode():
        for name, s, cin, cout in shapes:
            x, w, b = _conv_inputs((BATCH_TILES, s, s, cin), cout, torch.bfloat16, gen)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)                 # channels-last view
            t = {
                "kernel": _time_ms(lambda: conv3x3_bias_relu(x, w, b), 5),
                "plain": _time_ms(lambda: conv3x3_bias_relu_plain(x, w, b), 3),
                "cudnn": _time_ms(lambda: F.relu(F.conv2d(x_nchw, w_oihw, b)), 5),
            }
            flop = 2 * BATCH_TILES * (s - 2) ** 2 * 9 * cin * cout
            for k in total:
                total[k] += t[k]
            log(f"phase 4: {name:17s} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: kernel "
                f"{t['kernel']:.3f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
                f"f32 {t['plain']:.3f} ms, cuDNN bf16 {t['cudnn']:.3f} ms")
            del x, w, b, w_oihw, x_nchw
    log(f"phase 4: 18 convs of one {BATCH_TILES}-tile chunk: kernel {total['kernel']:.2f} ms, "
        f"plain f32 {total['plain']:.2f} ms, cuDNN bf16 {total['cudnn']:.2f} ms")
    return total, tiles_s


def main() -> None:
    phase1_device()
    from tpu_unet_torch.models import ModelConfig

    # the plain version's f32 convs must not run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(base_width=64, compute_dtype="bfloat16", conv_impl="pallas")
    max_err = phase2_kernel_vs_plain(cfg)
    model, xla, data, labels, launches = phase3_serve(cfg)
    total, tiles_s = phase4_time(cfg, model, xla, data, labels)
    log(json.dumps({"kernels": [{
        "name": "conv3x3_bias_relu",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv3x3_bias_relu.cu",
        "replaces": "tpu_unet/ops/conv_pallas.py:57",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total["kernel"],
        "plain_ms": total["plain"],
        "cudnn_bf16_ms": total["cudnn"],
        "evaluate_tiles_per_s": tiles_s,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
