"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device, the kernel build (every source of tpu_unet_torch/csrc, on
     first use) and the card's name and power limit;
  2. K1, the fused 3x3 conv + bias + ReLU kernel, against its plain PyTorch
     version at every conv shape of a 572x572 U-Net tile (bf16), at ragged
     shapes, and in f32 with TF32 off;
  3. serving: the full-width bf16 U-Net (conv_impl='pallas', random weights
     from seed 0) through evaluate() on a synthetic set: K1's launch count,
     finite metrics, and its logits against the same weights under
     conv_impl='xla' (cuDNN);
  4. serving times, with CUDA events after a warm-up: evaluate_batch under
     'pallas' and 'xla', and each conv shape under the kernel, the plain
     version and cuDNN in bf16;
  5. K2, the EDT column pass kernel, against its plain version, bit for bit
     (tolerance 0, +inf positions equal): the DIC-HeLa weight-map shape
     [2, 32, 388, 388] with num_valid [5, 0], ragged shapes and an
     all-+inf plane, banded (40) and exact;
  6. K1's gradient (its autograd.Function: kernel forward, library-conv
     backward) against autograd through the plain version, at the 18 conv
     shapes (bf16) and at small shapes in f32 with TF32 off;
  7. training: Trainer.fit on DIC-HeLa at full width (bf16, batch 2,
     distance weight maps) for one epoch of 5 steps, with K1 and K2 launch
     counts, the progress files, the 'latest' checkpoint and a resume from
     it; then one f32 step (TF32 off) under 'pallas' and 'xla' from the
     same weights and batch, whose losses and momentum buffers agree;
  8. training times, with CUDA events: a train step under 'pallas' and
     'xla' (bf16) split into augmentation, weight maps, forward+backward and
     optimizer, and K2 against its plain version;
  9. K3, the fused int8 conv of quantized serving, against its plain
     version, bit for bit (tolerance 0), and against the int8 library route
     (im2col + torch._int_mm): the 14 int8 conv shapes of a 572x572 tile
     (batch 2), ragged and misaligned shapes, both out kinds; bf16 inputs at
     BF16_TOL;
 10. int8 serving: the full-width bf16 U-Net (conv_impl='pallas', seed 0)
     through evaluate(quant='int8', quant_path=...): calibration, the .npz,
     14 K3 launches per chunk, finite metrics, a second evaluate served from
     the .npz with equal metrics, and every stage of QuantInference under
     'pallas' (K3) equal to 'xla' (the library route);
 11. int8 serving times: evaluate_batch under int8 'pallas' and 'xla' and
     float 'pallas' and 'xla', and each int8 conv shape of one 16-tile chunk
     under K3, the library route and the plain version.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line. There is no CPU path.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TILE_IN, TILE_OUT = 572, 388
BATCH_TILES = 16
# the serving set: 4 synthetic IMAGE x IMAGE frames, 4 tiles each
IMAGE = 512
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
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): a call's
# bound is the larger of its bytes (each input read once, each output
# written once) over the memory rate and its operations over the peak rate
# of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_cost(batch: int, s: int, cin: int, cout: int, in_bytes: int, out_bytes: int,
              vec_bytes: int):
    """(bytes, operations) of one 3x3 valid conv + per-channel epilogue of
    x [batch, s, s, cin] -> [batch, s-2, s-2, cout]; `vec_bytes` per output
    channel for its epilogue vectors (bias, or alpha and beta)."""
    nbytes = (batch * s * s * cin * in_bytes + 9 * cin * cout * in_bytes
              + vec_bytes * cout + batch * (s - 2) ** 2 * cout * out_bytes)
    return nbytes, 2 * batch * (s - 2) ** 2 * 9 * cin * cout


def chunk_bound(shapes, kind: str, in_bytes: int, out_bytes: int, vec_bytes: int):
    """`bound` of the convs `shapes` over one chunk of BATCH_TILES tiles,
    their bytes and operations summed."""
    costs = [conv_cost(BATCH_TILES, s, cin, cout, in_bytes, out_bytes, vec_bytes)
             for _, s, cin, cout in shapes]
    return bound(sum(c[0] for c in costs), sum(c[1] for c in costs), kind)


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
    data = synthetic_dataset(n_images=4, h=IMAGE, w=IMAGE, crop=TILE_OUT, seed=0)
    engine = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT)
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
    xengine = TileInference(xla, IMAGE, IMAGE, tile_out=TILE_OUT)
    lp = engine.predict_logits(data.images[0])
    lx = xengine.predict_logits(data.images[0])
    torch.cuda.synchronize()
    if lp.shape != (IMAGE, IMAGE, 2) or not torch.isfinite(lp).all():
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
    engines = {"pallas": TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT),
               "xla": TileInference(xla, IMAGE, IMAGE, tile_out=TILE_OUT)}
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
            for k in total:
                total[k] += t[k]
            nbytes, flop = conv_cost(BATCH_TILES, s, cin, cout, 2, 2, 2)
            b_ms, by = bound(nbytes, flop, "bf16")
            log(f"phase 4: {name:17s} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: kernel "
                f"{t['kernel']:.3f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), plain "
                f"f32 {t['plain']:.3f} ms, cuDNN bf16 {t['cudnn']:.3f} ms, bound "
                f"{b_ms:.3f} ms ({by})")
            del x, w, b, w_oihw, x_nchw
    total["bound"], total["bound_by"] = chunk_bound(shapes, "bf16", 2, 2, 2)
    log(f"phase 4: 18 convs of one {BATCH_TILES}-tile chunk: kernel {total['kernel']:.2f} ms, "
        f"plain f32 {total['plain']:.2f} ms, cuDNN bf16 {total['cudnn']:.2f} ms, bound "
        f"{total['bound']:.3f} ms ({total['bound_by']})")
    return total, tiles_s


# K2: every value is an integer below 2^24 or +inf, so kernel and plain
# version must agree bit for bit.
EDT_BAND = 40
EDT_SHAPES = [  # (g2 shape, num_valid)
    ((2, 32, 388, 388), [5, 0]),   # the DIC-HeLa weight-map batch
    ((3, 70, 45), None),           # H, W not multiples of the 64x32 tile
    ((2, 30, 100), None),          # H < band
    ((1, 4, 1, 37), [2]),          # one-row planes
    ((1, 5, 300, 97), [5]),
]
# Phase 7's one-step comparison, f32 with TF32 off, 'pallas' vs 'xla': the
# kernel and cuDNN sum the forward in other orders (~1e-6 relative), so a
# few of the ~10^8 ReLU masks flip where a pre-activation is ~0, and each
# flip moves a whole gradient column by one pixel's term. So the momentum
# buffers (the gradients) are held in norm, ||pallas - xla|| <= 1e-2 ||xla||
# per tensor (a wrong gradient is off by O(1)), and the losses at rtol 1e-4.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = 1e-2


def _g2(shape, gen):
    """Squared row distances of sparse random masks: integers and +inf."""
    from tpu_unet_torch.ops.edt import _row_distance, _squared

    masks = torch.rand(shape, generator=gen, device=DEVICE) < 0.02
    return _squared(_row_distance(masks)).contiguous()


def edt_bound(shape, num_valid, band):
    """K2's bound on g2 `shape` [B, K, H, W]: the live planes' input read
    once and every output written once; an add and a min per candidate row
    (|i - r| <= band) of each live output, at the f32 rate."""
    b, k, h, w = shape
    live = b * k if num_valid is None else sum(min(n, k) for n in num_valid)
    rows = (h * h if band is None else
            sum(min(i + band, h - 1) - max(i - band, 0) + 1 for i in range(h)))
    return bound(4 * (live + b * k) * h * w, 2 * live * w * rows, "f32")


def phase5_edt() -> float:
    from tpu_unet_torch.ops.edt_pallas import column_pass, column_pass_plain

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for shape, nv in EDT_SHAPES:
        g2 = _g2(shape, gen)
        g2.view(-1, *shape[-2:])[0] = float("inf")          # an all-+inf plane
        num = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=DEVICE)
        for band in (EDT_BAND, None):
            got = column_pass(g2, num_valid=num, band=band)
            ref = column_pass_plain(g2, num_valid=num, band=band)
            torch.cuda.synchronize()
            same_inf = torch.equal(torch.isinf(got), torch.isinf(ref))
            fin = torch.isfinite(ref)
            err = (got[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
            log(f"phase 5: K2 g2{list(shape)} num_valid {nv} band {band}: max|err| "
                f"{err}, +inf positions equal: {same_inf}, finite share "
                f"{fin.float().mean().item():.4f}")
            if not (same_inf and err == 0.0 and torch.equal(got, ref)):
                raise AssertionError(f"K2 differs from its plain version at {shape}, band {band}")
    log("phase 5: ok, K2 bit-exact at every shape")
    return 0.0


def _int_inputs(shape, cout, dtype, gen):
    """Small integers, and biases of one half: every pre-activation is at
    least 0.5 from 0 and every sum is exact in f32. With normal inputs about
    1e-5 of the pre-activations lie within rounding distance of 0, where the
    two forwards' ReLU masks may disagree, and one such pixel moves a dw
    entry by |g x|: 2% of dw's scale at the bottleneck's 1800 pixels."""
    cin = shape[-1]

    def ints(size, lo, hi):
        return torch.randint(lo, hi, size, generator=gen, device=DEVICE).to(dtype)

    b = torch.full((cout,), 0.5, device=DEVICE).to(dtype)
    g = ints((shape[0], shape[1] - 2, shape[2] - 2, cout), -3, 4)
    return ints(shape, -3, 4), ints((3, 3, cin, cout), -2, 3), b, g


def _grad_compare(shape, cout, dtype, gen) -> float:
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    if dtype == torch.bfloat16:
        x, w, b, g = _int_inputs(shape, cout, dtype, gen)
    else:
        x, w, b = _conv_inputs(shape, cout, dtype, gen)
        g = torch.randn((shape[0], shape[1] - 2, shape[2] - 2, cout), generator=gen,
                        device=DEVICE)
    grads = []
    for fn in (conv3x3_bias_relu, conv3x3_bias_relu_plain):
        xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
        fn(xs, ws, bs).backward(g)
        grads.append([t.grad.float() for t in (xs, ws, bs)])
    torch.cuda.synchronize()
    worst = 0.0
    for name, got, ref in zip(("dx", "dw", "db"), *grads):
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if dtype == torch.bfloat16:
            if not err <= BF16_TOL * scale:
                raise AssertionError(f"bf16 {shape}->{cout} {name}: max|err| {err} > "
                                     f"{BF16_TOL} x {scale}")
        else:
            torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_RTOL * scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def phase6_conv_grad(cfg) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    shapes, _ = conv_shapes(cfg, TILE_IN)
    worst = 0.0
    for name, s, cin, cout in shapes:
        rows = min(s, 34)
        rel = _grad_compare((2, rows, s, cin), cout, torch.bfloat16, gen)
        worst = max(worst, rel)
        log(f"phase 6: {name:17s} x[2,{rows},{s},{cin}] -> {cout}: bf16 dx/dw/db "
            f"max|err| {rel:.3g} of scale")
    for shape, cout in [((2, 13, 16, 4), 8), ((1, 18, 20, 8), 16), ((2, 20, 70, 64), 128)]:
        rel = _grad_compare(shape, cout, torch.float32, gen)
        log(f"phase 6: f32 x{list(shape)} -> {cout}: dx/dw/db max|err| {rel:.3g} of scale")
    log(f"phase 6: ok, bf16 within {BF16_TOL} of each gradient's scale, f32 rtol "
        f"{F32_RTOL} (TF32 off)")
    return worst


def _train_data():
    from tpu_unet_torch.data import synthetic_dataset

    # the JAX CLI's --synthetic fixture for the DIC-HeLa preset
    return synthetic_dataset(n_images=10, h=448, w=448, n_cells=5, crop=TILE_OUT, seed=0)


def phase7_train(cfg):
    from tpu_unet_torch.config import DATASETS, TrainConfig
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
    from tpu_unet_torch.ops.edt_pallas import column_pass
    from tpu_unet_torch.train import Trainer
    from tpu_unet_torch.train.progress import FILES

    data = _train_data()
    out = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(out, ignore_errors=True)
    ds = DATASETS["DIC-C2DH-HeLa"]
    tcfg = TrainConfig(batch_size=2, checkpoint_every=1)
    trainer = Trainer(ds, cfg, tcfg, out_dir=out)
    n_val = -(-len(data) // tcfg.batch_size)
    n_steps = len(data) // tcfg.batch_size
    conv3x3_bias_relu.launches = column_pass.launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(data, data, epochs=0)
    torch.cuda.synchronize()
    launches = {"conv3x3_bias_relu": conv3x3_bias_relu.launches,
                "edt_column_pass": column_pass.launches}
    log(f"phase 7: Trainer.fit(epochs=0) on {len(data)} images of 448^2: {n_steps} "
        f"train steps, {n_val} val batches in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}; history {json.dumps(history)}")
    if launches["conv3x3_bias_relu"] != 18 * (n_steps + n_val):
        raise AssertionError(f"K1 launches {launches}, want 18 x ({n_steps} + {n_val})")
    if launches["edt_column_pass"] < n_steps:
        raise AssertionError(f"K2 launches {launches}, want >= {n_steps}")
    if not all(np.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"non-finite history {history}")
    missing = [f for f in list(FILES.values()) + ["metrics.jsonl"]
               if not os.path.exists(os.path.join(out, "progress", f))]
    if missing or not os.path.isdir(os.path.join(out, "models", "latest")):
        raise AssertionError(f"missing progress files {missing} or models/latest")
    resumed = Trainer(ds, cfg, tcfg, out_dir=out).fit(data, data, epochs=1, resume=True)
    if len(resumed["loss"]) != 2 or resumed["loss"][0] != history["loss"][0]:
        raise AssertionError(f"resume did not continue at epoch 1: {resumed}")
    log(f"phase 7: resumed from 'latest' and trained epoch 1: loss "
        f"{resumed['loss']}")
    shutil.rmtree(out, ignore_errors=True)
    del trainer
    return launches


def _batch(pipe, data, seed):
    arrays = [torch.from_numpy(a).to(DEVICE) for a in (
        data.images, data.targets, data.crop_log_probs, data.crop_pairs)]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return pipe(*arrays, np.array([0, 1]), gen)


def phase7_step_agreement(cfg):
    """One f32 step from the same weights and batch: 'pallas' vs 'xla'."""
    from tpu_unet_torch.config import DATASETS, OptimConfig
    from tpu_unet_torch.data.augment import AugmentPipeline
    from tpu_unet_torch.losses.weights import make_weight_fn
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.train import make_optimizer
    from tpu_unet_torch.train.trainer import make_train_step

    ds = DATASETS["DIC-C2DH-HeLa"]
    inp, gt = _batch(AugmentPipeline(ds.augment()), _train_data(), 7)
    weight_fn = make_weight_fn("distance")
    results = {}
    for impl in ("pallas", "xla"):
        # one seed: the same weights under either conv_impl
        c = dataclasses.replace(cfg, compute_dtype="float32", conv_impl=impl)
        model = UNet(c, generator=torch.Generator().manual_seed(0)).to(DEVICE)
        opt = make_optimizer(model.parameters(), OptimConfig())
        loss, _ = make_train_step(model, weight_fn, "intended", opt)(inp, gt)
        results[impl] = (loss.item(), {n: opt.state[p]["momentum_buffer"]
                                       for n, p in model.named_parameters()})
    (lp, bp), (lx, bx) = results["pallas"], results["xla"]
    worst = max(((bp[n] - bx[n]).norm() / bx[n].norm().clamp_min(1e-30)).item()
                for n in bx)
    worst_max = max((bp[n] - bx[n]).abs().max().item() / max(bx[n].abs().max().item(), 1e-30)
                    for n in bx)
    log(f"phase 7: one f32 step, 'pallas' loss {lp!r} vs 'xla' {lx!r}; momentum "
        f"buffers: relative L2 error {worst:.3g} in the worst tensor, max|err| "
        f"{worst_max:.3g} of its scale")
    if not (abs(lp - lx) <= STEP_LOSS_RTOL * abs(lx) and worst <= STEP_GRAD_TOL):
        raise AssertionError("'pallas' and 'xla' train steps disagree")
    log("phase 7: ok")
    return worst


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


# Kernel-name fragments -> the rows of the train-step breakdown.
KERNEL_GROUPS = (
    ("K1 conv3x3_bias_relu", ("conv3x3_bias_relu",)),
    ("K2 edt_column_pass", ("edt_column_pass",)),
    ("K3 conv3x3_fused", ("conv3x3_fused",)),
    ("cuDNN/cuBLAS conv and GEMM", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                                    "dgrad", "wgrad", "winograd", "sm90")),
    ("gather, scatter, index", ("index", "gather", "scatter")),
    ("scans and reductions", ("reduce", "scan", "cummax", "cummin", "arg", "sum",
                              "norm", "max", "min")),
)


def _profile(step, n: int):
    """Device time by kernel over `n` calls of `step` under torch.profiler:
    (window ms on the host clock, busy ms, {group: ms}, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(n):
            step(r)
        torch.cuda.synchronize()
    window = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total", 0) / 1e3
        if ms > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ms
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["elementwise and copies"], 0.0)
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)),
                     "elementwise and copies")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return window, sum(kernels.values()), groups, top


def phase8_time(cfg):
    from tpu_unet_torch.config import DATASETS, OptimConfig
    from tpu_unet_torch.data.augment import AugmentPipeline
    from tpu_unet_torch.losses.bce import weighted_bce_with_logits
    from tpu_unet_torch.losses.weights import make_weight_fn
    from tpu_unet_torch.models import UNet, center_crop_or_pad
    from tpu_unet_torch.ops.edt_pallas import column_pass, column_pass_plain
    from tpu_unet_torch.train import make_optimizer

    ds = DATASETS["DIC-C2DH-HeLa"]
    pipe = AugmentPipeline(ds.augment())
    data = _train_data()
    arrays = [torch.from_numpy(a).to(DEVICE) for a in (
        data.images, data.targets, data.crop_log_probs, data.crop_pairs)]
    weight_fn = make_weight_fn("distance")
    models = {}
    for impl in ("pallas", "xla"):
        m = UNet(dataclasses.replace(cfg, conv_impl=impl),
                 generator=torch.Generator().manual_seed(0)).to(DEVICE)
        models[impl] = (m, make_optimizer(m.parameters(), OptimConfig()))
    parts = ("augment", "weights", "fwd_bwd", "optimizer")

    def train_step(impl, r, ev=None):
        """One step of the train loop, as `make_train_step` runs it, with
        CUDA events around its four parts when `ev` is given."""
        model, opt = models[impl]
        mark = (lambda k, i: ev[k][i].record()) if ev else (lambda k, i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(100 + r)
        mark("augment", 0)
        inp, gt = pipe(*arrays, np.array([2 * r, 2 * r + 1]) % len(data), gen)
        mark("augment", 1)
        mark("weights", 0)
        with torch.no_grad():
            w = weight_fn(gt)
        mark("weights", 1)
        mark("fwd_bwd", 0)
        opt.zero_grad(set_to_none=True)
        logits = center_crop_or_pad(model(inp), gt.shape[1:3])
        weighted_bce_with_logits(logits, gt, w).backward()
        mark("fwd_bwd", 1)
        mark("optimizer", 0)
        opt.step()
        mark("optimizer", 1)

    steps = {}
    reps = 6
    for impl in ("pallas", "xla", "xla", "pallas"):
        ev = {k: _events() for k in parts}
        acc = dict.fromkeys(parts, 0.0)
        for r in range(reps + 1):             # the first is a warm-up
            train_step(impl, r, ev)
            torch.cuda.synchronize()
            if r:
                for k in parts:
                    acc[k] += ev[k][0].elapsed_time(ev[k][1]) / reps
        steps.setdefault(impl, []).append(acc)
    step_ms = {}
    for impl, runs in steps.items():
        mean = {k: sum(r[k] for r in runs) / len(runs) for k in parts}
        step_ms[impl] = {**mean, "step": sum(mean.values())}
        log(f"phase 8: train step conv_impl={impl!r} (bf16, batch 2, 572^2): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms[impl].items())
            + f" (runs {[round(sum(r.values()), 3) for r in runs]})")
    for impl in ("pallas", "xla"):
        n = 3
        window, busy, groups, top = _profile(lambda r: train_step(impl, r), n)
        step_ms[impl]["profiled_idle_share"] = 1.0 - busy / window
        log(f"phase 8: profile of {n} steps conv_impl={impl!r}: window {window / n:.3f} "
            f"ms/step, device busy {busy / n:.3f} ms/step, idle share "
            f"{1.0 - busy / window:.4f}; by group (ms/step): "
            + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items()))
        for name, ms in top:
            log(f"phase 8:   {ms / n:9.3f} ms/step  {name[:110]}")
    del models

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    g2 = _g2((2, 32, TILE_OUT, TILE_OUT), gen)
    edt_ms = {}
    for label, nv in (("num_valid [5, 0]", [5, 0]), ("all 64 planes live", None)):
        num = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=DEVICE)
        for band in (EDT_BAND, None):
            t = {"kernel": _time_ms(lambda: column_pass(g2, num, band), 20),
                 "plain": _time_ms(lambda: column_pass_plain(g2, num, band), 3)}
            edt_ms[f"{label}, band {band}"] = t
            log(f"phase 8: K2 g2[2,32,{TILE_OUT},{TILE_OUT}] {label}, band {band}: "
                f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.3f} ms")
    return step_ms, edt_ms


# The stages of the quantized forward that `QuantInference.apply(stop_after=)`
# can return, in order.
QUANT_STAGES = ([f"enc{d}_conv{i}" for d in range(4) for i in (1, 2)]
                + [f"pool{d}" for d in range(4)]
                + ["bottleneck_conv1", "bottleneck_conv2"]
                + [f"up{d}" for d in range(4)]
                + [f"dec{d}_conv{i}" for d in range(4) for i in (1, 2)])


def int8_shapes(cfg):
    """The conv shapes of a 572x572 tile that int8 serving runs through K3."""
    from tpu_unet_torch.infer.quant import default_quant_names

    names = default_quant_names(cfg)
    shapes = [sh for sh in conv_shapes(cfg, TILE_IN)[0] if sh[0] in names]
    if len(shapes) != 14:
        raise AssertionError(f"{len(shapes)} int8 convs, want 14: {sorted(names)}")
    return shapes


def _k3_inputs(shape, cout, dtype, gen, offset=0):
    """int8 x and w with f32 alpha and beta that spread the outputs over
    [0, 127] (or bf16 x and w, alpha 1). `offset` bytes put x off its 16-byte
    alignment, which the kernel takes on its scalar load path."""
    cin = shape[-1]
    if dtype == torch.int8:
        buf = torch.randint(-127, 128, (math.prod(shape) + offset,), generator=gen,
                            device=DEVICE, dtype=torch.int8)
        x = buf[offset:].view(shape)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        alpha = torch.rand((cout,), generator=gen, device=DEVICE) * 2e-3 / math.sqrt(cin)
        beta = torch.randn((cout,), generator=gen, device=DEVICE) * 3
        return x, w, alpha, beta
    x, w, _ = _conv_inputs(shape, cout, dtype, gen)
    return (x, w, torch.ones((cout,), device=DEVICE),
            torch.randn((cout,), generator=gen, device=DEVICE) * 0.1)


@torch.inference_mode()
def phase9_k3_vs_plain(cfg):
    from tpu_unet_torch.ops.conv_tiles import (conv3x3_fused, conv3x3_fused_plain,
                                               conv3x3_int8_xla)

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    cases = [(name, (2, s, s, cin), cout, 0) for name, s, cin, cout in int8_shapes(cfg)]
    cases += [("ragged", (2, 10, 12, 16), 8, 0), ("ragged", (1, 9, 13, 24), 40, 0),
              ("misaligned", (2, 10, 12, 16), 8, 3), ("ragged", (1, 12, 40, 3), 5, 0),
              ("ragged", (3, 37, 45, 136), 72, 0), ("misaligned", (2, 20, 70, 128), 256, 1)]
    for label, shape, cout, offset in cases:
        x, w, alpha, beta = _k3_inputs(shape, cout, torch.int8, gen, offset)
        for out_kind in ("int8", "bf16"):
            got = conv3x3_fused(x, w, alpha, beta, out_kind=out_kind)
            ref = conv3x3_fused_plain(x, w, alpha, beta, out_kind)
            lib = conv3x3_int8_xla(x, w, alpha, beta, out_kind)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            lib_err = (lib.float() - ref.float()).abs().max().item()
            share = (ref > 0).float().mean().item()
            log(f"phase 9: K3 {label:17s} x{list(shape)} -> {cout} out {out_kind}: "
                f"max|err| {err} vs plain, {lib_err} vs library; nonzero share {share:.3f}")
            if not (got.dtype == ref.dtype and torch.equal(got, ref) and torch.equal(lib, ref)):
                raise AssertionError(f"K3 differs at {label} {shape} -> {cout} ({out_kind})")
            if not 0.0 < share < 1.0:
                raise AssertionError(f"degenerate K3 test outputs at {label} {shape}")
    bf16_err = 0.0
    for shape, cout in [((2, 34, 282, 128), 128), ((2, 20, 70, 64), 128),
                        ((2, 11, 19, 3), 20), ((1, 9, 13, 24), 40)]:
        x, w, alpha, beta = _k3_inputs(shape, cout, torch.bfloat16, gen)
        got = conv3x3_fused(x, w, alpha, beta)
        ref = conv3x3_fused_plain(x, w, alpha, beta)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = BF16_TOL * max(ref.float().abs().max().item(), 1.0)
        log(f"phase 9: K3 bf16 x{list(shape)} -> {cout}: max|err| {err:.3g} (bound {tol:.3g})")
        if not (got.dtype == torch.bfloat16 and err <= tol):
            raise AssertionError(f"K3 bf16 differs at {shape} -> {cout}")
        bf16_err = max(bf16_err, err)
    log("phase 9: ok, K3 bit-exact (tolerance 0) against its plain version and the "
        f"library route on int8 inputs; bf16 inputs within {BF16_TOL} of the scale")
    return 0.0, bf16_err


def phase10_serve_int8(cfg):
    from tpu_unet_torch.data import synthetic_dataset
    from tpu_unet_torch.infer import TileInference, evaluate
    from tpu_unet_torch.infer.quant import (QuantInference, default_quant_names,
                                            load_quant_params)
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused

    model = UNet(cfg, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    data = synthetic_dataset(n_images=4, h=IMAGE, w=IMAGE, crop=TILE_OUT, seed=0)
    engine = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT)
    n_tiles = len(data) * engine.plan.num_tiles
    n_chunks = -(-n_tiles // engine.batch_tiles)
    qpath = os.path.join(HERE, "build", "chip_smoke_int8.npz")
    if os.path.exists(qpath):
        os.remove(qpath)
    results, launches = [], []
    for run in ("calibrated and saved", "served from the .npz"):
        conv3x3_fused.launches = 0
        t0 = time.perf_counter()
        results.append(evaluate(model, data, tile_out=TILE_OUT, verbose=False,
                                quant="int8", quant_path=qpath))
        torch.cuda.synchronize()
        launches.append(conv3x3_fused.launches)
        log(f"phase 10: evaluate(quant='int8') {run} in {time.perf_counter() - t0:.2f} s: "
            f"{launches[-1]} K3 launches for {n_tiles} tiles in {n_chunks} chunk(s); "
            f"{json.dumps(results[-1])}")
        if launches[-1] != 14 * n_chunks:
            raise AssertionError(f"{launches[-1]} K3 launches, want 14 x {n_chunks}")
        if not os.path.exists(qpath):
            raise AssertionError(f"{qpath} was not written")
    first, second = ({k: v for k, v in r.items() if k != "seconds"} for r in results)
    if not all(np.isfinite(first[k]) for k in ("iou_mean", "pe_mean")):
        raise AssertionError(f"int8 evaluate() result {first}")
    if first != second:
        raise AssertionError(f"served from the .npz: {second}, calibrated: {first}")
    qp = load_quant_params(qpath)
    if qp.qnames != default_quant_names(cfg):
        raise AssertionError(f"the .npz holds int8 convs {sorted(qp.qnames)}")

    qis = {impl: QuantInference(qp, impl=impl, device=DEVICE) for impl in ("pallas", "xla")}
    tiles = engine._flat_tiles(engine._on_device(data.images[:1], torch.float32))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the float layers run twice
    n_int8 = 0
    for stage in QUANT_STAGES + [None]:
        got = qis["pallas"].apply(tiles, stop_after=stage)
        want = qis["xla"].apply(tiles, stop_after=stage)
        n_int8 += got.dtype == torch.int8
        if not torch.equal(got, want):
            raise AssertionError(f"QuantInference 'pallas' and 'xla' differ at {stage}")
    torch.backends.cudnn.deterministic = deterministic
    log(f"phase 10: QuantInference 'pallas' (K3) and 'xla' (library) equal at all "
        f"{len(QUANT_STAGES)} stages ({n_int8} int8) and the logits, on image 0's "
        f"{tiles.shape[0]} tiles")

    float_logits = engine.predict_logits(data.images[0])
    int8_logits = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT,
                                apply_fn=qis["pallas"].apply).predict_logits(data.images[0])
    agree = (float_logits.argmax(-1) == int8_logits.argmax(-1)).float().mean().item()
    log(f"phase 10: image 0 class maps, int8 vs bf16: equal on {agree:.5f} of the "
        f"pixels (random weights: reported, not held to a bound)")
    log("phase 10: ok")
    return model, data, qp, launches[0]


def phase11_time_int8(cfg, model, data, qp):
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant import QuantInference
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_tiles import (conv3x3_fused, conv3x3_fused_plain,
                                               conv3x3_int8_xla)

    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(DEVICE)
    xla.load_state_dict(model.state_dict())
    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)

    def make(m, impl=None):
        fn = None if impl is None else QuantInference(qp, impl=impl, device=DEVICE).apply
        return TileInference(m, IMAGE, IMAGE, tile_out=TILE_OUT, apply_fn=fn)

    engines = {"int8 'pallas'": make(model, "pallas"), "int8 'xla'": make(model, "xla"),
               "float 'pallas'": make(model), "float 'xla'": make(xla)}
    n_tiles = len(data) * engines["float 'pallas'"].plan.num_tiles
    order = list(engines) + list(reversed(engines))
    times = {k: [] for k in engines}
    for key in order:
        times[key].append(_time_ms(lambda: engines[key].evaluate_batch(images, lab), 3))
    tiles_s = {}
    for key, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[key] = n_tiles / (ms / 1e3)
        log(f"phase 11: evaluate_batch {key}: {ms:.2f} ms for {n_tiles} tiles of "
            f"{TILE_IN}^2 = {tiles_s[key]:.1f} tiles/s (runs {[round(t, 3) for t in ts]})")
    n = 3
    window, busy, groups, top = _profile(
        lambda r: engines["int8 'pallas'"].evaluate_batch(images, lab), n)
    tiles_s["int8 'pallas' profiled_idle_share"] = 1.0 - busy / window
    log(f"phase 11: profile of {n} evaluate_batch calls int8 'pallas': window "
        f"{window / n:.3f} ms/call, device busy {busy / n:.3f} ms/call, idle share "
        f"{1.0 - busy / window:.4f}; by group (ms/call): "
        + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items()))
    for name, ms in top:
        log(f"phase 11:   {ms / n:9.3f} ms/call  {name[:110]}")
    del engines, xla

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    total = {"kernel": 0.0, "library": 0.0, "plain": 0.0}
    shapes = int8_shapes(cfg)
    with torch.inference_mode():
        for name, s, cin, cout in shapes:
            x, w, alpha, beta = _k3_inputs((BATCH_TILES, s, s, cin), cout, torch.int8, gen)
            t = {"kernel": _time_ms(lambda: conv3x3_fused(x, w, alpha, beta,
                                                          out_kind="int8"), 5),
                 "library": _time_ms(lambda: conv3x3_int8_xla(x, w, alpha, beta, "int8"), 5),
                 "plain": _time_ms(lambda: conv3x3_fused_plain(x, w, alpha, beta, "int8"), 2)}
            for k in total:
                total[k] += t[k]
            nbytes, ops = conv_cost(BATCH_TILES, s, cin, cout, 1, 1, 8)
            b_ms, by = bound(nbytes, ops, "int8")
            log(f"phase 11: {name:17s} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: K3 "
                f"{t['kernel']:.3f} ms ({ops / t['kernel'] / 1e9:.1f} TOP/s), library "
                f"{t['library']:.3f} ms ({ops / t['library'] / 1e9:.1f} TOP/s), plain "
                f"{t['plain']:.3f} ms ({ops / t['plain'] / 1e9:.1f} TOP/s), bound "
                f"{b_ms:.3f} ms ({by})")
            del x, w, alpha, beta
    total["bound"], total["bound_by"] = chunk_bound(shapes, "int8", 1, 1, 8)
    ops = sum(conv_cost(BATCH_TILES, s, cin, cout, 1, 1, 8)[1] for _, s, cin, cout in shapes)
    log(f"phase 11: 14 int8 convs of one {BATCH_TILES}-tile chunk ({ops / 1e12:.3f} T int8 "
        f"ops): K3 {total['kernel']:.2f} ms ({ops / total['kernel'] / 1e9:.1f} TOP/s), "
        f"library {total['library']:.2f} ms, plain {total['plain']:.2f} ms, bound "
        f"{total['bound']:.3f} ms ({total['bound_by']})")
    return total, tiles_s


def main() -> None:
    phase1_device()
    from tpu_unet_torch.models import ModelConfig

    # the plain version's f32 convs must not run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(base_width=64, compute_dtype="bfloat16", conv_impl="pallas")
    max_err = phase2_kernel_vs_plain(cfg)
    model, xla, data, labels, serve_launches = phase3_serve(cfg)
    total, tiles_s = phase4_time(cfg, model, xla, data, labels)
    del model, xla
    edt_err = phase5_edt()
    grad_err = phase6_conv_grad(cfg)
    launches = phase7_train(cfg)
    step_err = phase7_step_agreement(cfg)
    step_ms, edt_ms = phase8_time(cfg)
    k3_err, k3_bf16_err = phase9_k3_vs_plain(cfg)
    model, data, qp, int8_launches = phase10_serve_int8(cfg)
    k3_total, int8_tiles_s = phase11_time_int8(cfg, model, data, qp)
    del model
    band_key = f"num_valid [5, 0], band {EDT_BAND}"
    k2_bound_ms, k2_by = edt_bound((2, 32, TILE_OUT, TILE_OUT), [5, 0], EDT_BAND)
    log(json.dumps({"kernels": [{
        "name": "conv3x3_bias_relu",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv3x3_bias_relu.cu",
        "replaces": "tpu_unet/ops/conv_pallas.py:57",
        "launches": launches["conv3x3_bias_relu"],
        "max_abs_err": max_err,
        "ms": total["kernel"],
        "plain_ms": total["plain"],
        "bound_ms": total["bound"],
        "bound_by": total["bound_by"],
        "library_ms": total["cudnn"],
        "backward_route": "library",
        "launches_by_path": {"serve": serve_launches,
                             "train": launches["conv3x3_bias_relu"]},
        "grad_max_rel_err": grad_err,
        "evaluate_tiles_per_s": tiles_s,
    }, {
        "name": "edt_column_pass",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/edt_column_pass.cu",
        "replaces": "tpu_unet/ops/edt_pallas.py:102",
        "launches": launches["edt_column_pass"],
        "max_abs_err": edt_err,
        "ms": edt_ms[band_key]["kernel"],
        "plain_ms": edt_ms[band_key]["plain"],
        "bound_ms": k2_bound_ms,
        "bound_by": k2_by,
        "library_ms": None,
        "launches_by_path": {"train": launches["edt_column_pass"]},
        "ms_by_case": edt_ms,
    }, {
        "name": "conv3x3_fused",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv3x3_fused.cu",
        "replaces": "tpu_unet/ops/conv_tiles.py:155",
        "launches": int8_launches,
        "max_abs_err": k3_err,
        "ms": k3_total["kernel"],
        "plain_ms": k3_total["plain"],
        "bound_ms": k3_total["bound"],
        "bound_by": k3_total["bound_by"],
        "library_ms": k3_total["library"],
        "bf16_max_abs_err": k3_bf16_err,
        "launches_by_path": {"serve_int8": int8_launches},
        "evaluate_tiles_per_s": int8_tiles_s,
    }], "train_step_ms": step_ms, "step_pallas_vs_xla_grad_rel_err": step_err}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
