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
     optimizer, and K2 against its plain version.
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
    from tpu_unet.config import DATASETS, TrainConfig
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
    from tpu_unet.config import DATASETS, OptimConfig
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
    from tpu_unet.config import DATASETS, OptimConfig
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
    band_key = f"num_valid [5, 0], band {EDT_BAND}"
    log(json.dumps({"kernels": [{
        "name": "conv3x3_bias_relu",
        "route": "cuda",
        "backward_route": "library",
        "source": "tpu_unet_torch/csrc/conv3x3_bias_relu.cu",
        "replaces": "tpu_unet/ops/conv_pallas.py:57",
        "launches": launches["conv3x3_bias_relu"],
        "launches_by_path": {"serve": serve_launches,
                             "train": launches["conv3x3_bias_relu"]},
        "max_abs_err": max_err,
        "grad_max_rel_err": grad_err,
        "ms": total["kernel"],
        "plain_ms": total["plain"],
        "cudnn_bf16_ms": total["cudnn"],
        "evaluate_tiles_per_s": tiles_s,
    }, {
        "name": "edt_column_pass",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/edt_column_pass.cu",
        "replaces": "tpu_unet/ops/edt_pallas.py:102",
        "launches": launches["edt_column_pass"],
        "launches_by_path": {"train": launches["edt_column_pass"]},
        "max_abs_err": edt_err,
        "ms": edt_ms[band_key]["kernel"],
        "plain_ms": edt_ms[band_key]["plain"],
        "ms_by_case": edt_ms,
    }], "train_step_ms": step_ms, "step_pallas_vs_xla_grad_rel_err": step_err}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
