"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the device, the kernel build (every source of tpu_unet_torch/csrc, on
     first use; every kernel launches through ops/_build.launch) and the
     card's name and power limit;
  2. K1, the fused 3x3 conv + bias + ReLU, against its plain PyTorch
     version at every conv shape of a 572x572 U-Net tile (bf16; 17 on the
     sm90 wgmma loop, enc0_conv1 on the simple kernel, each launch's route
     checked), at the full enc0_conv2 chunk, at the sm90 loop's edge shapes
     (M not a multiple of 128, Cout 8/24/72/200/1024, Cin 8/24/1024), with
     a misaligned w (sm90 route, which copies it), at ragged shapes and a
     misaligned x (simple route), and in f32 with TF32 off;
  3. serving: the full-width bf16 U-Net (conv_impl='pallas', random weights
     from seed 0) through evaluate() on a synthetic set: K1's launches by
     route (17 sm90 and 1 simple per chunk), finite metrics, and its logits
     against the same weights under conv_impl='xla' (cuDNN);
  4. serving times, with CUDA events after a warm-up: evaluate_batch under
     'pallas' and 'xla', and each conv shape in turns under K1 as routed,
     the simple kernel at the same shape, and cuDNN in bf16, then the plain
     version, beside the bound;
  5. K2, the EDT column pass kernel, against its plain version, bit for bit
     (tolerance 0, +inf positions equal), on both routes ("sm90", which
     column_pass and edt_batch run, and "simple"): the DIC-HeLa weight-map
     shape [2, 32, 388, 388] with num_valid
     [5, 0] and with all 64 planes live, ragged shapes, W not a multiple of
     4, planes whose H*W*4 is not a multiple of 16 and an all-+inf plane,
     banded (40) and exact;
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
     optimizer, and K2's device time in the profiled step; K2 at
     [2, 32, 388, 388] with num_valid [5, 0] and all 64 planes live, band
     40 and exact, routes "simple" and "sm90" in turns, per call and on
     the device, beside the plain version and the bound;
  9. K3, the fused int8 conv of quantized serving, as routed (the int8
     wgmma loop, "sm90", where it takes the shape) and through the forced
     simple route (the one-stage kernel) against its plain version, bit for
     bit (tolerance 0), and against the int8 library route (im2col +
     torch._int_mm): the 14 int8 conv shapes of a 572x572 tile (batch 2, all
     on the loop), the loop's edge shapes (M off the block, Cout
     16/48/64/200/1024, Cin 16/48/1040), ragged and misaligned shapes (the
     simple route), both out kinds, each launch's route checked; bf16 inputs
     at BF16_TOL;
 10. int8 serving: the full-width bf16 U-Net (conv_impl='pallas', seed 0)
     through evaluate(quant='int8', quant_path=...): calibration, the .npz,
     14 K3 launches per chunk, all on the sm90 loop, and the four float
     3x3 convs on K1 (3 sm90 + 1 simple per chunk; the calibration's float
     forward adds K1's 18 once), finite metrics, a
     second evaluate served from the .npz with equal metrics, every
     stage of QuantInference under 'pallas' (K3) equal to 'xla' (the library
     route; the float 3x3 convs on K1 on both sides, as the config routes
     them); then the four float 3x3 convs on one 16-tile chunk, each on its
     input as the forward computes it: K1 with an f32 bias off the bf16
     grid against its plain version, a bias of 1 + 2^-10 reaching the
     output where its bf16 rounding would not, and `QuantInference._conv_f`
     against the library expression (the engine of the 'xla' config), at
     BF16_TOL;
 11. int8 serving times: evaluate_batch under int8 'pallas' and 'xla' and
     float 'pallas' and 'xla', a profile by kernel group, and each int8 conv
     shape of one 16-tile chunk in turns under K3 as routed, the one-stage
     kernel (forced simple route) and the library route, then the same three
     in reverse, beside the plain version and the bound, in TOP/s;
 12. the research int8 forward's kernels against their plain versions at
     one 16-tile chunk's shapes: K4 (the fused enc0 chain, bf16 x
     [16,572,572,1], C 64, bf16 and int8 skip, pool modes 'fused' and
     'cols'; ragged shapes, C 8, 16 and 24, the strip's edge widths Wo 2,
     88, 90, 178 and a walk that does not divide over the grid) as routed
     (sm90, every case) and through the forced simple route (the chunk),
     each launch's route checked, within BF16_TOL, its int8 skip off
     by at most 1 on < 1e-3 of values; K5 (concat + requantize) at the four
     decoder concats and K6a-c (pair, unpair, interleave) at the pair
     path's shapes, bit for bit, with misaligned and odd-C cases;
 13. the research int8 forward at full width through evaluate_batch, on
     the model trained for 250 steps on the serving tiles and calibrated
     as evaluate(quant='int8') does (random weights leave most margins
     within rounding noise), fused (fused_enc0 + fused_concat: K4 1 on its
     sm90 route, K5 4, K3 14 launches per chunk, on the sm90 loop) and
     paired (pair_level0: K6a, K6b, K6c 1 each, K3 14 on the loop): finite
     metrics; class maps equal to the production int8
     forward's on >= 0.995 of the pixels; the logits against the same
     formulation through the kernels' plain versions and (pair) against
     production within MODEL_TOL of the scale on >= 0.999 of the values;
 14. research times: evaluate_batch of both formulations and production
     int8 'pallas' in turns, a profile of each formulation by kernel group
     (each formulation's kernel groups must have device time), K4 per
     chunk on its sm90 route, its simple route and the library level 0 in
     turns, and K5 and K6a-c per chunk, each against its plain version and
     the library route it replaces.
 15. the fused k x k int8 conv of the phase-packed level 0, as routed and
     through the forced simple route, against its plain version, bit for
     bit, at the path's packed shapes (batch 2, the sm90 loop), a 3x3 shape
     through conv_rows3_col, the loop's edge shapes (Cin 16/48/1040, KH 2
     and 3), ragged, odd-Cin and misaligned cases (the simple route), each
     launch's route checked, and against the library route at the full
     16-tile packed shapes;
 16. int8-phase serving: evaluate(quant='int8-phase', quant_path=...) on the
     model phase 13 trained: the k x k kernel 2 and K3 13 launches per chunk
     under 'pallas', all on the sm90 loop, none under 'xla', the .npz round
     trip, every stage 'pallas' vs 'xla' bit for bit, class maps equal to
     the production int8 forward's on >= 0.995 of the pixels;
 17. int8-phase times: evaluate_batch under int8-phase 'pallas' and 'xla'
     and production int8 'pallas' in turns and a profile, the k x k kernel
     per chunk in turns as routed, on the one-stage kernel and on the
     library route, beside its plain version and the bound, a DIC-HeLa
     train step of the phase-packed model against the plain one ('xla'),
     and the deep-shootout probe (python -m tpu_unet_torch.probes.deep_shootout)
     at batch 16;
 18. the row gather of the gather probe against its plain version, bit for
     bit (NaN in the same places): the probe's 327,184-point gathers at C 2,
     8 and 128, its row gathers and [4096,128] shapes, ragged C (1, 3, 5), a
     misaligned view, int64, negative and out-of-range indices; its times at
     C 2 and 128 against torch.index_select, in turns, per call and on the
     device, and the bound; the host microseconds of each step of the
     launch path at C 2 over 10,000 calls, the sequence every wrapper ran
     before ops/_build.launch against the helper's; the gather probe
     (python -m tpu_unet_torch.probes.gather_probe), every mismatch 0;
 19. the three enc0 stage kernels of the Mosaic probes (conv1, conv2,
     pool/quantize) against their plain versions at the probes' block
     [8, 512, 64], at K4's serving chunk (bf16 x [16,572,572,1], C 64) and
     at ragged shapes (C 16 and 24, odd extents): conv1 within one bf16 ulp,
     conv2 in f32 within 1e-5 of its scale and in ReLU-bf16 within one bf16
     ulp, pool/quantize bit for bit (values on .5 after scaling included);
     each stage's time at the chunk against its plain version, the bound
     and the library call that computes the same function (conv1: the f32
     conv + bias + ReLU, TF32 off; conv2: cuDNN's bf16 conv; the pool:
     max-pool); the
     mosaic probe (python -m tpu_unet_torch.probes.mosaic_probe): every
     piece against its oracle, K4 and K5 at the scripts' sizes, and the
     staged chain at the chunk against K4 (pooled maps equal bit for bit, a
     gate), timed in turns with K4 and the library level 0.
 20. the CLI, in process through tpu_unet_torch.cli.main: TRAINING
     DIC-HeLa (--synthetic: 10 images of 448^2) at full width in bf16 for
     epochs 0..1 with its defaults ('xla', --phase-level0), K2 launched on
     route sm90 at least once a train step, 'best' and 'latest' written, the
     loss finite, and TESTING 'best'. Its ten steps leave every pixel one
     class, a map any kernel would reproduce, so the CLI then serves the
     weights phase 13 trained, stored beside 'best' as 'served' ('xla') and
     'served_pallas' (its stored conv_impl 'pallas', run with
     --no-phase-level0): plain, --quant int8 and int8-phase, with K1 17 sm90
     + 1 simple, K3 14 and 13, and the k x k kernel 2 per chunk under
     'pallas', and the int8 tiers' float 3x3 convs on K1 (3 sm90 + 1
     simple, and 1 sm90, per chunk; int8 calibration's float forward adds
     K1's 18 once a run), none under 'xla'. Each run's IoU and pixel error
     lie in [0, 1], its predictions read back through the port's TIFF
     codec as 0/255 maps that hold both classes, and the 'pallas' maps
     agree with the 'xla' ones on RESEARCH_AGREE of the pixels. K1, K3 and the k x k kernel are held
     against their plain versions at the shapes these runs give them (one
     chunk of 10 tiles of 636^2; the bars of phases 2, 9 and 15), and the
     served weights' logits on that chunk 'pallas' against 'xla' (bf16 at
     phase 3's bar; int8 and int8-phase bit for bit, as phases 10 and 16).
     Then python -m tpu_unet_torch as a process (exit 0, the same maps),
     and beside it, with CUDA_VISIBLE_DEVICES='' and no --platform, one that
     must exit non-zero naming --platform cpu. Each run's wall time beside
     the card's name and power limit.
 21. the int4 tiers on the weights phase 13 trained: evaluate(quant='int4'
     and 'int4-phase', quant_path=...) under 'pallas' (calibrated and saved,
     then served from the .npz) and 'xla': K3 1 (int4, on the sm90 loop,
     the int8 dec0_conv1) and the k x k kernel 2 (int4-phase) per chunk
     under 'pallas', none under 'xla', K1 17 + 1 in the calibrating run,
     and in every run K1 on the float 3x3 convs (3 sm90 + 1 simple per
     chunk, int4-phase 1 sm90: the .npz holds the calibrating model's
     conv_impl 'pallas'); equal metrics across runs; every stage of
     QuantInference 'pallas' vs 'xla' bit for bit; the other tier's .npz refused both ways;
     the int4 ops (shifted and signed accumulate, u4s epilogue, four
     quantizers) on the card against CPU copies bit for bit at the 13 int4
     conv shapes of a 572^2 tile (batch 2); the tier's quality bar
     (foreground-IoU drop against the bf16 model's under 5%, int4-vs-bf16
     map IoU above 0.90); evaluate_batch tiles/s of both tiers under both
     impls beside int8 'pallas', in turns, and a profile of each tier's
     'pallas' by kernel group;
 22. conv_bwd: one DIC-HeLa step at full width (batch 2, conv_impl 'xla')
     under 'xla', 'mm' and 'auto' from the same weights and batch: equal
     losses, every gradient within 1e-2 of its norm of 'xla''s in bf16 and
     within 1e-4 in f32 (TF32 off), the layers 'auto' sends to 'mm' logged;
     the bf16 step by part under the three, in turns, and a profile of each.
 23. the mesh paths (tpu_unet_torch/parallel, TileInference(mesh=)) in rank
     processes of this script (--mesh-rank), each joined through
     initialize_multihost() from torchrun's variables: NCCL with one rank
     per visible card (the DP step, halo inference, meshed evaluate_batch),
     gloo with 2 ranks sharing the card (the DIC-HeLa DP step at batch 2 a
     rank with distance weights, halo inference and the halo train step on
     a 776 x 388 image in strips of 388, meshed evaluate_batch of the
     serving set bf16, int8, int8-phase and int4-phase on phase 13's
     weights) and gloo with 4 ranks as a 2 x 2 mesh (the data x spatial
     halo step on two 776 x 388 images). Each result against this
     process's run on the same card: forward paths bit for bit (halo
     logits at the bf16 bar with equal class maps otherwise), train steps'
     losses within MESH_LOSS_RTOL and momentum within STEP_GRAD_TOL of its
     norm; every rank's parameters and momentum bit-equal (checksums
     all-gathered); K1, K2, K3 and the k x k kernel counted per rank by
     route. A failed rank or a group not done within MESH_TIMEOUT_S fails
     the run, and every rank still running is stopped. Times of ranks that
     share one card are printed as such: not a scaling figure.
 24. TransUNet's decoder on K1: the published TransUNet R50-ViT-B/16
     (conv_impl='pallas', random weights from seed 4, BatchNorm statistics
     drawn so that the folded bias is off 0 and off the bf16 grid), one
     eager forward of a 16-slice chunk at 512 x 512 with the model's
     `conv3x3_bias_relu` wrapped to keep each of its nine calls' bordered
     input, HWIO weight and f32 bias: each call's K1 output, on the sm90
     loop (Cin 768 at 32^2, 1024 and 256 at 64^2, 512 and 128 at 128^2, 192
     and 64 at 256^2, 64 and 16 at 512^2; Cout 512 ... 16), against its
     plain version at BF16_TOL of the output's scale; then K1's and
     attention's launches in one eager forward, counted from 0 (9 and 12).
The line before the last is a JSON summary of the thirteen kernels
(conv3x3_bias_relu, edt_column_pass, conv3x3_fused, enc0_chain,
concat_quantize, pair_batch_channels, unpair_batch_channels,
interleave_pairs, conv_kxk_fused, row_gather, enc0_conv1_stage,
enc0_conv2_stage, enc0_pool_quant_stage) and of the end-to-end paths
timed in turns (float serving, research 'fused', the 'pallas' train step)
with their device idle shares, phase 20's runs, and phases 21-23's
results (phase 23's launches per rank under the kernels' mesh_* paths;
phase 24's under conv3x3_bias_relu's serve_transunet path);
the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.probes import log, time_ms

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


def phase1_device() -> str:
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
    _profile(lambda r: torch.ones(1, device=DEVICE).add_(1), 1)   # the profiler's start-up
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)                 # bare, as nvidia-smi gives it: no time stamp
    return smi


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


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` 2 bytes off 16-byte alignment."""
    return torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)[1:t.numel() + 1] \
        .view(t.shape).copy_(t)


def _compare(shape, cout, dtype, gen, route=None, misalign=None) -> float:
    """K1 through `conv3x3_bias_relu` against its plain version; `route`,
    when given, is the route the launch must take; `misalign` ("x" or "w")
    moves that operand to a contiguous view 2 bytes off 16-byte alignment."""
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    x, w, b = _conv_inputs(shape, cout, dtype, gen)
    if misalign == "x":
        x = _misaligned(x)
    elif misalign == "w":
        w = _misaligned(w)
    sm90 = conv3x3_bias_relu.sm90_launches
    got = conv3x3_bias_relu(x, w, b)
    took = "sm90" if conv3x3_bias_relu.sm90_launches > sm90 else "simple"
    if route is not None and took != route:
        raise AssertionError(f"{shape}->{cout} {dtype} took the {took} route, not {route}")
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


def _route_of(cin: int) -> str:
    """The route a full-width conv takes: enc0_conv1 (Cin 1) the simple one."""
    return "sm90" if cin % 8 == 0 else "simple"


@torch.inference_mode()
def phase2_kernel_vs_plain(cfg) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    shapes, out = conv_shapes(cfg, TILE_IN)
    if out != TILE_OUT or len(shapes) != 18:
        raise AssertionError(f"conv shape list: {len(shapes)} convs to {out}")
    max_err = 0.0
    for name, s, cin, cout in shapes:
        rows = min(s, 34)                     # H cut; W and channels full
        route = _route_of(cin)
        err = _compare((2, rows, s, cin), cout, torch.bfloat16, gen, route)
        max_err = max(max_err, err)
        log(f"phase 2: {name:17s} x[2,{rows},{s},{cin}] -> {cout} ({route}): bf16 max|err| "
            f"{err:.3g}")
    # the full enc0_conv2 activation of one 16-tile chunk (~333 M elements)
    name, s, cin, cout = shapes[1]
    err = _compare((BATCH_TILES, s, s, cin), cout, torch.bfloat16, gen, "sm90")
    max_err = max(max_err, err)
    log(f"phase 2: {name} x[{BATCH_TILES},{s},{s},{cin}] -> {cout} (sm90): bf16 max|err| "
        f"{err:.3g}")
    # the sm90 loop off the model's shapes: M not a multiple of 128, Cout
    # 8/24/72/200/1024, Cin 8/24/1024; then ragged shapes the simple route takes
    for shape, cout, route in [((2, 37, 45, 64), 64, "sm90"), ((3, 13, 29, 128), 200, "sm90"),
                               ((1, 5, 130, 8), 72, "sm90"), ((2, 9, 17, 24), 24, "sm90"),
                               ((1, 6, 40, 8), 8, "sm90"), ((1, 10, 12, 1024), 1024, "sm90"),
                               ((2, 11, 19, 3), 20, "simple"), ((1, 7, 9, 16), 20, "simple")]:
        err = _compare(shape, cout, torch.bfloat16, gen, route)
        max_err = max(max_err, err)
        log(f"phase 2: x{list(shape)} -> {cout} ({route}): bf16 max|err| {err:.3g}")
    for operand, route in (("x", "simple"), ("w", "sm90")):
        err = _compare((1, 10, 34, 64), 64, torch.bfloat16, gen, route, misalign=operand)
        max_err = max(max_err, err)
        log(f"phase 2: x[1,10,34,64] -> 64, {operand} misaligned ({route}): bf16 max|err| "
            f"{err:.3g}")
    for shape, cout in [((1, 18, 20, 8), 16), ((2, 13, 16, 4), 8),
                        ((1, 10, 34, 16), 32), ((2, 12, 15, 1), 8),
                        ((1, 9, 23, 3), 5), ((2, 20, 70, 64), 128)]:
        err = _compare(shape, cout, torch.float32, gen, "simple")
        log(f"phase 2: f32 x{list(shape)} -> {cout} (simple): max|err| {err:.3g}")
    log(f"phase 2: ok, bf16 tolerance {BF16_TOL} of the output scale, "
        f"f32 rtol {F32_RTOL} atol {F32_ATOL} (TF32 off); 17 of the 18 convs on the sm90 loop")
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

    conv3x3_bias_relu.launches = conv3x3_bias_relu.sm90_launches = 0
    result = evaluate(model, data, tile_out=TILE_OUT, verbose=False)
    torch.cuda.synchronize()
    sm90 = conv3x3_bias_relu.sm90_launches
    launches = {"sm90": sm90, "simple": conv3x3_bias_relu.launches - sm90}
    log(f"phase 3: evaluate() on {len(data)} images, {n_tiles} tiles of "
        f"{TILE_IN}^2 in {n_chunks} chunk(s) of {engine.batch_tiles}: "
        f"K1 launches by route {launches}; {json.dumps(result)}")
    if launches != {"sm90": 17 * n_chunks, "simple": n_chunks}:
        raise AssertionError(f"K1 launches {launches}, want sm90 17 x {n_chunks} and "
                             f"simple 1 x {n_chunks}")

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


def phase4_time(cfg, model, xla, data, labels):
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.ops.conv_pallas import (_conv3x3_route_forward, conv3x3_bias_relu,
                                                conv3x3_bias_relu_plain)

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy(labels).to(DEVICE)
    engines = {"pallas": TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT),
               "xla": TileInference(xla, IMAGE, IMAGE, tile_out=TILE_OUT)}
    n_tiles = len(data) * engines["pallas"].plan.num_tiles
    times = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times[impl].append(time_ms(lambda: engines[impl].evaluate_batch(images, lab), DEVICE, 3))
    tiles_s = {}
    for impl, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[impl] = n_tiles / (ms / 1e3)
        tiles_s[f"{impl} ms"] = ms
        log(f"phase 4: evaluate_batch conv_impl={impl!r}: {ms:.2f} ms for {n_tiles} "
            f"tiles of {TILE_IN}^2 = {tiles_s[impl]:.1f} tiles/s (runs {ts})")
    n = 3
    window, busy, _, _ = _profile(lambda r: engines["pallas"].evaluate_batch(images, lab), n)
    tiles_s["pallas profiled_idle_share"] = 1.0 - busy / window
    tiles_s["pallas profiled_busy_ms"] = busy / n
    log(f"phase 4: profile of {n} evaluate_batch calls conv_impl='pallas': window "
        f"{window / n:.3f} ms/call, device busy {busy / n:.3f} ms/call, idle share "
        f"{1.0 - busy / window:.4f}")

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    shapes, _ = conv_shapes(cfg, TILE_IN)
    keys = ("kernel", "simple", "plain", "cudnn")
    total = dict.fromkeys(keys + ("sm90", "simple_at_sm90_shapes", "cudnn_at_sm90_shapes"), 0.0)
    per_shape = {}
    with torch.inference_mode():
        for name, s, cin, cout in shapes:
            x, w, b = _conv_inputs((BATCH_TILES, s, s, cin), cout, torch.bfloat16, gen)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)                 # channels-last view
            fns = {"kernel": (lambda: conv3x3_bias_relu(x, w, b), 5),
                   "simple": (lambda: _conv3x3_route_forward(x, w, b, "simple"), 3),
                   "cudnn": (lambda: F.relu(F.conv2d(x_nchw, w_oihw, b)), 5)}
            runs = {k: [] for k in fns}
            for k in ("kernel", "simple", "cudnn", "cudnn", "simple", "kernel"):   # in turns
                fn, reps = fns[k]
                runs[k].append(time_ms(fn, DEVICE, reps))
            t = {k: sum(v) / len(v) for k, v in runs.items()}
            t["plain"] = time_ms(lambda: conv3x3_bias_relu_plain(x, w, b), DEVICE, 3)
            route = _route_of(cin)
            for k in keys:
                total[k] += t[k]
            if route == "sm90":
                total["sm90"] += t["kernel"]
                total["simple_at_sm90_shapes"] += t["simple"]
                total["cudnn_at_sm90_shapes"] += t["cudnn"]
            nbytes, flop = conv_cost(BATCH_TILES, s, cin, cout, 2, 2, 2)
            t["bound"], t["bound_by"] = bound(nbytes, flop, "bf16")
            t["route"] = route
            per_shape[name] = t
            log(f"phase 4: {name:17s} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: kernel ({route}) "
                f"{t['kernel']:.3f} ms ({flop / t['kernel'] / 1e9:.1f} TFLOP/s), simple "
                f"{t['simple']:.3f} ms, cuDNN bf16 {t['cudnn']:.3f} ms, plain f32 "
                f"{t['plain']:.3f} ms, bound {t['bound']:.3f} ms ({t['bound_by']})")
            del x, w, b, w_oihw, x_nchw
    total["bound"], total["bound_by"] = chunk_bound(shapes, "bf16", 2, 2, 2)
    sm90_shapes = [sh for sh in shapes if _route_of(sh[2]) == "sm90"]
    total["bound_sm90"] = chunk_bound(sm90_shapes, "bf16", 2, 2, 2)[0]
    total["per_shape"] = per_shape
    log(f"phase 4: 18 convs of one {BATCH_TILES}-tile chunk: kernel {total['kernel']:.2f} ms "
        f"(the 17 sm90 convs {total['sm90']:.2f} ms, their bound {total['bound_sm90']:.3f}), "
        f"simple route alone {total['simple']:.2f} ms ({total['simple_at_sm90_shapes']:.2f} at "
        f"the 17), cuDNN bf16 {total['cudnn']:.2f} ms ({total['cudnn_at_sm90_shapes']:.2f} at "
        f"the 17), plain f32 {total['plain']:.2f} ms, bound {total['bound']:.3f} ms "
        f"({total['bound_by']})")
    return total, tiles_s


# K2: every value is an integer below 2^24 or +inf, so kernel and plain
# version must agree bit for bit.
EDT_BAND = 40
EDT_SHAPES = [  # (g2 shape, num_valid)
    ((2, 32, 388, 388), [5, 0]),   # the DIC-HeLa weight-map batch
    ((2, 32, 388, 388), None),     # all 64 planes live (up to 32 objects a crop)
    ((3, 70, 45), None),           # H, W not multiples of the tiles; W not of 4
    ((2, 30, 100), None),          # H < band
    ((1, 4, 1, 37), [2]),          # one-row planes
    ((1, 5, 300, 97), [5]),
    ((2, 6, 37, 41), [4, 1]),      # H*W*4 not a multiple of 16: scalar +inf stores
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


def _k2_forms():
    """K2's routes by name: "sm90" (what column_pass runs) and "simple"."""
    from tpu_unet_torch.ops.edt_pallas import _column_pass_route_forward, column_pass

    return {"sm90": lambda g2, nv, band: column_pass(g2, nv, band),
            "simple": lambda g2, nv, band: _column_pass_route_forward(g2, nv, band, "simple")}


def phase5_edt() -> float:
    from tpu_unet_torch.ops.edt_pallas import column_pass_plain

    forms = _k2_forms()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for shape, nv in EDT_SHAPES:
        g2 = _g2(shape, gen)
        g2.view(-1, *shape[-2:])[0] = float("inf")          # an all-+inf plane
        num = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=DEVICE)
        for band in (EDT_BAND, None):
            ref = column_pass_plain(g2, num_valid=num, band=band)
            fin = torch.isfinite(ref)
            for form, fn in forms.items():
                got = fn(g2, num, band)
                torch.cuda.synchronize()
                same_inf = torch.equal(torch.isinf(got), torch.isinf(ref))
                err = (got[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
                log(f"phase 5: K2 {form:8s} g2{list(shape)} num_valid {nv} band {band}: "
                    f"max|err| {err}, +inf positions equal: {same_inf}, finite share "
                    f"{fin.float().mean().item():.4f}")
                if not (same_inf and err == 0.0 and torch.equal(got, ref)):
                    raise AssertionError(f"K2 {form} differs from its plain version at "
                                         f"{shape}, band {band}")
                del got
    log("phase 5: ok, K2 bit-exact at every shape, both routes")
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
    conv3x3_bias_relu.launches = conv3x3_bias_relu.sm90_launches = 0
    column_pass.launches = column_pass.sm90_launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(data, data, epochs=0)
    torch.cuda.synchronize()
    launches = {"conv3x3_bias_relu": conv3x3_bias_relu.launches,
                "conv3x3_bias_relu_sm90": conv3x3_bias_relu.sm90_launches,
                "edt_column_pass": column_pass.launches,
                "edt_column_pass_sm90": column_pass.sm90_launches}
    log(f"phase 7: Trainer.fit(epochs=0) on {len(data)} images of 448^2: {n_steps} "
        f"train steps, {n_val} val batches in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}; history {json.dumps(history)}")
    if (launches["conv3x3_bias_relu"] != 18 * (n_steps + n_val)
            or launches["conv3x3_bias_relu_sm90"] != 17 * (n_steps + n_val)):
        raise AssertionError(f"K1 launches {launches}, want 18 x ({n_steps} + {n_val}), "
                             f"17 of each 18 on the sm90 route")
    if (launches["edt_column_pass"] < n_steps
            or launches["edt_column_pass_sm90"] != launches["edt_column_pass"]):
        raise AssertionError(f"K2 launches {launches}, want >= {n_steps}, all on the sm90 "
                             f"route")
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
    ("K1 conv3x3_bias_relu", ("conv3x3_bias_relu", "sm90::conv3x3_")),
    ("K2 edt_column_pass", ("column_pass_kernel",)),
    ("K3 conv3x3_fused", ("conv3x3_fused",)),
    ("K4 enc0_chain", ("enc0_chain",)),
    ("K5 concat_quantize", ("concat_quantize",)),
    ("K6 interleave_copy", ("interleave_copy",)),
    ("k x k conv_kxk_fused", ("conv_kxk_fused",)),
    ("cuDNN/cuBLAS conv and GEMM", ("conv", "gemm", "xmma", "cutlass", "cudnn",
                                    "dgrad", "wgrad", "winograd", "sm90")),
    ("gather, scatter, index", ("index", "gather", "scatter")),
    ("scans and reductions", ("reduce", "scan", "cummax", "cummin", "arg", "sum",
                              "norm", "max", "min")),
)


def _profile(step, n: int):
    """Device time by kernel over `n` calls of `step` under torch.profiler:
    (window ms on the host clock, busy ms, {group: ms}, top kernels)."""
    from tpu_unet_torch.utils.profiling import trace_capture

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace_capture() as prof:
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


def _train_parts():
    """What a DIC-HeLa train step reads: (augmentation pipeline, training
    set, its arrays on the card, the distance weight-map function)."""
    from tpu_unet_torch.config import DATASETS
    from tpu_unet_torch.data.augment import AugmentPipeline
    from tpu_unet_torch.losses.weights import make_weight_fn

    data = _train_data()
    arrays = [torch.from_numpy(a).to(DEVICE) for a in (
        data.images, data.targets, data.crop_log_probs, data.crop_pairs)]
    return (AugmentPipeline(DATASETS["DIC-C2DH-HeLa"].augment()), data, arrays,
            make_weight_fn("distance"))


def _train_step(model, opt, parts, r, mark=lambda k, i: None):
    """Step `r` of the train loop, as `make_train_step` runs it; `mark(part,
    0 or 1)` around its four parts (augment, weights, fwd_bwd, optimizer)."""
    from tpu_unet_torch.losses.bce import weighted_bce_with_logits
    from tpu_unet_torch.models import center_crop_or_pad

    pipe, data, arrays, weight_fn = parts
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


# K2's routes in the order of its timing turns (then reversed)
K2_TURNS = ("simple", "sm90")


def phase8_k2_routes():
    """K2 at the weight map's shape [2, 32, 388, 388], with the fixture's
    num_valid [5, 0] and with all 64 planes live, band 40 and exact: each
    route in turns, per call (CUDA events over 20 back-to-back
    calls, which the host's launch work can bound) and on the device (the
    profiler's kernel time over 20 calls), beside the plain version and the
    bound."""
    from tpu_unet_torch.ops.edt_pallas import column_pass_plain

    forms = _k2_forms()
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    shape = (2, 32, TILE_OUT, TILE_OUT)
    g2 = _g2(shape, gen)
    edt_ms = {}
    for label, nv in (("num_valid [5, 0]", [5, 0]), ("all 64 planes live", None)):
        num = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=DEVICE)
        for band in (EDT_BAND, None):
            per_call, device = {f: [] for f in K2_TURNS}, {f: [] for f in K2_TURNS}
            for form in K2_TURNS + K2_TURNS[::-1]:
                fn = forms[form]
                per_call[form].append(time_ms(lambda: fn(g2, num, band), DEVICE, 20))
                device[form].append(_profile(lambda r: fn(g2, num, band), 20)[1] / 20)
            t = {"per_call": {f: sum(v) / len(v) for f, v in per_call.items()},
                 "device": {f: sum(v) / len(v) for f, v in device.items()},
                 "plain": time_ms(lambda: column_pass_plain(g2, num, band), DEVICE, 3)}
            t["bound"], t["bound_by"] = edt_bound(shape, nv, band)
            edt_ms[f"{label}, band {band}"] = t
            log(f"phase 8: K2 g2{list(shape)} {label}, band {band}, in turns: per call "
                + ", ".join(f"{f} {v:.4f}" for f, v in t["per_call"].items())
                + " ms; on the device "
                + ", ".join(f"{f} {v:.4f}" for f, v in t["device"].items())
                + f" ms; plain {t['plain']:.3f} ms, bound {t['bound']:.4f} ms "
                f"({t['bound_by']}); sm90 at "
                f"{t['bound'] / t['device']['sm90']:.1%} of the bound on the device, "
                f"{t['device']['simple'] / t['device']['sm90']:.2f}x faster than simple")
    return edt_ms


def phase8_time(cfg):
    from tpu_unet_torch.config import OptimConfig
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.train import make_optimizer

    parts_in = _train_parts()
    models = {}
    for impl in ("pallas", "xla"):
        m = UNet(dataclasses.replace(cfg, conv_impl=impl),
                 generator=torch.Generator().manual_seed(0)).to(DEVICE)
        models[impl] = (m, make_optimizer(m.parameters(), OptimConfig()))
    parts = ("augment", "weights", "fwd_bwd", "optimizer")

    def train_step(impl, r, ev=None):
        mark = (lambda k, i: ev[k][i].record()) if ev else (lambda k, i: None)
        _train_step(*models[impl], parts_in, r, mark)

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
        step_ms[impl]["profiled_busy_ms"] = busy / n
        step_ms[impl]["profiled_k2_group_ms"] = groups["K2 edt_column_pass"] / n
        log(f"phase 8: profile of {n} steps conv_impl={impl!r}: window {window / n:.3f} "
            f"ms/step, device busy {busy / n:.3f} ms/step, idle share "
            f"{1.0 - busy / window:.4f}; by group (ms/step): "
            + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items()))
        for name, ms in top:
            log(f"phase 8:   {ms / n:9.3f} ms/step  {name[:110]}")
    del models

    log(f"phase 8: K2 in the profiled 'pallas' train step (DIC-HeLa fixture, 5 cells per "
        f"image): {step_ms['pallas']['profiled_k2_group_ms']:.4f} ms/step on the device")
    edt_ms = phase8_k2_routes()
    return step_ms, edt_ms


# The stages of the quantized forward that `QuantInference.apply(stop_after=)`
# can return, in order.
QUANT_STAGES = ([f"enc{d}_conv{i}" for d in range(4) for i in (1, 2)]
                + [f"pool{d}" for d in range(4)]
                + ["bottleneck_conv1", "bottleneck_conv2"]
                + [f"up{d}" for d in range(4)]
                + [f"dec{d}_conv{i}" for d in range(4) for i in (1, 2)])


def int8_shapes(cfg, size: int = TILE_IN):
    """The conv shapes of a size x size tile that int8 serving runs through K3."""
    from tpu_unet_torch.infer.quant import default_quant_names

    names = default_quant_names(cfg)
    shapes = [sh for sh in conv_shapes(cfg, size)[0] if sh[0] in names]
    if len(shapes) != 14:
        raise AssertionError(f"{len(shapes)} int8 convs, want 14: {sorted(names)}")
    return shapes


def _k3_inputs(shape, cout, dtype, gen, offset=0, k=3):
    """int8 x and k x k w with f32 alpha and beta that spread the outputs
    over [0, 127] (or bf16 x and 3x3 w, alpha 1). `offset` bytes put x off
    its 16-byte alignment, which the kernels take on their scalar load
    path."""
    cin = shape[-1]
    if dtype == torch.int8:
        buf = torch.randint(-127, 128, (math.prod(shape) + offset,), generator=gen,
                            device=DEVICE, dtype=torch.int8)
        x = buf[offset:].view(shape)
        w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        alpha = torch.rand((cout,), generator=gen, device=DEVICE) * 2e-3 / math.sqrt(cin)
        beta = torch.randn((cout,), generator=gen, device=DEVICE) * 3
        return x, w, alpha, beta
    x, w, _ = _conv_inputs(shape, cout, dtype, gen)
    return (x, w, torch.ones((cout,), device=DEVICE),
            torch.randn((cout,), generator=gen, device=DEVICE) * 0.1)


# K3's int8 wgmma loop off the model's shapes: M not a multiple of the
# block, Cout 16/48/64/200/1024, Cin 16/48/1040 (a part-filled 128-channel K
# step), both blocks; Cout 200 takes the loop with bf16 out only.
K3_LOOP_EDGES = [((2, 37, 45, 128), 64), ((1, 10, 30, 16), 16), ((2, 9, 21, 48), 48),
                 ((3, 13, 29, 128), 200), ((1, 10, 12, 1040), 1024), ((2, 8, 20, 256), 1024)]


def _k3_launch(x, w, alpha, beta, out_kind):
    """K3 through `conv3x3_fused`, and the route its launch took (from the
    sm90 count), which must be the one `conv3x3_fused_route` names."""
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused, conv3x3_fused_route

    sm90 = conv3x3_fused.sm90_launches
    got = conv3x3_fused(x, w, alpha, beta, out_kind=out_kind)
    took = "sm90" if conv3x3_fused.sm90_launches > sm90 else "simple"
    if took != conv3x3_fused_route(x, w, out_kind):
        raise AssertionError(f"K3 at x {tuple(x.shape)} took the {took} route")
    return got, took


@torch.inference_mode()
def phase9_k3_vs_plain(cfg):
    """K3 as routed and through the forced simple route against its plain
    version, and the library route, bit for bit: the 14 int8 shapes (batch
    2; every one on the sm90 loop), the loop's edge shapes, ragged and
    misaligned shapes (the simple route), both out kinds; bf16 inputs at
    BF16_TOL. Returns (max int8 error, max bf16 error)."""
    from tpu_unet_torch.ops.conv_tiles import (_conv3x3_fused_route_forward, conv3x3_fused,
                                               conv3x3_fused_plain, conv3x3_int8_xla)

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    cases = [(name, (2, s, s, cin), cout, 0, "sm90") for name, s, cin, cout in int8_shapes(cfg)]
    cases += [("loop edge", shape, cout, 0, None) for shape, cout in K3_LOOP_EDGES]
    cases += [("Cout 8", (2, 10, 12, 16), 8, 0, None),        # sm90 for bf16 out only
              ("ragged", (1, 9, 13, 24), 40, 0, "simple"),
              ("misaligned", (2, 10, 12, 16), 8, 3, "simple"),
              ("ragged", (1, 12, 40, 3), 5, 0, "simple"),
              ("ragged", (3, 37, 45, 136), 72, 0, "simple"),
              ("misaligned", (2, 20, 70, 128), 256, 1, "simple")]
    routes = {"sm90": 0, "simple": 0}
    for label, shape, cout, offset, want in cases:
        x, w, alpha, beta = _k3_inputs(shape, cout, torch.int8, gen, offset)
        for out_kind in ("int8", "bf16"):
            got, took = _k3_launch(x, w, alpha, beta, out_kind)
            routes[took] += 1
            if want is not None and took != want:
                raise AssertionError(f"K3 {label} {shape} -> {cout} ({out_kind}) took {took}")
            simple = _conv3x3_fused_route_forward(x, w, alpha, beta, "simple", out_kind)
            ref = conv3x3_fused_plain(x, w, alpha, beta, out_kind)
            lib = conv3x3_int8_xla(x, w, alpha, beta, out_kind)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            lib_err = (lib.float() - ref.float()).abs().max().item()
            share = (ref > 0).float().mean().item()
            log(f"phase 9: K3 {label:17s} x{list(shape)} -> {cout} out {out_kind} ({took}): "
                f"max|err| {err} vs plain, {lib_err} vs library; simple route equal "
                f"{torch.equal(simple, ref)}; nonzero share {share:.3f}")
            if not (got.dtype == ref.dtype and torch.equal(got, ref) and torch.equal(lib, ref)
                    and torch.equal(simple, ref)):
                raise AssertionError(f"K3 differs at {label} {shape} -> {cout} ({out_kind})")
            if not 0.0 < share < 1.0:
                raise AssertionError(f"degenerate K3 test outputs at {label} {shape}")
        del x, w, got, simple, ref, lib
    bf16_err = 0.0
    for shape, cout in [((2, 34, 282, 128), 128), ((2, 20, 70, 64), 128),
                        ((2, 11, 19, 3), 20), ((1, 9, 13, 24), 40)]:
        x, w, alpha, beta = _k3_inputs(shape, cout, torch.bfloat16, gen)
        got, took = _k3_launch(x, w, alpha, beta, "auto")
        ref = conv3x3_fused_plain(x, w, alpha, beta)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = BF16_TOL * max(ref.float().abs().max().item(), 1.0)
        log(f"phase 9: K3 bf16 x{list(shape)} -> {cout} ({took}): max|err| {err:.3g} "
            f"(bound {tol:.3g})")
        if not (got.dtype == torch.bfloat16 and err <= tol and took == "simple"):
            raise AssertionError(f"K3 bf16 differs at {shape} -> {cout}")
        bf16_err = max(bf16_err, err)
    log(f"phase 9: ok, K3 bit-exact (tolerance 0) on both routes against its plain version "
        f"and the library route on int8 inputs ({routes['sm90']} launches on the sm90 loop, "
        f"{routes['simple']} on the simple kernel); bf16 inputs within {BF16_TOL} of the scale")
    return 0.0, bf16_err


# K1 launches (all, sm90) per chunk of the production int8 tier at full
# width under conv_impl 'pallas': its four float 3x3 convs (enc0_conv1 on
# the simple kernel); and of the int8-phase tier, whose level 0 is packed:
# enc1_conv1 alone.
INT8_FLOAT_K1 = (4, 3)
INT8_PHASE_FLOAT_K1 = (1, 1)
# the production int8 tier's float 3x3 convs and the stage each reads
INT8_FLOAT_CONVS = {"enc0_conv1": None, "enc0_conv2": "enc0_conv1", "enc1_conv1": "pool0",
                    "dec0_conv2": "dec0_conv1"}


@torch.inference_mode()
def _int8_float_convs_on_k1(qp, qi, chunk):
    """K1's f32-bias instances at the shapes the int8 tier gives them, each
    float 3x3 conv on its input of `chunk` as `qi` (an engine on K1)
    computes it: K1 with an f32 bias off the bf16 grid against its plain
    version and `qi._conv_f` against the library expression (the engine of
    the 'xla' config), both at BF16_TOL of the output's scale, and a bias
    of 1 + 2^-10 that reaches the output where its bf16 rounding would not:
    relu(2^-8 + b) rounds to 1 + 2^-7, relu(2^-8 + bf16(b)) to 1. Returns
    ({'k1_vs_plain', 'conv_f_vs_library'}: max |err|, the routes taken)."""
    from tpu_unet_torch.infer.quant import QuantInference
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    lib = QuantInference(dataclasses.replace(qp, cfg=dataclasses.replace(qp.cfg,
                                                                          conv_impl="xla")),
                         impl="pallas", device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    errs, routes = {"k1_vs_plain": 0.0, "conv_f_vs_library": 0.0}, {}
    for name, prev in INT8_FLOAT_CONVS.items():
        v = chunk if prev is None else qi.apply(chunk, stop_after=prev)
        v = (qi._deq(v, qp.scales[prev]) if v.dtype == torch.int8
             else v.to(torch.bfloat16)).contiguous()
        w = qi._fconv_hwio[name]
        cin, cout = w.shape[2:]
        b = (0.05 * torch.randn(cout, generator=gen, device=DEVICE)).to(torch.bfloat16)
        b = b.float() * (1 + 2.0 ** -10)              # off the bf16 grid
        if torch.equal(b.to(torch.bfloat16).float(), b):
            raise AssertionError(f"{name}: the f32 bias is bf16-exact")
        sm90 = conv3x3_bias_relu.sm90_launches
        got = conv3x3_bias_relu(v, w, b)
        routes[name] = "sm90" if conv3x3_bias_relu.sm90_launches > sm90 else "simple"
        if routes[name] != _route_of(cin):
            raise AssertionError(f"{name}: K1 took the {routes[name]} route")
        ref = conv3x3_bias_relu_plain(v, w, b)
        pairs = {"k1_vs_plain": (got, ref),
                 "conv_f_vs_library": (qi._conv_f(name, v), lib._conv_f(name, v))}
        line = []
        for key, (y, want) in pairs.items():
            if y.dtype != torch.bfloat16 or y.shape != want.shape:
                raise AssertionError(f"{name} {key}: {y.dtype} {tuple(y.shape)}, want "
                                     f"{tuple(want.shape)}")
            err = (y.float() - want.float()).abs().max().item()
            bar = BF16_TOL * max(want.float().abs().max().item(), 1.0)
            if not err <= bar:
                raise AssertionError(f"{name} {key}: max |err| {err} > {bar}")
            errs[key] = max(errs[key], err)
            line.append(f"{key} max|err| {err:.3g} (bound {bar:.3g})")
        del got, ref, pairs
        ones = torch.zeros_like(v)
        ones[..., 0] = 1.0
        tap = torch.zeros_like(w)
        tap[1, 1, 0] = 2.0 ** -8
        odd = torch.full_like(b, 1 + 2.0 ** -10)
        if not (bool((conv3x3_bias_relu(ones, tap, odd) == 1 + 2.0 ** -7).all())
                and bool((conv3x3_bias_relu(ones, tap, odd.to(torch.bfloat16)) == 1.0).all())):
            raise AssertionError(f"{name}: K1 at x{list(v.shape)} does not add the f32 bias "
                                 f"before its one rounding")
        log(f"phase 10: float conv {name:11s} x{list(v.shape)} -> {cout} ({routes[name]}), "
            f"f32 bias: " + ", ".join(line) + "; the bias 1 + 2^-10 reaches the output")
        del v, ones
    return errs, routes


def phase10_serve_int8(cfg):
    from tpu_unet_torch.data import synthetic_dataset
    from tpu_unet_torch.infer import TileInference, evaluate
    from tpu_unet_torch.infer.quant import (QuantInference, default_quant_names,
                                            load_quant_params)
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
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
        conv3x3_fused.launches = conv3x3_fused.sm90_launches = 0
        conv3x3_bias_relu.launches = conv3x3_bias_relu.sm90_launches = 0
        t0 = time.perf_counter()
        results.append(evaluate(model, data, tile_out=TILE_OUT, verbose=False,
                                quant="int8", quant_path=qpath))
        torch.cuda.synchronize()
        launches.append({"sm90": conv3x3_fused.sm90_launches,
                         "simple": conv3x3_fused.launches - conv3x3_fused.sm90_launches})
        k1 = (conv3x3_bias_relu.launches, conv3x3_bias_relu.sm90_launches)
        log(f"phase 10: evaluate(quant='int8') {run} in {time.perf_counter() - t0:.2f} s: "
            f"K3 launches by route {launches[-1]}, K1 (all, sm90) {k1} for {n_tiles} tiles "
            f"in {n_chunks} chunk(s); {json.dumps(results[-1])}")
        if launches[-1] != {"sm90": 14 * n_chunks, "simple": 0}:
            raise AssertionError(f"K3 launches {launches[-1]}, want 14 x {n_chunks} on sm90")
        # the float 3x3 convs, and once the calibration's float forward
        calib = (18, 17) if run.startswith("calibrated") else (0, 0)
        want = tuple(n * n_chunks + c for n, c in zip(INT8_FLOAT_K1, calib))
        if k1 != want:
            raise AssertionError(f"K1 launches {k1}, want {want}")
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
    chunk = engine._flat_tiles(engine._on_device(data.images, torch.float32))
    float_errs, float_routes = _int8_float_convs_on_k1(qp, qis["pallas"],
                                                       chunk[:engine.batch_tiles])
    del chunk

    float_logits = engine.predict_logits(data.images[0])
    int8_logits = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT,
                                apply_fn=qis["pallas"].apply).predict_logits(data.images[0])
    agree = (float_logits.argmax(-1) == int8_logits.argmax(-1)).float().mean().item()
    log(f"phase 10: image 0 class maps, int8 vs bf16: equal on {agree:.5f} of the "
        f"pixels (random weights: reported, not held to a bound)")
    log("phase 10: ok")
    # K1's launches serving from the .npz: the float 3x3 convs alone
    return model, data, qp, launches[0], {"launches": k1[0], "routes": float_routes,
                                          **float_errs}


# The int8 kernels' timing turns (phases 11, 17): the kernel as routed, the
# one-stage kernel through the forced simple route, the library route, then
# the same three in reverse, each over REPS launches after a warm-up.
TURN_KEYS = ("kernel", "simple", "library")
TURN_REPS = {"kernel": 10, "simple": 5, "library": 5}


def _in_turns(fns):
    """{key: mean ms} of the callables `fns` (keyed by TURN_KEYS), timed in
    turns: the keys in order, then reversed."""
    runs = {k: [] for k in fns}
    for k in TURN_KEYS + TURN_KEYS[::-1]:
        runs[k].append(time_ms(fns[k], DEVICE, TURN_REPS[k]))
    return {k: sum(v) / len(v) for k, v in runs.items()}


def _turns_line(t, ops):
    return (f"kernel ({t['route']}, {t['block'][0]}x{t['block'][1]}) {t['kernel']:.3f} ms "
            f"({ops / t['kernel'] / 1e9:.1f} TOP/s), simple {t['simple']:.3f} ms "
            f"({ops / t['simple'] / 1e9:.1f} TOP/s), library {t['library']:.3f} ms "
            f"({ops / t['library'] / 1e9:.1f} TOP/s), plain {t['plain']:.3f} ms, bound "
            f"{t['bound']:.3f} ms ({t['bound_by']}; {ops / t['bound'] / 1e9:.0f} TOP/s)")


def _require_groups(groups, *names):
    """Fail unless every named kernel group of a profile has device time:
    a kernel whose name fell into another group would read as 0."""
    missing = [g for g in names if not groups.get(g, 0.0) > 0.0]
    if missing:
        raise AssertionError(f"no device time in the profile's groups {missing}")


def phase11_time_int8(cfg, model, data, qp):
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant import QuantInference
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_tiles import (_conv3x3_fused_route_forward, conv3x3_fused,
                                               conv3x3_fused_plain, conv3x3_fused_route,
                                               conv3x3_int8_xla, sm90_block)

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
        times[key].append(time_ms(lambda: engines[key].evaluate_batch(images, lab), DEVICE, 3))
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
    tiles_s["int8 'pallas' profiled_ms_per_call"] = {
        "device_busy": busy / n, **{g: ms / n for g, ms in groups.items()}}
    _require_groups(groups, "K3 conv3x3_fused")
    del engines, xla

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    total = dict.fromkeys(TURN_KEYS + ("plain",), 0.0)
    shapes = int8_shapes(cfg)
    per_shape = {}
    with torch.inference_mode():
        for name, s, cin, cout in shapes:
            x, w, alpha, beta = _k3_inputs((BATCH_TILES, s, s, cin), cout, torch.int8, gen)
            nbytes, ops = conv_cost(BATCH_TILES, s, cin, cout, 1, 1, 8)
            t = _in_turns({
                "kernel": lambda: conv3x3_fused(x, w, alpha, beta, out_kind="int8"),
                "simple": lambda: _conv3x3_fused_route_forward(x, w, alpha, beta, "simple",
                                                               "int8"),
                "library": lambda: conv3x3_int8_xla(x, w, alpha, beta, "int8")})
            t["plain"] = time_ms(lambda: conv3x3_fused_plain(x, w, alpha, beta, "int8"),
                                 DEVICE, 2)
            t["route"] = conv3x3_fused_route(x, w, "int8")
            t["block"] = list(sm90_block(cout))
            t["bound"], t["bound_by"] = bound(nbytes, ops, "int8")
            for k in total:
                total[k] += t[k]
            per_shape[name] = t
            log(f"phase 11: {name:17s} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: "
                + _turns_line(t, ops))
            del x, w, alpha, beta
    total["bound"], total["bound_by"] = chunk_bound(shapes, "int8", 1, 1, 8)
    total["per_shape"] = per_shape
    ops = sum(conv_cost(BATCH_TILES, s, cin, cout, 1, 1, 8)[1] for _, s, cin, cout in shapes)
    log(f"phase 11: 14 int8 convs of one {BATCH_TILES}-tile chunk ({ops / 1e12:.3f} T int8 "
        f"ops): K3 {total['kernel']:.3f} ms ({ops / total['kernel'] / 1e9:.1f} TOP/s), the "
        f"simple kernel {total['simple']:.3f} ms, library {total['library']:.3f} ms, plain "
        f"{total['plain']:.2f} ms, bound {total['bound']:.3f} ms ({total['bound_by']})")
    return total, tiles_s


# The research int8 forward (phases 12-14): its kernels' names, the
# formulations' flags, and each kernel's launches per chunk on its path.
RESEARCH = {
    "fused": ({"fused_enc0": True, "fused_concat": True},
              {"enc0_chain": 1, "concat_quantize": 4, "conv3x3_fused": 14}),
    "pair": ({"pair_level0": True},
             {"pair_batch_channels": 1, "unpair_batch_channels": 1, "interleave_pairs": 1,
              "conv3x3_fused": 14}),
}
# The class-map agreement bar of tests/test_quant.py for the fused forward,
# held for both formulations against the production int8 forward and
# against themselves through the kernels' plain versions. Like that test,
# phase 13 serves a briefly trained model: with random weights the int8
# network turns a one-ulp difference at level 0 into flipped classes on ~5%
# of the pixels (this script on an H100, PERF.md), because most margins are
# that thin.
RESEARCH_AGREE = 0.995
# The logits are held within MODEL_TOL of their scale on all but 1e-3 of the
# values: a last-bit float difference flips an int8 rounding now and then,
# and one flip moves the logits of the pixels downstream of it by up to ~6%
# of the scale (0.085 at scale 1.47, fused kernels vs their plain versions,
# on an H100, PERF.md).
LOGIT_SHARE = 0.999
SERVE_TRAIN = {"steps": 250, "batch": 4, "lr": 2e-3, "momentum": 0.9}
# K4's int8 skip against its plain version: off by at most 1 on fewer than
# this share of values (an f32 last-bit difference of the two sums' orders
# flips a rint now and then).
INT8_FLIP_SHARE = 1e-3
# The decoder concats of one 16-tile chunk: (skip H=W before the crop, H=W
# after it, C per half), d = 0..3.
CONCATS = [(568, 392, 64), (280, 200, 128), (136, 104, 256), (64, 56, 512)]


def pair_shapes():
    """The pair path's copies in one chunk: K6a pairs the int8 upconv
    output [16,392,392,64]; K6b unpairs the pooled bf16 map [8,284,284,128];
    K6c interleaves the int8 paired skip [8,568,568,128], cropped to 392, with
    the paired upconv output [8,392,392,128]. (shape, dtype) per input."""
    full, crop, c = CONCATS[0]
    half = BATCH_TILES // 2
    return {"pair_batch_channels": [((BATCH_TILES, crop, crop, c), torch.int8)],
            "unpair_batch_channels": [((half, full // 2, full // 2, 2 * c), torch.bfloat16)],
            "interleave_pairs": [((half, full, full, 2 * c), torch.int8),
                                 ((half, crop, crop, 2 * c), torch.int8)]}


def _k6_inputs(name, gen):
    """Random inputs of `pair_shapes()[name]`; interleave's first cropped."""
    from tpu_unet_torch.models import center_crop_or_pad

    out = [torch.randint(-100, 100, shape, generator=gen, device=DEVICE).to(dtype)
           for shape, dtype in pair_shapes()[name]]
    if name == "interleave_pairs":
        out[0] = center_crop_or_pad(out[0], out[1].shape[1:3])
    return out


def _research_fns():
    """{name: wrapper} of the research kernels and K3."""
    from tpu_unet_torch.ops import fused_level0, interleave
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused

    return {"enc0_chain": fused_level0.enc0_chain,
            "concat_quantize": fused_level0.concat_quantize,
            "pair_batch_channels": interleave.pair_batch_channels,
            "unpair_batch_channels": interleave.unpair_batch_channels,
            "interleave_pairs": interleave.interleave_pairs,
            "conv3x3_fused": conv3x3_fused}


def enc0_bound(bsz: int, h: int, w: int, c: int, skip_bytes: int):
    """K4's bound on bf16 x [bsz, h, w, 1]: x, the weights and biases read
    once, the skip and the pooled map written once; conv1's operations at
    the f32 rate and conv2's at the bf16 rate, the larger of the two (they
    run on different units)."""
    ho, wo = h - 4, w - 4
    nbytes = (bsz * h * w * 2 + 9 * c * 2 + 9 * c * c * 2 + 2 * c * 4
              + bsz * ho * wo * c * skip_bytes + bsz * (ho // 2) * (wo // 2) * c * 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(2 * 9 * c * bsz * (h - 2) * (w - 2) / PEAK_OPS_PER_S["f32"],
                2 * 9 * c * c * bsz * ho * wo / PEAK_OPS_PER_S["bf16"]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _enc0_args(bsz, h, w, c, gen):
    x = torch.rand((bsz, h, w, 1), generator=gen, device=DEVICE).to(torch.bfloat16)
    w1 = (torch.randn((3, 3, 1, c), generator=gen, device=DEVICE) * 0.5).to(torch.bfloat16)
    b1 = torch.randn((c,), generator=gen, device=DEVICE) * 0.1
    w2 = (torch.randn((3, 3, c, c), generator=gen, device=DEVICE)
          * math.sqrt(2 / (9 * c))).to(torch.bfloat16)
    b2 = torch.randn((c,), generator=gen, device=DEVICE) * 0.1
    return x, w1, b1, w2, b2


def _cat_halves(bsz, full, crop, c, scale, gen):
    """The decoder's concat inputs: an int8 skip center-cropped from its
    encoder size (a strided view, as on the path) and a bf16 upconv output
    spread past the int8 range at `scale`."""
    from tpu_unet_torch.models import center_crop_or_pad

    skip = torch.randint(-127, 128, (bsz, full, full, c), generator=gen, device=DEVICE,
                         dtype=torch.int8)
    u = (torch.rand((bsz, crop, crop, c), generator=gen, device=DEVICE) * 2.6 - 1.3) * 127 * scale
    return center_crop_or_pad(skip, (crop, crop)), u.to(torch.bfloat16)


@torch.inference_mode()
def phase12_research_kernels():
    """K4, K5 and K6a-c against their plain versions at one 16-tile chunk's
    shapes; returns {name: max abs error}."""
    from tpu_unet_torch.ops.fused_level0 import (_enc0_chain_route_forward, concat_quantize,
                                                 concat_quantize_plain, enc0_chain,
                                                 enc0_chain_plain, enc0_chain_route)
    from tpu_unet_torch.ops.interleave import (interleave_pairs, interleave_pairs_plain,
                                               pair_batch_channels, pair_batch_channels_plain,
                                               unpair_batch_channels,
                                               unpair_batch_channels_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    errs = dict.fromkeys(["enc0_chain", "concat_quantize", "pair_batch_channels",
                          "unpair_batch_channels", "interleave_pairs"], 0.0)
    # K4 as routed (sm90) at every case; the simple route (the first kernel,
    # forced) at the chunk
    k4_cases = [((BATCH_TILES, TILE_IN, TILE_IN), 64, m, q, "sm90")
                for q in (False, True) for m in ("fused", "cols")]
    k4_cases += [((BATCH_TILES, TILE_IN, TILE_IN), 64, "fused", q, "simple") for q in (False, True)]
    k4_cases += [((2, 50, 86), 64, "fused", True, "sm90"),
                 ((2, 50, 86), 16, "fused", False, "sm90"),
                 ((3, 36, 44), 16, "cols", True, "sm90"), ((1, 26, 30), 24, "fused", True, "sm90"),
                 # the strip's edges: Wo 2 (Ho 2), 88, 90, 178; C 8 and 24 leave most
                 # of the wgmma's 64 channel rows zero; 560 tiles do not divide
                 # evenly over the grid, so walks cross images
                 ((1, 6, 6), 8, "fused", True, "sm90"), ((1, 10, 92), 24, "fused", False, "sm90"),
                 ((1, 6, 94), 64, "fused", True, "sm90"), ((2, 10, 182), 64, "cols", False, "sm90"),
                 ((140, 8, 96), 16, "fused", True, "sm90")]
    for (bsz, h, w), c, mode, int8_skip, route in k4_cases:
        args = _enc0_args(bsz, h, w, c, gen)
        ref_bf16, ref_pool = enc0_chain_plain(*args)
        scale = ref_bf16.float().max().item() / 110.0 if int8_skip else 0.0
        ref_skip = enc0_chain_plain(*args, skip_scale=scale)[0] if int8_skip else ref_bf16
        before = (enc0_chain.launches, enc0_chain.sm90_launches)
        if route == "sm90":
            if enc0_chain_route(args[0], c) != "sm90":
                raise AssertionError(f"K4 x[{bsz},{h},{w}] C {c} is not routed to sm90")
            skip, pooled = enc0_chain(*args, skip_scale=scale, pool_mode=mode)
        else:
            skip, pooled = _enc0_chain_route_forward(*args, route, skip_scale=scale)
        torch.cuda.synchronize()
        sm90_in = int(route == "sm90")
        if (enc0_chain.launches, enc0_chain.sm90_launches) != (before[0] + 1,
                                                               before[1] + sm90_in):
            raise AssertionError(f"K4 x[{bsz},{h},{w}] C {c}: not one {route} launch")
        if skip.dtype != ref_skip.dtype or skip.shape != ref_skip.shape or \
                pooled.shape != ref_pool.shape:
            raise AssertionError(f"K4 x[{bsz},{h},{w},1] C {c}: {skip.dtype} "
                                 f"{tuple(skip.shape)}, {tuple(pooled.shape)}")
        parts = [("pooled", pooled, ref_pool)] + [("skip", skip, ref_skip)]
        msg = []
        for label, got, ref in parts:
            d = (got.float() - ref.float()).abs()
            err = d.max().item()
            if got.dtype == torch.int8:
                share = (d > 0).float().mean().item()
                msg.append(f"int8 skip max|err| {err:.0f} on a share {share:.2e}")
                if not (err <= 1 and share < INT8_FLIP_SHARE):
                    raise AssertionError(f"K4 int8 skip differs at x[{bsz},{h},{w}] C {c}")
            else:
                tol = BF16_TOL * max(ref.float().abs().max().item(), 1.0)
                msg.append(f"{label} max|err| {err:.3g} (bound {tol:.3g})")
                errs["enc0_chain"] = max(errs["enc0_chain"], err)
                if not err <= tol:
                    raise AssertionError(f"K4 {label} differs at x[{bsz},{h},{w}] C {c}")
        log(f"phase 12: K4 ({route}) x[{bsz},{h},{w},1] C {c} pool_mode {mode!r} skip "
            f"{'int8' if int8_skip else 'bf16'}: " + ", ".join(msg))
        del args, ref_bf16, ref_pool, ref_skip, skip, pooled

    k5_cases = [(f"dec{d} int8 || bf16", (BATCH_TILES, full, crop, c), True)
                for d, (full, crop, c) in enumerate(CONCATS)]
    k5_cases += [("bf16 || bf16", (BATCH_TILES, *CONCATS[1]), False),
                 ("C 24, int8 || bf16", (2, 40, 30, 24), True),
                 ("C 40, bf16 || bf16", (2, 20, 18, 40), False)]
    for label, (bsz, full, crop, c), int8_skip in k5_cases:
        sk, u = _cat_halves(bsz, full, crop, c, 0.02, gen)
        a = sk if int8_skip else (u * 0.5)
        got = concat_quantize(a, u, 0.02)
        ref = concat_quantize_plain(a, u, 0.02)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        log(f"phase 12: K5 {label} halves [{bsz},{crop},{crop},{c}]: max|err| {err}")
        if not (got.dtype == torch.int8 and torch.equal(got, ref)):
            raise AssertionError(f"K5 differs from its plain version at {label}")
        if not (ref.min().item() == -127 and ref.max().item() == 127):
            raise AssertionError(f"K5 test values miss the clamps at {label}")
        del sk, u, a, got, ref

    def ints(shape, dtype, offset=0):
        buf = torch.randint(-100, 100, (math.prod(shape) + offset,), generator=gen,
                            device=DEVICE).to(dtype)
        return buf[offset:].view(shape)

    pp = pair_batch_channels_plain
    k6_cases = [
        ("pair_batch_channels", "the pair path's shape",
         lambda: (pair_batch_channels, pp, _k6_inputs("pair_batch_channels", gen))),
        ("unpair_batch_channels", "the pair path's shape",
         lambda: (unpair_batch_channels, unpair_batch_channels_plain,
                  _k6_inputs("unpair_batch_channels", gen))),
        ("interleave_pairs", "the pair path's shapes, the first a cropped view",
         lambda: (interleave_pairs, interleave_pairs_plain,
                  _k6_inputs("interleave_pairs", gen))),
        ("pair_batch_channels", "bf16 [4,20,30,5] (byte copies)",
         lambda: (pair_batch_channels, pp, (ints((4, 20, 30, 5), torch.bfloat16),))),
        ("unpair_batch_channels", "int8 [2,9,11,128] off its alignment by 3",
         lambda: (unpair_batch_channels, unpair_batch_channels_plain,
                  (ints((2, 9, 11, 128), torch.int8, offset=3),))),
        ("interleave_pairs", "bf16 [2,7,9,6] (byte copies)",
         lambda: (interleave_pairs, interleave_pairs_plain,
                  (ints((2, 7, 9, 6), torch.bfloat16), ints((2, 7, 9, 6), torch.bfloat16)))),
    ]
    for name, label, make in k6_cases:
        fn, plain, args = make()
        got = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        log(f"phase 12: K6 {name} {label} {[list(a.shape) for a in args]}: equal "
            f"{torch.equal(got, ref)}")
        if not (got.dtype == ref.dtype and torch.equal(got, ref)):
            raise AssertionError(f"K6 {name} differs from its plain version at {label}")
        del args, got, ref
    log(f"phase 12: ok, K5 and K6a-c bit-exact (tolerance 0); K4's bf16 maps within "
        f"{BF16_TOL} of their scale, its int8 skip off by at most 1 on < "
        f"{INT8_FLIP_SHARE} of values, on both routes, each launch's route checked")
    return errs


def _research_engine(model, qp, flags):
    """(ResearchQuantInference under `flags`, with none the production int8
    forward; its TileInference)."""
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant_research import ResearchQuantInference

    qi = ResearchQuantInference(qp, impl="pallas", device=DEVICE, **flags)
    return qi, TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT, apply_fn=qi.apply)


@contextlib.contextmanager
def _plain_research_kernels():
    """The research forward with each of K4, K5 and K6a-c swapped for its
    plain version (which runs on CUDA tensors too): the same formulation,
    without the kernels."""
    from tpu_unet_torch.infer import quant_research
    from tpu_unet_torch.ops import fused_level0, interleave

    plain = {
        "enc0_chain": lambda *a, skip_scale=0.0, **_: fused_level0.enc0_chain_plain(
            *a, skip_scale=skip_scale),
        "concat_quantize": fused_level0.concat_quantize_plain,
        "pair_batch_channels": interleave.pair_batch_channels_plain,
        "unpair_batch_channels": interleave.unpair_batch_channels_plain,
        "interleave_pairs": interleave.interleave_pairs_plain,
    }
    saved = {name: getattr(quant_research, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(quant_research, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(quant_research, name, fn)


def _logit_diff(got, ref):
    """(max |got - ref|, the scale max |ref|, share of logits within
    MODEL_TOL x scale, share of equal argmax, share of equal argmax among
    the pixels whose ref top-2 margin exceeds twice the largest difference,
    share of such pixels)."""
    d = (got - ref).abs()
    err, scale = d.max().item(), ref.abs().max().item()
    same = got.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    return (err, scale, (d <= MODEL_TOL * scale).float().mean().item(),
            same.float().mean().item(),
            same[decided].float().mean().item() if decided.any() else 1.0,
            decided.float().mean().item())


def trained_serving_model(cfg, data):
    """The full-width model (seed 0) trained for SERVE_TRAIN["steps"] steps
    on the serving set's own 16 tiles, as tests/test_quant.py's
    `trained_tiny` is trained before its agreement bars (SGD, class-balance
    weights; through cuDNN), then calibrated as evaluate(quant='int8')
    calibrates. Returns (the model under conv_impl='pallas', its
    QuantParams)."""
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant import build_quant_inference, calibration_batch
    from tpu_unet_torch.losses.bce import weighted_bce_with_logits
    from tpu_unet_torch.losses.weights import class_balance
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.pad import reflect_pad

    train = UNet(dataclasses.replace(cfg, conv_impl="xla"),
                 generator=torch.Generator().manual_seed(0)).to(DEVICE)
    engine = TileInference(train, IMAGE, IMAGE, tile_out=TILE_OUT)
    p = engine.plan
    tiles = engine._flat_tiles(engine._on_device(data.images, torch.float32))
    labels = torch.from_numpy((data.targets > 127).astype(np.float32)).to(DEVICE)
    # the labels reflected as the input tiles are, cut at the tiles' outputs
    canvas = reflect_pad(labels, ((0, p.canvas_h - p.image_h), (0, p.canvas_w - p.image_w)))
    to_h, to_w = p.tile_out_hw
    gt = torch.stack([canvas[:, y:y + to_h, x:x + to_w] for y, x in p.out_origins], dim=1)
    gt = gt.reshape(-1, to_h, to_w).round().long()
    opt = torch.optim.SGD(train.parameters(), lr=SERVE_TRAIN["lr"],
                          momentum=SERVE_TRAIN["momentum"])
    n, b = tiles.shape[0], SERVE_TRAIN["batch"]
    losses = []
    t0 = time.perf_counter()
    for step in range(SERVE_TRAIN["steps"]):
        idx = [(step * b + k) % n for k in range(b)]
        loss = weighted_bce_with_logits(train(tiles[idx]), gt[idx], class_balance(gt[idx]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"serving-model training diverged: {losses}")
    model = UNet(cfg).to(DEVICE)
    model.load_state_dict(train.state_dict())
    qp = build_quant_inference(model, calibration_batch(list(data.images)), impl="pallas").qp
    with torch.inference_mode():
        logits = model(tiles)
    top2 = logits.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).median().item()
    log(f"phase 13: trained the serving model {SERVE_TRAIN} in {time.perf_counter() - t0:.1f} "
        f"s: loss {losses[0]:.4f} -> {losses[-1]:.4f}; bf16 logits' median top-2 margin "
        f"{margin:.3f}")
    del train, opt, tiles
    return model, qp


def phase13_serve_research(cfg, data):
    """The research int8 forward at full width through evaluate_batch, in
    both formulations, on a briefly trained model: launches per chunk and
    finite metrics; class maps against the production int8 forward's; the
    logits of the chunk against the same formulation through the kernels'
    plain versions and against the production forward. Returns (model, its
    QuantParams, {formulation: launches})."""
    model, qp = trained_serving_model(cfg, data)
    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)
    prod_qi, prod = _research_engine(model, qp, {})
    n_tiles = len(data) * prod.plan.num_tiles
    n_chunks = -(-n_tiles // prod.batch_tiles)
    _, prod_preds = prod.evaluate_batch(images, lab)
    tiles = prod._flat_tiles(prod._on_device(data.images, torch.float32))
    prod_logits = prod_qi.apply(tiles)
    fns = _research_fns()
    launches, failed = {}, []
    for key, (flags, want) in RESEARCH.items():
        qi, engine = _research_engine(model, qp, flags)
        for fn in fns.values():
            fn.launches = 0
        fns["conv3x3_fused"].sm90_launches = fns["enc0_chain"].sm90_launches = 0
        ms, preds = engine.evaluate_batch(images, lab)
        torch.cuda.synchronize()
        launches[key] = {name: fn.launches for name, fn in fns.items() if fn.launches}
        for name in ("conv3x3_fused", "enc0_chain"):
            if fns[name].launches:
                launches[key][f"{name}_sm90"] = fns[name].sm90_launches
        agree = (preds == prod_preds).float().mean().item()
        ms = ms.cpu().numpy()
        log(f"phase 13: research {key} {flags}: evaluate_batch of {n_tiles} tiles in "
            f"{n_chunks} chunk(s): launches {launches[key]}; (iou, pixel error) "
            f"{ms.tolist()}; class maps equal the production int8 forward's on {agree:.6f} "
            f"of the pixels")
        # K3 and K4 all on their sm90 routes
        want = {**want, **{f"{name}_sm90": want[name] for name in ("conv3x3_fused", "enc0_chain")
                           if name in want}}
        if launches[key] != {name: n * n_chunks for name, n in want.items()}:
            failed.append(f"{key}: launches {launches[key]}, want {want} x {n_chunks}")
        if not (np.isfinite(ms[:, 1]).all() and agree >= RESEARCH_AGREE):
            failed.append(f"{key}: metrics {ms.tolist()}, agreement {agree}")
        logits = qi.apply(tiles)
        with _plain_research_kernels():
            plain_logits = qi.apply(tiles)
        torch.cuda.synchronize()
        if not torch.isfinite(logits).all():
            failed.append(f"{key}: non-finite logits")
        for label, ref in (("the same formulation through the plain versions", plain_logits),
                           ("the production int8 forward", prod_logits)):
            err, scale, within, same, same_decided, decided = _logit_diff(logits, ref)
            log(f"phase 13: {key} logits on {tiles.shape[0]} tiles vs {label}: max|err| "
                f"{err:.4g} (scale {scale:.4g}); within {MODEL_TOL} x scale on {within:.6f} "
                f"(bar {LOGIT_SHARE}); argmax equal on {same:.6f} (bar {RESEARCH_AGREE}), and "
                f"on {same_decided:.6f} of the {decided:.6f} whose margin exceeds 2 x max|err|")
            # the fused formulation rounds level 0 elsewhere than production
            # (the int8 skip from the f32 conv output, the concat's multiply by
            # the reciprocal scale): its logits' distance is reported
            exact = not (key == "fused" and ref is prod_logits)
            if not ((within >= LOGIT_SHARE or not exact) and same >= RESEARCH_AGREE
                    and same_decided == 1.0):
                failed.append(f"{key} logits vs {label}")
    if failed:
        raise AssertionError(f"phase 13 failed: {failed}")
    log("phase 13: ok")
    return model, qp, launches


def _per_chunk(cases):
    """{'kernel'|'plain'|'library': ms summed over `cases` of (kernel, plain,
    library) callables}, each timed with CUDA events after a warm-up."""
    total = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    for fns in cases:
        for key, fn, reps in zip(total, fns, (10, 3, 10)):
            total[key] += time_ms(fn, DEVICE, reps)
    return total


def phase14_time_research(model, data, qp):
    """tiles/s of the two formulations and of production int8 'pallas', in
    turns; each research kernel's ms per chunk against its plain version and
    the library route it replaces; returns (tiles/s, {name: times})."""
    from tpu_unet_torch.ops.conv_tiles import quantize_activations
    from tpu_unet_torch.ops.fused_level0 import (_enc0_chain_route_forward, concat_quantize,
                                                 concat_quantize_plain, enc0_chain,
                                                 enc0_chain_plain)
    from tpu_unet_torch.ops.interleave import (interleave_pairs, interleave_pairs_plain,
                                               pair_batch_channels, pair_batch_channels_plain,
                                               unpair_batch_channels,
                                               unpair_batch_channels_plain)
    from tpu_unet_torch.probes.mosaic_probe import _library_level0

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)
    engines = {"int8 'pallas'": _research_engine(model, qp, {})[1]}
    for key, (flags, _) in RESEARCH.items():
        engines[f"research {key}"] = _research_engine(model, qp, flags)[1]
    n_tiles = len(data) * engines["int8 'pallas'"].plan.num_tiles
    times = {k: [] for k in engines}
    for key in list(engines) + list(reversed(engines)):
        times[key].append(time_ms(lambda: engines[key].evaluate_batch(images, lab), DEVICE, 3))
    tiles_s = {}
    for key, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[key] = n_tiles / (ms / 1e3)
        tiles_s[f"{key} ms"] = ms
        log(f"phase 14: evaluate_batch {key}: {ms:.2f} ms for {n_tiles} tiles of "
            f"{TILE_IN}^2 = {tiles_s[key]:.1f} tiles/s (runs {[round(t, 3) for t in ts]})")
    n = 3
    for key in list(engines)[1:]:
        window, busy, groups, top = _profile(
            lambda r: engines[key].evaluate_batch(images, lab), n)
        tiles_s[f"{key} profiled_idle_share"] = 1.0 - busy / window
        log(f"phase 14: profile of {n} evaluate_batch calls {key}: window {window / n:.3f} "
            f"ms/call, device busy {busy / n:.3f} ms/call, idle share "
            f"{1.0 - busy / window:.4f}; by group (ms/call): "
            + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items() if ms))
        for name, ms in top:
            log(f"phase 14:   {ms / n:9.3f} ms/call  {name[:110]}")
        tiles_s[f"{key} profiled_ms_per_call"] = {
            "device_busy": busy / n, **{g: ms / n for g, ms in groups.items()}}
        _require_groups(groups, "K3 conv3x3_fused", *(
            ("K4 enc0_chain", "K5 concat_quantize") if key == "research fused"
            else ("K6 interleave_copy",)))
    del engines

    s_cat = qp.scales["dec0_conv1:cat"]
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    out = {}
    with torch.inference_mode():
        x = torch.rand((BATCH_TILES, TILE_IN, TILE_IN, 1), generator=gen,
                       device=DEVICE).to(torch.bfloat16)
        w = [t.to(DEVICE, dt) for n in ("enc0_conv1", "enc0_conv2")
             for t, dt in zip(qp.fconv[n], (torch.bfloat16, torch.float32))]

        # K4 as serving routes it (sm90), its first kernel (the forced simple
        # route) and level 0 through the library (two cuDNN convs in TF32 on
        # bf16 values, the int8 capture of the skip and the pool) in turns;
        # then the plain version
        t = _in_turns({"kernel": lambda: enc0_chain(x, *w, skip_scale=s_cat),
                       "simple": lambda: _enc0_chain_route_forward(x, *w, "simple",
                                                                   skip_scale=s_cat),
                       "library": lambda: _library_level0(x, *w, s_cat)})
        t["plain"] = time_ms(lambda: enc0_chain_plain(x, *w, skip_scale=s_cat), DEVICE, 3)
        t["bound"], t["bound_by"] = enc0_bound(BATCH_TILES, TILE_IN, TILE_IN,
                                               w[0].shape[-1], 1)
        out["enc0_chain"] = t
        del x, w

        cases, nbytes, nq = [], 0, 0
        halves = [_cat_halves(BATCH_TILES, full, crop, c, s_cat, gen)
                  for full, crop, c in CONCATS]
        for sk, u in halves:
            cases.append((lambda sk=sk, u=u: concat_quantize(sk, u, s_cat),
                          lambda sk=sk, u=u: concat_quantize_plain(sk, u, s_cat),
                          lambda sk=sk, u=u: torch.cat(
                              [sk, quantize_activations(u, s_cat)], dim=-1)))
            nbytes += sk.numel() * 1 + u.numel() * 2 + 2 * u.numel()
            nq += u.numel()
        t = _per_chunk(cases)
        t["bound"], t["bound_by"] = bound(nbytes, 2 * nq, "f32")
        out["concat_quantize"] = t
        del cases, halves

        for name, fn, plain in (
                ("pair_batch_channels", pair_batch_channels, pair_batch_channels_plain),
                ("unpair_batch_channels", unpair_batch_channels, unpair_batch_channels_plain),
                ("interleave_pairs", interleave_pairs, interleave_pairs_plain)):
            args = _k6_inputs(name, gen)
            # the plain version is the library route: one torch.cat of slices
            t = _per_chunk([(lambda: fn(*args), lambda: plain(*args), lambda: plain(*args))])
            moved = 2 * sum(a.numel() * a.element_size() for a in args)
            t["bound"], t["bound_by"] = bound(moved, 0, "f32")
            out[name] = t
            del args
    for name, t in out.items():
        log(f"phase 14: {name} per {BATCH_TILES}-tile chunk: kernel {t['kernel']:.4f} ms"
            + (f" (sm90; simple route {t['simple']:.4f} ms, in turns)" if "simple" in t else "")
            + f", plain {t['plain']:.4f} ms, library {t['library']:.4f} ms, bound "
            f"{t['bound']:.4f} ms ({t['bound_by']})")
    return tiles_s, out


# The phase-packed level 0 (phases 15-17): `int8-phase` serving runs the
# packed enc0_conv2 and dec0_conv2 through the fused k x k kernel and 13 of
# the 14 int8 convs through K3 (the split dec0_conv1 takes the library
# accumulate), per chunk.
PHASE_LAUNCHES = {"conv_kxk_fused": 2, "conv3x3_fused": 13}


def kxk_shapes(cfg, tile_in: int = TILE_IN, tile_out: int = TILE_OUT):
    """(layer, packed input H=W, Cin, Cout) of the two packed 2x2 int8 convs
    of a tile_in x tile_in tile: at 572, enc0_conv2 (s2d 286 -> 285 -> 284)
    and dec0_conv2 (packed up0 196 -> 195 -> 194 = 388 / 2)."""
    c = 4 * cfg.widths[0]
    return [("enc0_conv2", tile_in // 2 - 1, c, c), ("dec0_conv2", tile_out // 2 + 1, c, c)]


def kxk_cost(batch: int, s: int, k: int, cin: int, cout: int):
    """(bytes, operations) of one fused int8 k x k conv of x [batch, s, s,
    cin]: x, w, alpha and beta read once, the int8 output written once."""
    so = s - k + 1
    return (batch * s * s * cin + k * k * cin * cout + 8 * cout + batch * so * so * cout,
            2 * batch * so * so * k * k * cin * cout)


# The k x k kernel's loop edges: Cin 48, Cout 48; M off the 128 x 64 block;
# 3x3 at Cin 16; a part-filled 128-channel K step (Cin 1040).
KXK_LOOP_EDGES = [(2, (1, 9, 13, 48), 48), (2, (2, 37, 45, 64), 64), (3, (1, 7, 50, 16), 16),
                  (3, (1, 9, 12, 1040), 1024)]


@torch.inference_mode()
def phase15_kxk_vs_plain(cfg) -> float:
    """The fused k x k kernel as routed and through the forced simple route
    against its plain version, bit for bit, at the path's packed shapes
    (batch 2, the sm90 loop), a 3x3 shape through conv_rows3_col, the loop's
    edge shapes, ragged, odd-Cin and misaligned cases (the simple route);
    then against the library route at the full 16-tile packed shapes."""
    from tpu_unet_torch.ops.conv_kxk import (_conv_kxk_route_forward, conv2x2_fused,
                                             conv_kxk_fused, conv_kxk_fused_plain,
                                             conv_kxk_route, conv_rows3_col)
    from tpu_unet_torch.ops.conv_tiles import conv3x3_int8_xla

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    cases = [(name, 2, (2, s, s, cin), cout, 0, "sm90") for name, s, cin, cout in kxk_shapes(cfg)]
    cases += [("3x3 (probe section 1, rows cut)", 3, (2, 34, 762, 128), 128, 0, "sm90")]
    cases += [("loop edge", k, shape, cout, 0, "sm90") for k, shape, cout in KXK_LOOP_EDGES]
    cases += [("ragged, Cin 24", 2, (1, 9, 13, 24), 40, 0, "simple"),
              ("misaligned", 2, (2, 10, 12, 32), 16, 3, "simple"),
              ("3x3, K 27", 3, (1, 7, 9, 3), 5, 0, "simple")]
    routes = {"sm90": 0, "simple": 0}
    for label, k, shape, cout, offset, want in cases:
        x, w, alpha, beta = _k3_inputs(shape, cout, torch.int8, gen, offset, k)
        fn = conv2x2_fused if k == 2 else conv_rows3_col
        sm90 = conv_kxk_fused.sm90_launches
        got = fn(x, w, alpha, beta, cout_tile=min(cout, 256) if k == 2 else None)
        took = "sm90" if conv_kxk_fused.sm90_launches > sm90 else "simple"
        routes[took] += 1
        if not took == want == conv_kxk_route(x, w):
            raise AssertionError(f"the k x k kernel at {label} took {took}, want {want}")
        simple = _conv_kxk_route_forward(x, w, alpha, beta, "simple")
        ref = conv_kxk_fused_plain(x, w, alpha, beta)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        share = (ref > 0).float().mean().item()
        log(f"phase 15: k x k {label:32s} {k}x{k} x{list(shape)} -> {cout} via "
            f"{fn.__name__} ({took}): max|err| {err} vs plain; simple route equal "
            f"{torch.equal(simple, ref)}; nonzero share {share:.3f}")
        if not (got.dtype == torch.int8 and torch.equal(got, ref) and torch.equal(simple, ref)):
            raise AssertionError(f"the k x k kernel differs from its plain version at {label}")
        if not 0.0 < share < 1.0:
            raise AssertionError(f"degenerate k x k test outputs at {label}")
        del x, w, got, simple, ref
    for name, s, cin, cout in kxk_shapes(cfg):
        x, w, alpha, beta = _k3_inputs((BATCH_TILES, s, s, cin), cout, torch.int8, gen, k=2)
        got = conv_rows3_col(x, w, alpha, beta)         # as int8-phase serving calls it
        lib = conv3x3_int8_xla(x, w, alpha, beta, "int8")
        torch.cuda.synchronize()
        log(f"phase 15: k x k {name} x[{BATCH_TILES},{s},{s},{cin}] -> {cout}: equal to the "
            f"library route {torch.equal(got, lib)}")
        if not torch.equal(got, lib):
            raise AssertionError(f"the k x k kernel differs from the library route at {name}")
        del x, w, got, lib
    log(f"phase 15: ok, the k x k kernel bit-exact (tolerance 0) on both routes against its "
        f"plain version and the library route ({routes['sm90']} launches on the sm90 loop, "
        f"{routes['simple']} on the simple kernel)")
    return 0.0


def phase16_serve_int8_phase(cfg, model, data, qp):
    """evaluate(quant='int8-phase', quant_path=...) at full width on the
    model phase 13 trained: launches per chunk under 'pallas' and 'xla', the
    .npz round trip, every stage 'pallas' vs 'xla' bit for bit, and class
    maps against the production int8 forward (`qp`). Returns (the phase
    QuantParams, {path: launches}, agreement)."""
    from tpu_unet_torch.infer import TileInference, evaluate
    from tpu_unet_torch.infer.quant import QuantInference, default_quant_names, load_quant_params
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_kxk import conv_kxk_fused
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused

    fns = {"conv_kxk_fused": conv_kxk_fused, "conv3x3_fused": conv3x3_fused}
    launch_keys = list(fns) + [f"{name}_sm90" for name in fns]
    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(DEVICE)
    xla.load_state_dict(model.state_dict())
    engine = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT)
    n_tiles = len(data) * engine.plan.num_tiles
    n_chunks = -(-n_tiles // engine.batch_tiles)
    qpath = os.path.join(HERE, "build", "chip_smoke_int8_phase.npz")
    if os.path.exists(qpath):
        os.remove(qpath)
    results, launches, failed = [], {}, []
    for run, m in (("'pallas', calibrated and saved", model),
                   ("'pallas', served from the .npz", model),
                   ("'xla', served from the .npz", xla)):
        for fn in fns.values():
            fn.launches = fn.sm90_launches = 0
        t0 = time.perf_counter()
        results.append(evaluate(m, data, tile_out=TILE_OUT, verbose=False, quant="int8-phase",
                                quant_path=qpath))
        torch.cuda.synchronize()
        launches[run] = {**{name: fn.launches for name, fn in fns.items()},
                         **{f"{name}_sm90": fn.sm90_launches for name, fn in fns.items()}}
        log(f"phase 16: evaluate(quant='int8-phase') {run} in {time.perf_counter() - t0:.2f} "
            f"s: launches {launches[run]} for {n_tiles} tiles in {n_chunks} chunk(s); "
            f"{json.dumps(results[-1])}")
        # every launch on the sm90 loop
        want = ({name: PHASE_LAUNCHES[name.removesuffix("_sm90")] * n_chunks
                 for name in launch_keys} if m is model else dict.fromkeys(launch_keys, 0))
        if launches[run] != want:
            failed.append(f"{run}: launches {launches[run]}, want {want}")
    first, second, third = ({k: v for k, v in r.items() if k != "seconds"} for r in results)
    if not all(np.isfinite(first[k]) for k in ("iou_mean", "pe_mean")):
        failed.append(f"int8-phase evaluate() result {first}")
    if not first == second == third:
        failed.append(f"served from the .npz: {second} ('pallas'), {third} ('xla'); "
                      f"calibrated: {first}")
    qp_phase = load_quant_params(qpath)
    if qp_phase.qnames != default_quant_names(cfg):
        failed.append(f"the .npz holds int8 convs {sorted(qp_phase.qnames)}")

    qis = {impl: QuantInference(qp_phase, impl=impl, phase_level0="int8", device=DEVICE)
           for impl in ("pallas", "xla")}
    tiles = engine._flat_tiles(engine._on_device(data.images[:1], torch.float32))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the float layers run twice
    n_int8 = 0
    for stage in QUANT_STAGES + [None]:
        got = qis["pallas"].apply(tiles, stop_after=stage)
        n_int8 += got.dtype == torch.int8
        if not torch.equal(got, qis["xla"].apply(tiles, stop_after=stage)):
            failed.append(f"QuantInference int8-phase 'pallas' and 'xla' differ at {stage}")
    torch.backends.cudnn.deterministic = deterministic
    log(f"phase 16: int8-phase 'pallas' (the k x k kernel and K3) and 'xla' (library) "
        f"equal at all {len(QUANT_STAGES)} stages ({n_int8} int8; level 0's packed) and the "
        f"logits, on image 0's {tiles.shape[0]} tiles: {not failed}")

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)
    preds = {}
    for key, q in (("int8-phase", qis["pallas"]),
                   ("int8", QuantInference(qp, impl="pallas", device=DEVICE))):
        preds[key] = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT,
                                   apply_fn=q.apply).evaluate_batch(images, lab)[1]
    agree = (preds["int8-phase"] == preds["int8"]).float().mean().item()
    log(f"phase 16: class maps int8-phase vs production int8 on the trained model: equal on "
        f"{agree:.6f} of the pixels (bar {RESEARCH_AGREE})")
    if agree < RESEARCH_AGREE:
        failed.append(f"int8-phase class maps agree with production int8 on {agree}")
    if failed:
        raise AssertionError(f"phase 16 failed: {failed}")
    log("phase 16: ok")
    return qp_phase, launches["'pallas', calibrated and saved"], agree


def phase17_time_phase(cfg, model, data, qp, qp_phase):
    """int8-phase serving times ('pallas', 'xla') beside production int8
    'pallas', in turns, and a profile; the k x k kernel per chunk against
    its plain version and the library route; a DIC-HeLa train step of the
    phase model against the plain one ('xla'); the deep-shootout probe.
    Returns (tiles/s, kernel times, train step ms, probe records, probe
    launches)."""
    from tpu_unet_torch.config import OptimConfig
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant import QuantInference
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_kxk import (_conv_kxk_route_forward, conv_kxk_fused,
                                             conv_kxk_fused_plain, conv_kxk_route,
                                             conv_rows3_col)
    from tpu_unet_torch.ops.conv_tiles import conv3x3_int8_xla, sm90_block
    from tpu_unet_torch.probes import deep_shootout
    from tpu_unet_torch.train import make_optimizer

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)

    def make(q, **kw):
        fn = QuantInference(q, device=DEVICE, **kw).apply
        return TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT, apply_fn=fn)

    engines = {"int8-phase 'pallas'": make(qp_phase, impl="pallas", phase_level0="int8"),
               "int8-phase 'xla'": make(qp_phase, impl="xla", phase_level0="int8"),
               "int8 'pallas'": make(qp, impl="pallas")}
    n_tiles = len(data) * engines["int8 'pallas'"].plan.num_tiles
    times = {k: [] for k in engines}
    for key in list(engines) + list(reversed(engines)):
        times[key].append(time_ms(lambda: engines[key].evaluate_batch(images, lab), DEVICE, 3))
    tiles_s = {}
    for key, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[key] = n_tiles / (ms / 1e3)
        log(f"phase 17: evaluate_batch {key}: {ms:.2f} ms for {n_tiles} tiles of "
            f"{TILE_IN}^2 = {tiles_s[key]:.1f} tiles/s (runs {[round(t, 3) for t in ts]})")
    n = 3
    window, busy, groups, top = _profile(
        lambda r: engines["int8-phase 'pallas'"].evaluate_batch(images, lab), n)
    tiles_s["int8-phase 'pallas' profiled_idle_share"] = 1.0 - busy / window
    log(f"phase 17: profile of {n} evaluate_batch calls int8-phase 'pallas': window "
        f"{window / n:.3f} ms/call, device busy {busy / n:.3f} ms/call, idle share "
        f"{1.0 - busy / window:.4f}; by group (ms/call): "
        + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items() if ms))
    for name, ms in top:
        log(f"phase 17:   {ms / n:9.3f} ms/call  {name[:110]}")
    tiles_s["int8-phase 'pallas' profiled_ms_per_call"] = {
        "device_busy": busy / n, **{g: ms / n for g, ms in groups.items()}}
    _require_groups(groups, "K3 conv3x3_fused", "k x k conv_kxk_fused")
    del engines

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    kxk = dict.fromkeys(TURN_KEYS + ("plain",), 0.0)
    per_shape = {}
    nbytes = ops = 0
    with torch.inference_mode():
        for name, s, cin, cout in kxk_shapes(cfg):
            x, w, alpha, beta = _k3_inputs((BATCH_TILES, s, s, cin), cout, torch.int8, gen, k=2)
            t = _in_turns({
                "kernel": lambda: conv_rows3_col(x, w, alpha, beta),   # as serving calls it
                "simple": lambda: _conv_kxk_route_forward(x, w, alpha, beta, "simple"),
                "library": lambda: conv3x3_int8_xla(x, w, alpha, beta, "int8")})
            t["plain"] = time_ms(lambda: conv_kxk_fused_plain(x, w, alpha, beta), DEVICE, 2)
            t["route"], t["block"] = conv_kxk_route(x, w), list(sm90_block(cout))
            b, o = kxk_cost(BATCH_TILES, s, 2, cin, cout)
            t["bound"], t["bound_by"] = bound(b, o, "int8")
            log(f"phase 17: k x k {name} x[{BATCH_TILES},{s},{s},{cin}]->{cout}: "
                + _turns_line(t, o))
            for key in kxk:
                kxk[key] += t[key]
            per_shape[name] = t
            nbytes, ops = nbytes + b, ops + o
            del x, w, alpha, beta
    kxk["bound"], kxk["bound_by"] = bound(nbytes, ops, "int8")
    kxk["per_shape"] = per_shape
    log(f"phase 17: the two packed convs of one {BATCH_TILES}-tile chunk ({ops / 1e12:.3f} T "
        f"int8 ops): kernel {kxk['kernel']:.3f} ms ({ops / kxk['kernel'] / 1e9:.1f} TOP/s), "
        f"the simple kernel {kxk['simple']:.3f} ms, library {kxk['library']:.3f} ms, plain "
        f"{kxk['plain']:.3f} ms, bound {kxk['bound']:.3f} ms ({kxk['bound_by']})")

    parts_in = _train_parts()
    models = {}
    for key, phase in (("phase_level0", True), ("plain", False)):
        m = UNet(dataclasses.replace(cfg, conv_impl="xla", phase_level0=phase),
                 generator=torch.Generator().manual_seed(0)).to(DEVICE)
        models[key] = (m, make_optimizer(m.parameters(), OptimConfig()))
    step_ms = {k: [] for k in models}
    for key in ("phase_level0", "plain", "plain", "phase_level0"):
        step_ms[key].append(time_ms(lambda r=iter(range(100)): _train_step(
            *models[key], parts_in, next(r)), DEVICE, 4))
    train_ms = {k: sum(v) / len(v) for k, v in step_ms.items()}
    log(f"phase 17: DIC-HeLa train step (bf16, batch 2, 572^2, conv_impl 'xla'): "
        + ", ".join(f"{k} {v:.3f} ms (runs {[round(t, 3) for t in step_ms[k]]})"
                    for k, v in train_ms.items()))
    window, busy, groups, top = _profile(
        lambda r: _train_step(*models["phase_level0"], parts_in, r), n)
    train_ms["phase_level0 profiled_idle_share"] = 1.0 - busy / window
    log(f"phase 17: profile of {n} phase_level0 train steps: window {window / n:.3f} ms/step, "
        f"device busy {busy / n:.3f} ms/step, idle share {1.0 - busy / window:.4f}; by group "
        "(ms/step): " + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items() if ms))
    for name, ms in top:
        log(f"phase 17:   {ms / n:9.3f} ms/step  {name[:110]}")
    del models

    torch.cuda.empty_cache()
    conv_kxk_fused.launches = 0
    probe = deep_shootout.run(batch=BATCH_TILES)
    probe_launches = conv_kxk_fused.launches
    bad = [r for r in probe if r["mismatch"]]
    if bad:
        raise AssertionError(f"deep-shootout routes differ from the library route: {bad}")
    log(f"phase 17: deep-shootout probe, batch {BATCH_TILES}: {len(probe)} routes, every "
        f"mismatch 0; {probe_launches} k x k launches")
    return tiles_s, kxk, train_ms, probe, probe_launches


# The last probes (phases 18-19): the gather probe's warp canvas and the
# enc0 chain's stage kernels at K4's serving chunk.
GATHER_S = 572
# calls per timing turn of the row gather: a call at C 2 is a few µs of
# device work behind ~15-20 µs of host work, whose jitter a short run shows
GATHER_REPS = 200
ENC0_C = 64


def gather_cost(src, idx):
    """(bytes, operations) of gathering the rows `idx` of f32 `src` [N, C]:
    the 32-byte sectors that the distinct in-range rows cover, each read
    once (a row drawn twice, or a source that fits in L2, costs one read),
    4C bytes written and the index read once per output row."""
    n, c = src.shape
    i = idx.long()
    rows = torch.unique(torch.where(i < 0, i + n, i)[(i >= -n) & (i < n)])
    start = src.data_ptr() % 32 + rows * (4 * c)
    first, last = start // 32, (start + 4 * c - 1) // 32
    span = torch.arange(int((last - first).max()) + 1 if rows.numel() else 0,
                        device=idx.device)
    sectors = first[:, None] + span
    n_sectors = torch.unique(sectors[sectors <= last[:, None]]).numel()
    return 32 * n_sectors + idx.numel() * (4 * c + idx.element_size()), 0


def _exact(got, ref) -> float:
    """Max |got - ref| over the values where both are finite; raises unless
    the two are equal bit for bit, NaN in the same places."""
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    ok = torch.isfinite(ref)
    return (got[ok] - ref[ok]).abs().max().item() if ok.any() else 0.0


LAUNCH_PATH_CALLS = 10_000


def _us_per_call(fn, n: int = LAUNCH_PATH_CALLS) -> float:
    """Host microseconds per call of `fn` over `n` calls (perf_counter_ns)."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    us = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return us


def launch_path(gather, src, idx):
    """Host microseconds per call of each step of the row gather's launch
    path at `src`, `idx`, over 10,000 calls: the sequence every wrapper ran
    before the launch helper (rebuilt here only to time it: a device
    context, a `torch.cuda.Stream` object, the library behind its lock) and
    the helper's, then both whole wrappers."""
    import threading

    from tpu_unet_torch.ops import _build

    lib = _build.load_library()
    fn = lib.row_gather_f32
    dev = src.device
    n, c = src.shape
    out = torch.empty((idx.shape[0], c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (src.data_ptr(), idx.data_ptr(), 0, out.data_ptr(), n, idx.shape[0], c,
            src.stride(0), 0)
    lock = threading.Lock()

    def locked_library():
        with lock:
            return _build._lib

    def device_context():
        with torch.cuda.device(dev):
            pass

    def old_on_cuda(*ts):
        d = ts[0].device
        if any(t.device != d for t in ts) or d.type not in ("cpu", "cuda"):
            raise AssertionError(d)
        return d.type == "cuda"

    def checks(on_cuda):
        gather._check(src, idx)
        on_cuda(src, idx)
        if src.stride(1) != 1 or src.stride(0) < c:
            raise AssertionError
        idx.contiguous()

    def arguments():
        return (src.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(),
                int(c % 4 == 0 and src.stride(0) % 4 == 0 and src.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0))

    def old_wrapper():
        checks(old_on_cuda)
        o = torch.empty((idx.shape[0], c), dtype=torch.float32, device=dev)
        a = arguments()
        with torch.cuda.device(dev):
            st = torch.cuda.current_stream(dev).cuda_stream
            rc = locked_library().row_gather_f32(a[0], a[1], a[2], o.data_ptr(), n,
                                                 idx.shape[0], c, src.stride(0), a[4], st)
        if rc != 0:
            raise RuntimeError(rc)
        return o

    steps = {
        "old": {
            "argument checks": lambda: checks(old_on_cuda),
            "torch.empty": lambda: torch.empty((idx.shape[0], c), dtype=torch.float32,
                                               device=dev),
            "pointers and flags": arguments,
            "enter and leave torch.cuda.device": device_context,
            "current_stream(...).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
            "load_library() behind its lock": locked_library,
            "ctypes call (launches the kernel)": lambda: fn(*args, stream),
            "whole wrapper": old_wrapper},
        "new": {
            "argument checks": lambda: checks(lambda *ts: gather._on_cuda("row_gather", *ts)),
            "src.new_empty": lambda: src.new_empty((idx.shape[0], c)),
            "pointers and flags": arguments,
            "current device (torch._C._cuda_getDevice)": _build._current_device,
            "raw stream (torch._C._cuda_getCurrentRawStream)":
                lambda: _build._raw_stream(dev.index),
            "load_library() without the lock": _build.load_library,
            "_build.launch (launches the kernel)": lambda: _build.launch(
                "row_gather", fn, dev.index, *args, shapes=(("src", src), ("idx", idx))),
            "whole wrapper (ops.gather.row_gather)": lambda: gather.row_gather(src, idx)},
    }
    us = {}
    for path in ("old", "new", "new", "old"):                      # in turns
        for step, f in steps[path].items():
            us.setdefault(path, {}).setdefault(step, []).append(_us_per_call(f))
    us = {path: {k: sum(v) / len(v) for k, v in d.items()} for path, d in us.items()}
    for path, d in us.items():
        log(f"phase 18: launch path ({path}), host us per call over {LAUNCH_PATH_CALLS} calls "
            f"at src {list(src.shape)}: " + ", ".join(f"{k} {v:.2f}" for k, v in d.items()))
    return us


@torch.inference_mode()
def phase18_gather():
    """The row-gather kernel against its plain version, bit for bit, at the
    gather probe's shapes, ragged C, a misaligned view, int64 indices and
    negative and out-of-range ones; its times at the probe's 327,184
    points against torch.index_select and the bound; the gather probe.
    Returns (max abs error, times, probe records, probe launches)."""
    from tpu_unet_torch.ops import gather
    from tpu_unet_torch.probes import gather_probe

    gen = torch.Generator(device=DEVICE).manual_seed(18)
    s = GATHER_S
    n_pts = s * s

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    def ints(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=gen, device=DEVICE, dtype=dtype)

    idx = ints(0, n_pts - s - 2, n_pts)
    buf = rand(4096 * 128 + 1)
    cases = [(f"section 1, {n_pts} points, C {c}", rand(n_pts, c), idx) for c in (2, 8, 128)]
    img = rand(s, s)
    cases += [(f"section 2, {k * s} rows of [{s},{s}]", img, ints(0, s - 1, k * s))
              for k in (1, 2)]
    srcp = rand(4096, 128)
    cases += [(f"sections 3-4, {m} rows of [4096,128]", srcp, ints(0, 4096, m))
              for m in (128, 1024)]
    cases += [(f"ragged C {c}", rand(4096, c), ints(0, 4096, 5000)) for c in (1, 3, 5)]
    cases += [("misaligned src view [4096,128] (+4 bytes)", buf[1:].view(4096, 128),
               ints(0, 4096, 3000)),
              ("int64 indices, C 8", rand(4096, 8), ints(0, 4096, 3000, torch.int64)),
              ("negative and out-of-range indices, C 8", rand(4096, 8),
               ints(-4196, 4196, 3000)),
              ("negative and out-of-range int64 indices, C 3", rand(4096, 3),
               ints(-4196, 4196, 3000, torch.int64))]
    err = 0.0
    for label, src, i in cases:
        got = gather.row_gather(src, i)
        ref = gather.row_gather_plain(src, i)
        torch.cuda.synchronize()
        e = _exact(got, ref)
        err = max(err, e)
        log(f"phase 18: row_gather {label}: src {list(src.shape)}, idx {list(i.shape)} "
            f"{str(i.dtype)[6:]}: equal to the plain version (NaN share "
            f"{torch.isnan(ref[:, 0]).float().mean().item():.3f})")
        del got, ref
    times = {}
    for c in (2, 128):
        src = rand(n_pts, c)
        fns = {"kernel": lambda: gather.row_gather(src, idx),
               "library": lambda: torch.index_select(src, 0, idx)}
        runs = {k: [] for k in fns}
        device = {k: [] for k in fns}
        for key in ("kernel", "library", "library", "kernel"):        # in turns
            runs[key].append(time_ms(fns[key], DEVICE, GATHER_REPS))
            # a call this small can be bound by the host: the device's own
            # time per call, from the profiler
            device[key].append(_profile(lambda r: fns[key](), 20)[1] / 20)
        t = {k: sum(v) / len(v) for k, v in runs.items()}
        t.update({f"{k}_device": sum(v) / len(v) for k, v in device.items()})
        t["plain"] = time_ms(lambda: gather.row_gather_plain(src, idx), DEVICE, 5)
        t["bound"], t["bound_by"] = bound(*gather_cost(src, idx), "f32")
        t["runs"] = runs
        times[f"C {c}"] = t
        log(f"phase 18: row_gather {n_pts} points of C {c}, in turns: kernel "
            f"{t['kernel']:.4f} ms per call ({t['kernel_device']:.4f} ms on the device), "
            f"torch.index_select {t['library']:.4f} ms ({t['library_device']:.4f}), plain "
            f"{t['plain']:.4f} ms, bound {t['bound']:.4f} ms ({t['bound_by']}); runs {runs}")
        if c == 2:
            times["launch_path_us"] = launch_path(gather, src, idx)
        del src
    del cases, img, srcp, buf
    torch.cuda.empty_cache()
    gather.row_gather.launches = 0
    probe = gather_probe.run(size=s)
    launches = gather.row_gather.launches
    bad = [r for r in probe if r["mismatch"]]
    if bad:
        raise AssertionError(f"gather-probe routes differ from their reference: {bad}")
    log(f"phase 18: gather probe, S {s}: {len(probe)} routes, every mismatch 0; "
        f"{launches} row_gather launches")
    return err, times, probe, launches


def _within_bf16_ulp(got, ref, floor_tol: float = 1e-5) -> bool:
    """Every value within one bf16 ulp of `ref`'s (2^(e - 8) for |ref| =
    m 2^e, m in [0.5, 1)), or within `floor_tol` of the output's scale
    (values near 0, whose sign the f32 sums' order decides)."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(r)
    floor = floor_tol * max(r.abs().max().item(), 1.0)
    return bool(((g - r).abs() <= torch.ldexp(torch.ones_like(r), e - 8) + floor).all())


def stage_costs(bsz: int, n: int, c: int):
    """{stage form: (bytes, operations, kind)} of the three stages at bf16 x
    [bsz, n, n, 1] and C channels: conv1 (with bias) -> [bsz, n-2, n-2, C]
    bf16; conv2 -> [bsz, n-4, n-4, C] f32 or bf16; the pool of a bf16 map,
    alone and with the int8 skip."""
    h1, h2 = bsz * (n - 2) ** 2 * c, bsz * (n - 4) ** 2 * c
    pooled = h2 // 4
    return {
        "conv1": (bsz * n * n * 2 + 10 * c * 4 + h1 * 2, 2 * 9 * h1, "f32"),
        "conv2 f32": (h1 * 2 + 9 * c * c * 2 + h2 * 4, 2 * 9 * c * h2, "bf16"),
        "conv2 relu_bf16": (h1 * 2 + 9 * c * c * 2 + h2 * 2, 2 * 9 * c * h2, "bf16"),
        "pool": (h2 * 2 + pooled * 2, 3 * pooled, "f32"),
        "pool + int8 skip": (h2 * 2 + h2 + pooled * 2, h2 + 3 * pooled, "f32"),
    }


@torch.inference_mode()
def phase19_enc0_stages():
    """The three enc0 stage kernels against their plain versions at the
    Mosaic probes' block, at K4's serving chunk and at ragged shapes; the
    mosaic probe; each stage's time at the chunk against its plain version,
    the bound and the library call where one computes the same function.
    Returns (max abs errors, times, probe records, probe launches)."""
    from tpu_unet_torch.ops import enc0_stages as st
    from tpu_unet_torch.ops.fused_level0 import _inverse
    from tpu_unet_torch.probes import mosaic_probe

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    bsz, n, c = BATCH_TILES, TILE_IN, ENC0_C
    errs = {"conv1": 0.0, "conv2": 0.0, "pool_quant": 0.0}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    def check(stage, label, got, ref, ok):
        err = (got.float() - ref.float()).abs().max().item()
        errs[stage] = max(errs[stage], err)
        log(f"phase 19: {stage} {label}: max|err| {err:.3g}")
        if not (got.dtype == ref.dtype and got.shape == ref.shape and ok):
            raise AssertionError(f"the {stage} stage kernel differs from its plain version "
                                 f"at {label}")

    conv1_cases = [("block, f32 x [1,12,516]", randn(1, 12, 516), 64, False, False),
                   (f"chunk, bf16 x [{bsz},{n},{n}], bias", torch.rand(
                       (bsz, n, n), generator=gen, device=DEVICE).to(torch.bfloat16), c,
                    True, False),
                   ("taps, slab [1,10,514,9]", randn(1, 10, 514, 9), 64, False, True),
                   ("ragged C 16, x [2,15,40] (odd 13x38)", randn(2, 15, 40), 16, True, False),
                   ("ragged C 24, x [1,9,23] (odd 7x21)", randn(1, 9, 23), 24, True, False)]
    for label, x, cc, bias, taps in conv1_cases:
        w9 = randn(9, cc, scale=0.5)
        b = randn(cc, scale=0.1) if bias else None
        got, ref = st.conv1_stage(x, w9, b, taps=taps), st.conv1_stage_plain(x, w9, b, taps=taps)
        torch.cuda.synchronize()
        check("conv1", label, got, ref, _within_bf16_ulp(got, ref))
        del x, got, ref
    conv2_cases = [("block, h [1,10,514,64]", (1, 10, 514), 64, 64),
                   (f"chunk, h [{bsz},{n - 2},{n - 2},{c}]", (bsz, n - 2, n - 2), c, c),
                   ("ragged 16 -> 24, h [2,13,37] (odd 11x35)", (2, 13, 37), 16, 24),
                   ("ragged 24 -> 16, h [1,12,19] (odd 10x17)", (1, 12, 19), 24, 16)]
    for label, shape, cin, cout in conv2_cases:
        h = torch.relu(randn(*shape, cin)).to(torch.bfloat16)
        w = randn(3, 3, cin, cout, scale=math.sqrt(2 / (9 * cin))).to(torch.bfloat16)
        for relu_bf16 in (False, True):
            got = st.conv2_stage(h, w, relu_bf16=relu_bf16)
            ref = st.conv2_stage_plain(h, w, relu_bf16=relu_bf16)
            torch.cuda.synchronize()
            ok = (_within_bf16_ulp(got, ref) if relu_bf16 else
                  (got - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0))
            check("conv2", f"{label}, {'relu_bf16' if relu_bf16 else 'f32'}", got, ref, ok)
            del got, ref
        del h, w
    halves = (torch.randint(-40, 600, (2, 12, 34, 64), generator=gen, device=DEVICE) / 4.0)
    pool_cases = [("block, bf16 h [1,8,512,64]", torch.rand(
                       (1, 8, 512, 64), generator=gen, device=DEVICE).to(torch.bfloat16), 50.0),
                  ("block, f32 h [1,8,512,64]", randn(1, 8, 512, 64), 37.5),
                  (f"chunk, bf16 h [{bsz},{n - 4},{n - 4},{c}]", torch.relu(
                      randn(bsz, n - 4, n - 4, c)).to(torch.bfloat16), 1 / 0.0123),
                  ("ragged C 16, f32", randn(2, 6, 10, 16), 50.0),
                  ("ragged C 24, bf16", randn(1, 4, 6, 24).to(torch.bfloat16), 50.0),
                  ("values on .5 after scaling and past 127, f32", halves, 2.0),
                  ("values on .5 after scaling and past 127, bf16", halves.to(torch.bfloat16),
                   2.0)]
    for label, h, scale in pool_cases:
        err, equal = 0.0, True
        for skip, pool in ((None, True), ("bf16", True), ("bf16", False), ("int8", True),
                           ("int8", False)):
            kw = {"skip": skip, "pool": pool, "skip_scale": scale if skip == "int8" else None}
            got, ref = st.pool_quant_stage(h, **kw), st.pool_quant_stage_plain(h, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if (g is None) != (r is None):
                    raise AssertionError(f"pool_quant outputs differ at {label}, {kw}")
                if g is not None:
                    equal = equal and g.dtype == r.dtype and torch.equal(g, r)
                    err = max(err, (g.float() - r.float()).abs().max().item())
            del got, ref
        errs["pool_quant"] = max(errs["pool_quant"], err)
        log(f"phase 19: pool_quant {label}, s {scale:.4g}, every skip and pool mode: "
            f"max|err| {err}")
        if not equal:
            raise AssertionError(f"the pool_quant stage kernel differs from its plain "
                                 f"version at {label}")
        del h
    log("phase 19: ok, conv1 and conv2's ReLU-bf16 form within one bf16 ulp (inside "
        f"BF16_TOL = {BF16_TOL} of the scale), conv2 f32 within 1e-5 of its scale, "
        "pool/quant bit-exact")

    times = {}
    x = torch.rand((bsz, n, n), generator=gen, device=DEVICE).to(torch.bfloat16)
    w9, b1 = randn(9, c, scale=0.5), randn(c, scale=0.1)
    w = randn(3, 3, c, c, scale=math.sqrt(2 / (9 * c))).to(torch.bfloat16)
    costs = stage_costs(bsz, n, c)
    h1 = st.conv1_stage(x, w9, b1)
    h2 = st.conv2_stage(h1, w, relu_bf16=True)
    inv = _inverse(h2.float().max().item() / 110.0)
    # the library calls in PyTorch's layout, prepared once: NCHW views of the
    # NHWC maps (channels_last) and the weights in channels_last
    h1_nchw, h2_nchw = h1.permute(0, 3, 1, 2), h2.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    # conv1's library call: the f32 conv + bias + ReLU (TF32 off) of the image
    x_nchw, w1_oihw = x.float()[:, None], w9.t().reshape(c, 1, 3, 3).contiguous()
    forms = {
        "conv1": (lambda: st.conv1_stage(x, w9, b1),
                  lambda: st.conv1_stage_plain(x, w9, b1),
                  lambda: F.relu(F.conv2d(x_nchw, w1_oihw, b1))),
        "conv2 f32": (lambda: st.conv2_stage(h1, w), lambda: st.conv2_stage_plain(h1, w),
                      lambda: F.conv2d(h1_nchw, w_oihw)),
        "conv2 relu_bf16": (lambda: st.conv2_stage(h1, w, relu_bf16=True),
                            lambda: st.conv2_stage_plain(h1, w, relu_bf16=True), None),
        "pool": (lambda: st.pool_quant_stage(h2), lambda: st.pool_quant_stage_plain(h2),
                 lambda: F.max_pool2d(h2_nchw, 2)),
        "pool + int8 skip": (lambda: st.pool_quant_stage(h2, skip="int8", skip_scale=inv),
                             lambda: st.pool_quant_stage_plain(h2, skip="int8",
                                                               skip_scale=inv), None),
    }
    for key, (kern, plain, lib) in forms.items():
        t = {"kernel": time_ms(kern, DEVICE, 10), "plain": time_ms(plain, DEVICE, 3),
             "library": time_ms(lib, DEVICE, 10) if lib is not None else None}
        nbytes, ops, kind = costs[key]
        t["bound"], t["bound_by"] = bound(nbytes, ops, kind)
        times[key] = t
        log(f"phase 19: {key} at the chunk: kernel {t['kernel']:.4f} ms, plain "
            f"{t['plain']:.4f} ms, library "
            + (f"{t['library']:.4f} ms" if t["library"] is not None else "none")
            + f", bound {t['bound']:.4f} ms ({t['bound_by']})")
    del x, h1, h2, h1_nchw, h2_nchw, x_nchw, forms
    torch.cuda.empty_cache()

    for fn in (st.conv1_stage, st.conv2_stage, st.pool_quant_stage):
        fn.launches = 0
    probe = mosaic_probe.run()
    launches = {"enc0_conv1_stage": st.conv1_stage.launches,
                "enc0_conv2_stage": st.conv2_stage.launches,
                "enc0_pool_quant_stage": st.pool_quant_stage.launches}
    bad = [r["name"] for r in probe if r["mismatch"]]
    if bad:
        raise AssertionError(f"mosaic-probe lines beyond their bar: {bad}")
    chain = {r["name"]: r for r in probe if r["section"] == "chunk"}
    times["chain"] = {k: r["ms"] for k, r in chain.items()}
    staged = chain["staged chain (3 launches)"]
    if not staged["pooled_equal"]:
        raise AssertionError("the staged chain's pooled map differs from K4's")
    times["staged_pooled_equal_k4"] = staged["pooled_equal"]
    log(f"phase 19: mosaic probe: {len(probe)} lines, every one within its bar; launches "
        f"{launches}")
    return errs, times, probe, launches


# Phase 20: the CLI, run in process through tpu_unet_torch.cli.main so the
# wrappers' launch counts can be read. The DIC-HeLa fixture (10 images of
# 448^2, each one whole-image tile of 636^2) serves in one chunk of 10.
CLI_ARGS = ["-d", "DIC-C2DH-HeLa", "--synthetic", "--quiet"]
CLI_EPOCHS = 1                     # epochs 0..1
CLI_IMAGES, CLI_SIDE = 10, 448
CLI_QUANT = (None, "int8", "int8-phase")
# launches per chunk when TESTING a 'pallas' checkpoint, by --quant:
# {kernel: (all launches, of them on route sm90)}
CLI_PALLAS_LAUNCHES = {
    None: {"conv3x3_bias_relu": (18, 17), "conv3x3_fused": (0, 0), "conv_kxk_fused": (0, 0)},
    "int8": {"conv3x3_bias_relu": INT8_FLOAT_K1, "conv3x3_fused": (14, 14),
             "conv_kxk_fused": (0, 0)},
    "int8-phase": {"conv3x3_bias_relu": INT8_PHASE_FLOAT_K1, "conv3x3_fused": (13, 13),
                   "conv_kxk_fused": (2, 2)},
}
# ... and once a run under --quant: int8 calibration's one float forward
CLI_CALIBRATION_LAUNCHES = {"conv3x3_bias_relu": (18, 17)}


def cli_plan():
    """(tile_in, tile_out, tiles per chunk, chunks) of the CLI's TESTING of
    the fixture: each image one whole-image tile, the tiles in chunks of
    BATCH_TILES or fewer (TileInference's default)."""
    from tpu_unet_torch.core.geometry import input_size_compute, plan_tiles

    plan = plan_tiles(CLI_SIDE, CLI_SIDE, input_size_compute(CLI_SIDE)[2])
    n_tiles = CLI_IMAGES * plan.num_tiles
    batch = min(BATCH_TILES, n_tiles)
    return plan.tile_in, plan.tile_out, batch, -(-n_tiles // batch)


@torch.inference_mode()
def phase20_kernels_vs_plain(cfg):
    """K1, K3 and the k x k kernel at the shapes the CLI's TESTING gives
    them (one chunk of `batch` tiles of tile_in^2), each against its plain
    version: K1 at phase 2's bf16 bar, on the route the model takes; K3 (int8
    out, as int8 serving calls it) and the k x k kernel (through
    conv_rows3_col, as int8-phase serving calls it) bit for bit on the sm90
    loop, as phases 9 and 15. Returns {kernel: max |err|}."""
    from tpu_unet_torch.ops.conv_kxk import conv_kxk_fused, conv_kxk_fused_plain, conv_rows3_col
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused_plain

    tile_in, tile_out, batch, _ = cli_plan()
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    shapes, out = conv_shapes(cfg, tile_in)
    if out != tile_out:
        raise AssertionError(f"a {tile_in}^2 tile gives {out}^2, the plan {tile_out}^2")
    errs = {"conv3x3_bias_relu": 0.0, "conv3x3_fused": 0.0, "conv_kxk_fused": 0.0}
    for name, s, cin, cout in shapes:
        route = _route_of(cin)
        err = _compare((batch, s, s, cin), cout, torch.bfloat16, gen, route)
        errs["conv3x3_bias_relu"] = max(errs["conv3x3_bias_relu"], err)
        log(f"phase 20: K1 {name:17s} x[{batch},{s},{s},{cin}] -> {cout} ({route}): bf16 "
            f"max|err| {err:.3g} (bound {BF16_TOL} x scale)")
    cases = [("conv3x3_fused", name, 3, s, cin, cout)
             for name, s, cin, cout in int8_shapes(cfg, tile_in)]
    cases += [("conv_kxk_fused", name, 2, s, cin, cout)
              for name, s, cin, cout in kxk_shapes(cfg, tile_in, tile_out)]
    for kernel, name, k, s, cin, cout in cases:
        x, w, alpha, beta = _k3_inputs((batch, s, s, cin), cout, torch.int8, gen, k=k)
        if kernel == "conv3x3_fused":
            got, took = _k3_launch(x, w, alpha, beta, "int8")
            ref = conv3x3_fused_plain(x, w, alpha, beta, "int8")
        else:
            sm90 = conv_kxk_fused.sm90_launches
            got = conv_rows3_col(x, w, alpha, beta)
            took = "sm90" if conv_kxk_fused.sm90_launches > sm90 else "simple"
            ref = conv_kxk_fused_plain(x, w, alpha, beta)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        errs[kernel] = max(errs[kernel], err)
        share = (ref > 0).float().mean().item()
        log(f"phase 20: {kernel} {name:17s} {k}x{k} x[{batch},{s},{s},{cin}] -> {cout} "
            f"({took}): max|err| {err} vs plain (bar: equal); nonzero share {share:.3f}")
        if not (took == "sm90" and got.dtype == torch.int8 and torch.equal(got, ref)):
            raise AssertionError(f"{kernel} at the CLI's {name} shape: route {took}, "
                                 f"max|err| {err}")
        if not 0.0 < share < 1.0:
            raise AssertionError(f"degenerate {kernel} test outputs at {name}")
        del x, w, got, ref
    log(f"phase 20: K1 (18 convs), K3 (14) and the k x k kernel (2) at the CLI's shapes "
        f"within their bars: {errs}")
    return errs


def _serve_checkpoints(models_dir, served_state):
    """Store `served_state` beside the CLI's 'best', under its host state
    and model config, as 'served' (stored conv_impl 'xla') and
    'served_pallas' ('pallas'): the layout the CLI's TESTING reads.
    Returns {impl: checkpoint path}."""
    from tpu_unet_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(models_dir)
    _, host = ckpt.restore("best")
    paths = {}
    for impl, tag in (("xla", "served"), ("pallas", "served_pallas")):
        hs = json.loads(json.dumps(host))
        hs["model_cfg"]["conv_impl"] = impl
        paths[impl] = ckpt.save(tag, {"model": served_state}, hs)
    return paths


def _cli_served_logits(ckpt, images):
    """The served weights' logits on the CLI's one chunk of tiles, as the
    TESTING runs compute them, 'pallas' against 'xla': bf16 within
    MODEL_TOL of the scale, with equal argmax wherever the 'xla' margin
    exceeds twice the largest difference (phase 3); int8 and int8-phase,
    calibrated once and served under both, bit for bit (phases 10 and 16).
    Returns {forward: max |err|}."""
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.infer.quant import (QuantInference, build_quant_inference,
                                            calibration_batch)
    from tpu_unet_torch.models import ModelConfig, UNet
    from tpu_unet_torch.train.checkpoint import Checkpointer

    state, host = Checkpointer(os.path.dirname(ckpt)).restore(os.path.basename(ckpt))
    models = {}
    for impl, level0 in (("xla", True), ("pallas", False)):    # as the CLI runs them
        m = UNet(ModelConfig(**{**host["model_cfg"], "conv_impl": impl,
                                "phase_level0": level0})).to(DEVICE)
        m.load_state_dict(state["model"])
        models[impl] = m
    engines = {impl: TileInference(m, CLI_SIDE, CLI_SIDE) for impl, m in models.items()}
    tiles = engines["xla"]._flat_tiles(engines["xla"]._on_device(images, torch.float32))
    errs = {}
    with torch.inference_mode():
        lp, lx = (engines[impl]._forward(tiles) for impl in ("pallas", "xla"))
        err, scale, _, same, same_decided, decided = _logit_diff(lp, lx)
        log(f"phase 20: served bf16 logits on {tiles.shape[0]} tiles of {tiles.shape[1]}^2, "
            f"'pallas' vs 'xla': max|err| {err:.4g} (scale {scale:.4g}, bound {MODEL_TOL} x "
            f"scale); argmax equal on {same:.6f}, and on {same_decided:.6f} of the "
            f"{decided:.6f} whose margin exceeds 2 x max|err|")
        if not (err <= MODEL_TOL * scale and same_decided == 1.0):
            raise AssertionError("served bf16 logits: 'pallas' and 'xla' disagree")
        errs["bf16"] = err
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the float layers run twice
    try:
        for quant, level0 in (("int8", None), ("int8-phase", "int8")):
            qp = build_quant_inference(models["xla"], calibration_batch(list(images)),
                                       phase_level0=level0).qp
            got, want = (QuantInference(qp, impl=impl, phase_level0=level0,
                                        device=DEVICE).apply(tiles)
                         for impl in ("pallas", "xla"))
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            errs[quant] = (got - want).abs().max().item()
            log(f"phase 20: served {quant} logits, 'pallas' (K3{', k x k' if level0 else ''}) "
                f"vs 'xla' (library): max|err| {errs[quant]} (bar: equal)")
            if not torch.equal(got, want):
                raise AssertionError(f"served {quant} logits: 'pallas' and 'xla' differ")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return errs


def _cli_main(argv):
    """cli.main(argv) with every kernel's count set to 0 just before it:
    (wall seconds, {kernel: (launches, of them sm90)}); a non-zero exit
    raises."""
    from tpu_unet_torch import cli
    from tpu_unet_torch.ops.conv_kxk import conv_kxk_fused
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused
    from tpu_unet_torch.ops.edt_pallas import column_pass

    fns = {"conv3x3_bias_relu": conv3x3_bias_relu, "edt_column_pass": column_pass,
           "conv3x3_fused": conv3x3_fused, "conv_kxk_fused": conv_kxk_fused}
    for fn in fns.values():
        fn.launches = fn.sm90_launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--platform", DEVICE])
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.main({argv}) returned {rc}")
    return seconds, {name: (fn.launches, fn.sm90_launches) for name, fn in fns.items()}


def _cli_outputs(out_dir):
    """(iou, pixel error, class maps [N, H, W] in {0, 1}) of a TESTING run,
    read back from its files through the port's TIFF codec."""
    from tpu_unet_torch.data.tiff import read_tiff

    iou, pe = (float(np.loadtxt(os.path.join(out_dir, f))[0])
               for f in ("test_iou.out", "test_pe.out"))
    if not (0.0 <= iou <= 1.0 and 0.0 <= pe <= 1.0):
        raise AssertionError(f"{out_dir}: IoU {iou}, pixel error {pe}")
    maps = []
    for i in range(CLI_IMAGES):
        (pred,) = read_tiff(os.path.join(out_dir, "preds", f"pred{i}.tif"))
        if pred.shape != (CLI_SIDE, CLI_SIDE) or pred.dtype != np.uint8 \
                or not set(np.unique(pred).tolist()) <= {0, 255}:
            raise AssertionError(f"{out_dir}/preds/pred{i}.tif: {pred.dtype} "
                                 f"{pred.shape} values {np.unique(pred)[:4]}")
        maps.append(pred == 255)
    return iou, pe, np.stack(maps)


def _both_classes(maps, what) -> float:
    """The foreground share of `maps`; raises unless both classes occur (a
    one-class map is written as all zeros and equals any other)."""
    share = float(maps.mean())
    if not 0.0 < share < 1.0:
        raise AssertionError(f"{what}: foreground share {share}, one class only")
    return share


def _cli_process(argv, env_extra):
    """`python -m tpu_unet_torch argv`, started as a process from the checkout."""
    env = dict(os.environ, PYTHONPATH=HERE, **env_extra)
    return subprocess.Popen([sys.executable, "-m", "tpu_unet_torch"] + argv, cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(proc, t0):
    """(exit code, seconds since t0, stderr) of `proc`, killed after 600 s."""
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    return proc.returncode, time.perf_counter() - t0, err


def phase20_cli(smi, cfg, served_state):
    """The system's own entry point on the card: TRAINING DIC-HeLa at full
    width ('xla', phase-packed level 0, bf16; K2 every step) and TESTING its
    'best'. Ten steps leave that model one class everywhere, so the CLI then
    serves `served_state` (the weights phase 13 trained), stored as an
    'xla' and a 'pallas' checkpoint, plain, int8 and int8-phase (K1, K3 and
    the k x k kernel counted per chunk): the class maps hold both classes
    and 'pallas' agrees with 'xla'. The kernels at these runs' shapes are
    held against their plain versions, and the served logits 'pallas'
    against 'xla'. Then the entry point as a process, with a card and,
    beside it, without one. Returns ({run: {"s": wall seconds, ...}},
    {kernel or "served_logits": max |err|})."""
    from tpu_unet_torch import cli
    from tpu_unet_torch.config import DATASETS
    from tpu_unet_torch.train.progress import FILES

    out = os.path.join(HERE, "build", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    runs = {}
    tile_in, _, batch, n_chunks = cli_plan()

    seconds, launches = _cli_main(["-m", "TRAINING", "--epochs", str(CLI_EPOCHS),
                                   "--dtype", "bfloat16", "--out-dir", out] + CLI_ARGS)
    run_dir = os.path.join(out, "DIC-C2DH-HeLa", "all")
    models_dir = os.path.join(run_dir, "models")
    n_steps = (CLI_EPOCHS + 1) * (CLI_IMAGES // 2)
    k2, k2_sm90 = launches["edt_column_pass"]
    losses = np.loadtxt(os.path.join(run_dir, "progress", FILES["loss"]), ndmin=1)
    runs["TRAINING"] = {"s": seconds, "launches": launches, "train_steps": n_steps,
                        "loss": losses.tolist()}
    log(f"phase 20: TRAINING {n_steps} steps in {seconds:.2f} s; launches {launches}; "
        f"loss {losses.tolist()} ({smi})")
    if k2 < n_steps or k2_sm90 != k2:
        raise AssertionError(f"K2 launches {launches['edt_column_pass']}, want >= {n_steps}, "
                             f"all on route sm90")
    if len(losses) != CLI_EPOCHS + 1 or not np.isfinite(losses).all():
        raise AssertionError(f"loss.out {losses}")
    for tag in ("best", "latest"):
        if not os.path.isdir(os.path.join(models_dir, tag)):
            raise AssertionError(f"no '{tag}' checkpoint in {models_dir}")
    best = os.path.join(models_dir, "best")
    seconds, launches = _cli_main(["-m", "TESTING", "-n", best] + CLI_ARGS)
    iou, pe, maps = _cli_outputs(best + "_test")
    runs["TESTING best"] = {"s": seconds, "launches": launches, "iou": iou, "pixel_error": pe,
                            "foreground_share": float(maps.mean())}
    log(f"phase 20: TESTING the trained 'best' (stored config) in {seconds:.2f} s: IoU "
        f"{iou:.6f}, pixel error {pe:.6f}, foreground share {maps.mean():.6f}; launches "
        f"{launches} ({smi})")
    if launches != dict.fromkeys(launches, (0, 0)):
        raise AssertionError(f"TESTING 'best' ('xla'): launches {launches}")

    errs = phase20_kernels_vs_plain(cfg)
    ckpts = _serve_checkpoints(models_dir, served_state)
    args = cli.build_parser().parse_args(["-m", "TESTING"] + CLI_ARGS)
    _, test_data = cli._load_data(args, DATASETS[args.dataset])
    errs["served_logits"] = _cli_served_logits(ckpts["xla"], test_data.images)

    maps = {}
    for impl, extra in (("xla", []), ("pallas", ["--no-phase-level0"])):
        for quant in CLI_QUANT:
            argv = ["-m", "TESTING", "-n", ckpts[impl]] + CLI_ARGS + extra \
                + (["--quant", quant] if quant else [])
            seconds, launches = _cli_main(argv)
            name = f"TESTING {impl} {quant or 'bf16'}"
            iou, pe, maps[impl, quant] = _cli_outputs(ckpts[impl] + "_test")
            share = _both_classes(maps[impl, quant], name)
            runs[name] = {"s": seconds, "launches": launches, "iou": iou, "pixel_error": pe,
                          "foreground_share": share}
            agree = ""
            if impl == "pallas":
                same = float((maps[impl, quant] == maps["xla", quant]).mean())
                runs[name]["agreement_vs_xla"] = same
                agree = f"; class maps equal to 'xla''s on {same:.6f} (bar {RESEARCH_AGREE})"
            log(f"phase 20: {name} ({' '.join(extra) or 'stored config'}) in {seconds:.2f} s: "
                f"IoU {iou:.6f}, pixel error {pe:.6f}, foreground share {share:.6f}; launches "
                f"{launches} for {CLI_IMAGES} tiles of {tile_in}^2 in {n_chunks} chunk(s) of "
                f"{batch}{agree} ({smi})")
            want = dict.fromkeys(launches, (0, 0))
            if impl == "pallas":
                calib = CLI_CALIBRATION_LAUNCHES if quant else {}
                for k, (n, sm90) in CLI_PALLAS_LAUNCHES[quant].items():
                    c, c_sm90 = calib.get(k, (0, 0))
                    want[k] = (n * n_chunks + c, sm90 * n_chunks + c_sm90)
            if launches != want:
                raise AssertionError(f"{name}: launches {launches}, want {want}")
            if runs[name].get("agreement_vs_xla", 1.0) < RESEARCH_AGREE:
                raise AssertionError(f"{name}: class maps agree with 'xla' on "
                                     f"{runs[name]['agreement_vs_xla']}")

    # the entry point as a process and, beside it, one that finds no card
    argv = ["-m", "TESTING", "-n", ckpts["pallas"], "--quant", "int8-phase",
            "--no-phase-level0"] + CLI_ARGS
    t0 = time.perf_counter()
    procs = [_cli_process(argv + ["--platform", DEVICE], {}),
             _cli_process(argv, {"CUDA_VISIBLE_DEVICES": ""})]
    (rc, seconds, err), (rc_none, seconds_none, err_none) = (_wait(p, t0) for p in procs)
    runs["process"] = {"s": seconds, "rc": rc}
    runs["process without a card"] = {"s": seconds_none, "rc": rc_none}
    log(f"phase 20: python -m tpu_unet_torch {' '.join(argv)}: exit {rc} in {seconds:.2f} s "
        f"({smi}); beside it, with CUDA_VISIBLE_DEVICES='' and no --platform: exit {rc_none} "
        f"in {seconds_none:.2f} s: {err_none.strip()[-200:]}")
    if rc != 0:
        raise AssertionError(f"python -m tpu_unet_torch exited {rc}: {err[-2000:]}")
    if rc_none == 0 or "--platform cpu" not in err_none:
        raise AssertionError(f"without a card: exit {rc_none}, stderr {err_none[-2000:]}")
    _, _, proc_maps = _cli_outputs(ckpts["pallas"] + "_test")
    _both_classes(proc_maps, "the process's class maps")
    if not np.array_equal(proc_maps, maps["pallas", "int8-phase"]):
        raise AssertionError("the process's class maps differ from the in-process run's")
    shutil.rmtree(out, ignore_errors=True)
    log(f"phase 20: ok in {sum(r['s'] for r in runs.values()):.1f} s of runs")
    return runs, errs


# The int4 tiers (phase 21): launches per chunk of each path, under
# 'pallas' ({kernel: (all, of them on route sm90)}); 'xla' launches none. The
# int4 convs take the int8 library route under both impls. The float 3x3
# convs take K1 in every run, 'xla' too: each serves the .npz the 'pallas'
# model calibrated, whose config routes them there.
INT4_LAUNCHES = {
    "int4": {"conv3x3_fused": (1, 1), "conv_kxk_fused": (0, 0)},
    "int4-phase": {"conv3x3_fused": (0, 0), "conv_kxk_fused": (2, 2)},
}
INT4_FLOAT_K1 = {"int4": INT8_FLOAT_K1, "int4-phase": INT8_PHASE_FLOAT_K1}
# The tier's own quality bar (tests/test_quant.py's test_int4_iou_vs_bf16):
# foreground IoU against the ground truth within 5% of the bf16 model's, and
# foreground IoU of the int4 maps against the bf16 maps above 0.90.
INT4_IOU_DROP, INT4_AGREE = 0.05, 0.90


def _smi_sample() -> str:
    """The card's SM clock, power draw, temperature and active throttle
    reasons as nvidia-smi reads them: logged beside a timing window."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (r.stdout or r.stderr).strip()


def _fg_iou(pred, ref) -> float:
    """Foreground IoU of two class maps (1 when both are empty)."""
    a, b = pred != 0, ref != 0
    return ((a & b).sum() / max((a | b).sum().item(), 1)).item()


def _int4_ops_vs_cpu(cfg, gen):
    """The int4 helpers on the card against the same calls on CPU copies,
    bit for bit, at the 13 int4 conv shapes of a 572^2 tile (batch 2): the
    shifted and the signed accumulate, the u4s epilogue and the four
    quantizers. Returns the number of calls compared."""
    from tpu_unet_torch.infer.quant import default_int4_names
    from tpu_unet_torch.ops import conv_tiles as ct

    names = default_int4_names(cfg)
    shapes = [sh for sh in conv_shapes(cfg, TILE_IN)[0] if sh[0] in names]
    if len(shapes) != 13:
        raise AssertionError(f"{len(shapes)} int4 convs, want 13: {sorted(names)}")
    n, failed = 0, []
    cpu = torch.device("cpu")
    for name, s, cin, cout in shapes:
        shape = (2, s, s, cin)
        x4 = torch.randint(-8, 8, shape, generator=gen, device=DEVICE, dtype=torch.int8)
        w4 = torch.randint(-7, 8, (3, 3, cin, cout), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        xf = torch.rand(shape, generator=gen, device=DEVICE) * 3
        x8 = torch.randint(0, 128, shape, generator=gen, device=DEVICE, dtype=torch.int8)
        alpha = torch.rand((cout,), generator=gen, device=DEVICE) * 0.3 / math.sqrt(cin)
        beta = torch.randn((cout,), generator=gen, device=DEVICE)
        wf = torch.randn((3, 3, cin, cout), generator=gen, device=DEVICE)
        calls = {
            "acc shifted": lambda t: ct.conv3x3_int4_acc(t(x4), t(w4), shifted=True),
            "acc signed": lambda t: ct.conv3x3_int4_acc(t(x4).clamp(-7, 7), t(w4)),
            "u4s epilogue": lambda t: ct.int4_epilogue(
                ct.conv3x3_int4_acc(t(x4), t(w4), shifted=True), t(alpha), t(beta), "u4s"),
            "quantize_weights_int4": lambda t: ct.quantize_weights_int4(t(wf)),
            "quantize_activations_u4s": lambda t: ct.quantize_activations_u4s(t(xf), 0.2),
            "quantize_activations_s4": lambda t: ct.quantize_activations_s4(t(xf) - 1.5, 0.2),
            "requantize_i8_to_u4s": lambda t: ct.requantize_i8_to_u4s(t(x8), 0.013,
                                                                      0.013 * 127 / 15),
            "requantize_u4s_to_i8": lambda t: ct.requantize_u4s_to_i8(t(x4), 0.013 * 127 / 15,
                                                                      0.013),
        }
        for op, call in calls.items():
            got = call(lambda a: a)
            want = call(lambda a: a.to(cpu))
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            n += 1
            if not all(g.device.type == torch.device(DEVICE).type and torch.equal(g.cpu(), w)
                       for g, w in zip(got, want)):
                failed.append(f"{op} at {name}")
        del x4, w4, xf, x8, wf
    if failed:
        raise AssertionError(f"int4 ops differ between the card and the CPU: {failed}")
    return n


def phase21_int4(cfg, served_state, data, qp8):
    """The int4 tiers on the model phase 13 trained: evaluate(quant='int4'
    and 'int4-phase', quant_path=...) under 'pallas' (calibrated and saved,
    then served) and 'xla', with launches per chunk (and K1's for the
    calibration's float forward, counted apart); every stage 'pallas' vs
    'xla' bit for bit; the .npz round trip and the other tier's refusal;
    the int4 ops card vs CPU; the tier's quality bar against the bf16
    model's maps; tiles/s of both tiers under both impls beside int8
    'pallas', in turns, and a profile of each tier's 'pallas' by kernel
    group. Returns a summary dict."""
    from tpu_unet_torch.infer import TileInference, evaluate
    from tpu_unet_torch.infer.quant import (QuantInference, default_int4_names,
                                            load_quant_params)
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.ops.conv_kxk import conv_kxk_fused
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused

    t_phase = time.perf_counter()
    fns = {"conv3x3_bias_relu": conv3x3_bias_relu, "conv3x3_fused": conv3x3_fused,
           "conv_kxk_fused": conv_kxk_fused}
    model = UNet(cfg).to(DEVICE)                   # conv_impl 'pallas'
    model.load_state_dict(served_state)
    xla = UNet(dataclasses.replace(cfg, conv_impl="xla")).to(DEVICE)
    xla.load_state_dict(served_state)
    engine = TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT)
    n_tiles = len(data) * engine.plan.num_tiles
    n_chunks = -(-n_tiles // engine.batch_tiles)
    qpath = os.path.join(HERE, "build", "chip_smoke_int4.npz")
    p8 = os.path.join(HERE, "build", "chip_smoke_int8_tier.npz")
    for f in (qpath, p8):
        if os.path.exists(f):
            os.remove(f)
    runs, launches, failed = {}, {}, []
    for tier, impl, m in (("int4", "pallas", model), ("int4", "pallas", model),
                          ("int4", "xla", xla), ("int4-phase", "pallas", model),
                          ("int4-phase", "xla", xla)):
        key = f"{tier} '{impl}'" + (", calibrated" if not os.path.exists(qpath) else "")
        for fn in fns.values():
            fn.launches = fn.sm90_launches = 0
        t0 = time.perf_counter()
        runs[key] = evaluate(m, data, tile_out=TILE_OUT, verbose=False, quant=tier,
                             quant_path=qpath)
        torch.cuda.synchronize()
        launches[key] = {name: (fn.launches, fn.sm90_launches) for name, fn in fns.items()}
        log(f"phase 21: evaluate(quant={tier!r}) {key} in {time.perf_counter() - t0:.2f} s: "
            f"launches (all, sm90) {launches[key]} for {n_tiles} tiles in {n_chunks} "
            f"chunk(s); {json.dumps(runs[key])}")
        want = {name: (0, 0) for name in fns}
        if impl == "pallas":
            want.update({name: (a * n_chunks, b * n_chunks)
                         for name, (a, b) in INT4_LAUNCHES[tier].items()})
        want["conv3x3_bias_relu"] = tuple(n * n_chunks for n in INT4_FLOAT_K1[tier])
        if key.endswith("calibrated"):           # the calibration's float forward
            want["conv3x3_bias_relu"] = tuple(n + c for n, c in
                                              zip(want["conv3x3_bias_relu"], (18, 17)))
        if launches[key] != want:
            failed.append(f"{key}: launches {launches[key]}, want {want}")
    metrics = {k: {m: v for m, v in r.items() if m != "seconds"} for k, r in runs.items()}
    for tier in ("int4", "int4-phase"):
        same = {json.dumps(v, sort_keys=True) for k, v in metrics.items()
                if k.startswith(tier + " ")}
        if len(same) != 1:
            failed.append(f"{tier}: 'pallas', 'xla', calibrated and served metrics differ: "
                          f"{metrics}")
    if not all(np.isfinite(v["iou_mean"]) for v in metrics.values()):
        failed.append(f"non-finite metrics {metrics}")
    qp4 = load_quant_params(qpath)
    if qp4.q4names != default_int4_names(cfg) or qp4.qnames != {"dec0_conv1"}:
        failed.append(f"the .npz holds int4 {sorted(qp4.q4names)}, int8 {sorted(qp4.qnames)}")
    # the other tier's file is refused, both ways
    evaluate(model, data, tile_out=TILE_OUT, verbose=False, quant="int8", quant_path=p8)
    for tier, path in (("int4", p8), ("int8", qpath)):
        try:
            evaluate(model, data, tile_out=TILE_OUT, verbose=False, quant=tier, quant_path=path)
            failed.append(f"quant={tier!r} served the other tier's file {path}")
        except ValueError as e:
            log(f"phase 21: quant={tier!r} with the other tier's file: ValueError ({e})")

    tiles = engine._flat_tiles(engine._on_device(data.images[:1], torch.float32))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True     # the float layers run twice
    qis = {}
    for tier, phase in (("int4", None), ("int4-phase", "int8")):
        qis[tier] = {impl: QuantInference(qp4, impl=impl, phase_level0=phase, device=DEVICE)
                     for impl in ("pallas", "xla")}
        n_int, differ = 0, []
        for stage in QUANT_STAGES + [None]:
            got = qis[tier]["pallas"].apply(tiles, stop_after=stage)
            n_int += got.dtype == torch.int8
            if not torch.equal(got, qis[tier]["xla"].apply(tiles, stop_after=stage)):
                differ.append(stage)
        log(f"phase 21: {tier} QuantInference 'pallas' vs 'xla' at all {len(QUANT_STAGES)} "
            f"stages ({n_int} integer) and the logits on image 0's {tiles.shape[0]} tiles: "
            f"{'equal' if not differ else f'differ at {differ}'}")
        failed += [f"{tier} 'pallas' and 'xla' differ at {st}" for st in differ]
    torch.backends.cudnn.deterministic = deterministic

    t0 = time.perf_counter()
    n_ops = _int4_ops_vs_cpu(cfg, torch.Generator(device=DEVICE).manual_seed(21))
    log(f"phase 21: {n_ops} int4 op calls at the 13 int4 conv shapes (batch 2) equal on the "
        f"card and the CPU, bit for bit, in {time.perf_counter() - t0:.1f} s")

    images = torch.from_numpy(data.images).to(DEVICE)
    lab = torch.from_numpy((data.targets > 127).astype(np.uint8)).to(DEVICE)

    def make(apply_fn=None):
        return TileInference(model, IMAGE, IMAGE, tile_out=TILE_OUT, apply_fn=apply_fn)

    engines = {"int4 'pallas'": make(qis["int4"]["pallas"].apply),
               "int4 'xla'": make(qis["int4"]["xla"].apply),
               "int4-phase 'pallas'": make(qis["int4-phase"]["pallas"].apply),
               "int4-phase 'xla'": make(qis["int4-phase"]["xla"].apply),
               "int8 'pallas'": make(QuantInference(qp8, impl="pallas", device=DEVICE).apply),
               "bf16 'pallas'": make()}
    preds = {k: e.evaluate_batch(images, lab)[1] for k, e in engines.items()}
    quality = {"bf16_fg_iou": _fg_iou(preds["bf16 'pallas'"], lab)}
    for tier in ("int4", "int4-phase"):
        q = {"fg_iou": _fg_iou(preds[f"{tier} 'pallas'"], lab),
             "fg_iou_vs_bf16": _fg_iou(preds[f"{tier} 'pallas'"], preds["bf16 'pallas'"])}
        q["fg_iou_drop"] = (quality["bf16_fg_iou"] - q["fg_iou"]) / quality["bf16_fg_iou"]
        quality[tier] = q
        log(f"phase 21: {tier} quality on the {len(data)} serving images: foreground IoU "
            f"{q['fg_iou']:.6f} against the bf16 model's {quality['bf16_fg_iou']:.6f} (drop "
            f"{q['fg_iou_drop']:.4%}, bar {INT4_IOU_DROP:.0%}); int4 maps vs bf16 maps "
            f"foreground IoU {q['fg_iou_vs_bf16']:.6f} (bar {INT4_AGREE})")
        if not (q["fg_iou_drop"] < INT4_IOU_DROP and q["fg_iou_vs_bf16"] > INT4_AGREE):
            failed.append(f"{tier} quality {q}")
    del engines["bf16 'pallas'"]

    times = {k: [] for k in engines}
    order = list(engines)
    for turn in range(3):                  # in turns: forward, reversed, forward
        log(f"phase 21: timing turn {turn}: nvidia-smi (SM clock, power, temperature, "
            f"throttle reasons) {_smi_sample()}")
        for key in order if turn != 1 else order[::-1]:
            times[key].append(time_ms(lambda: engines[key].evaluate_batch(images, lab),
                                      DEVICE, 3))
    log(f"phase 21: after the turns: nvidia-smi {_smi_sample()}")
    tiles_s = {}
    for key, ts in times.items():
        ms = sum(ts) / len(ts)
        tiles_s[key] = n_tiles / (ms / 1e3)
        tiles_s[f"{key} ms"] = ms
        log(f"phase 21: evaluate_batch {key}: {ms:.2f} ms for {n_tiles} tiles of "
            f"{TILE_IN}^2 = {tiles_s[key]:.1f} tiles/s (runs {[round(t, 3) for t in ts]})")
    n = 3
    for key, need in (("int4 'pallas'", "K3 conv3x3_fused"),
                      ("int4-phase 'pallas'", "k x k conv_kxk_fused")):
        window, busy, groups, top = _profile(lambda r: engines[key].evaluate_batch(images, lab),
                                             n)
        tiles_s[f"{key} profiled_idle_share"] = 1.0 - busy / window
        tiles_s[f"{key} profiled_ms_per_call"] = {
            "device_busy": busy / n, **{g: ms / n for g, ms in groups.items()}}
        log(f"phase 21: profile of {n} evaluate_batch calls {key}: window {window / n:.3f} "
            f"ms/call, device busy {busy / n:.3f} ms/call; by group (ms/call): "
            + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items() if ms))
        for name, ms in top:
            log(f"phase 21:   {ms / n:9.3f} ms/call  {name[:110]}")
        _require_groups(groups, need, "cuDNN/cuBLAS conv and GEMM")
    if failed:
        raise AssertionError(f"phase 21 failed: {failed}")
    log(f"phase 21: ok in {time.perf_counter() - t_phase:.1f} s")
    # K1 in the calibrating run: the float 3x3 convs, and the calibration's
    # float forward apart
    served = launches["int4 'pallas'"]["conv3x3_bias_relu"]
    calib = tuple(c - n for c, n in zip(launches["int4 'pallas', calibrated"]
                                        ["conv3x3_bias_relu"], served))
    return {"tiles_per_s": tiles_s, "quality": quality, "metrics": metrics,
            "launches": {"serve_int4": launches["int4 'pallas'"]["conv3x3_fused"],
                         "serve_int4_phase": launches["int4-phase 'pallas'"]["conv_kxk_fused"],
                         "serve_int4_float": served, "serve_int4_calibration": calib},
            "cpu_compared_calls": n_ops}


# conv_bwd (phase 22): the gradient bars against 'xla', by compute dtype
CONV_BWD_GRAD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _step_grads(model, inp, gt, w):
    """(loss, {name: gradient}) of one DIC-HeLa loss on (inp, gt, w)."""
    from tpu_unet_torch.losses.bce import weighted_bce_with_logits
    from tpu_unet_torch.models import center_crop_or_pad

    model.zero_grad(set_to_none=True)
    loss = weighted_bce_with_logits(center_crop_or_pad(model(inp), gt.shape[1:3]), gt, w)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def phase22_conv_bwd(cfg):
    """One DIC-HeLa train step at full width (batch 2, conv_impl 'xla') under
    conv_bwd 'xla', 'mm' and 'auto' from the same weights and batch: equal
    losses, every gradient within CONV_BWD_GRAD_TOL of its norm of 'xla''s
    (bf16; and f32 with TF32 off), the layers 'auto' sends to 'mm' logged;
    then the bf16 step's time by part under the three, in turns, and a
    profile of each. Returns a summary dict."""
    from tpu_unet_torch.config import DATASETS, OptimConfig
    from tpu_unet_torch.data.augment import AugmentPipeline
    from tpu_unet_torch.losses.weights import make_weight_fn
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.models import unet as unet_mod
    from tpu_unet_torch.train import make_optimizer

    t_phase = time.perf_counter()
    inp, gt = _batch(AugmentPipeline(DATASETS["DIC-C2DH-HeLa"].augment()), _train_data(), 22)
    with torch.no_grad():
        w = make_weight_fn("distance")(gt)
    by_shape = {(s, cin): name for name, s, cin, _ in conv_shapes(cfg, inp.shape[1])[0]}
    routed = []
    real = unet_mod.conv3x3_bias

    def recording(x, k, b, **kw):
        routed.append(by_shape[(x.shape[1], x.shape[-1])])
        return real(x, k, b, **kw)

    out, failed = {"auto_mm_layers": None, "grad_rel_err": {}, "loss": {}}, []
    deterministic = torch.backends.cudnn.deterministic
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.deterministic = True
    unet_mod.conv3x3_bias = recording
    try:
        for dtype in ("bfloat16", "float32"):
            # the f32 bar holds with TF32 off, whatever the caller set
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
                tf32 if dtype == "bfloat16" else (False, False))
            grads = {}
            for bwd in ("xla", "mm", "auto"):
                c = dataclasses.replace(cfg, conv_impl="xla", compute_dtype=dtype, conv_bwd=bwd)
                model = UNet(c, generator=torch.Generator().manual_seed(0)).to(DEVICE)
                routed.clear()
                out["loss"][f"{dtype} {bwd}"], grads[bwd] = _step_grads(model, inp, gt, w)
                if bwd == "auto" and dtype == "bfloat16":
                    out["auto_mm_layers"] = list(routed)
                if bwd == "mm" and dtype == "bfloat16":
                    out["mm_layers"] = len(routed)
                del model
            for bwd in ("mm", "auto"):
                err = max(((grads[bwd][n] - g).float().norm()
                           / g.float().norm().clamp_min(1e-30)).item()
                          for n, g in grads["xla"].items())
                out["grad_rel_err"][f"{dtype} {bwd}"] = err
                if not (err <= CONV_BWD_GRAD_TOL[dtype]
                        and out["loss"][f"{dtype} {bwd}"] == out["loss"][f"{dtype} xla"]):
                    failed.append(f"{dtype} {bwd}: loss {out['loss']}, gradient error {err}")
            del grads
    finally:
        unet_mod.conv3x3_bias = real
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase 22: one DIC-HeLa step (batch 2, {inp.shape[1]}^2, 'xla'): losses {out['loss']}; "
        f"worst gradient error in norm against 'xla' {out['grad_rel_err']} (bars "
        f"{CONV_BWD_GRAD_TOL}); 'mm' routes {out['mm_layers']} convs, 'auto' routes "
        f"{out['auto_mm_layers']}")

    size = inp.shape[1]
    parts_in = _train_parts()
    models = {}
    for bwd in ("xla", "mm", "auto"):
        m = UNet(dataclasses.replace(cfg, conv_impl="xla", conv_bwd=bwd),
                 generator=torch.Generator().manual_seed(0)).to(DEVICE)
        models[bwd] = (m, make_optimizer(m.parameters(), OptimConfig()))
    parts = ("augment", "weights", "fwd_bwd", "optimizer")
    steps, reps = {}, 6
    log(f"phase 22: before the turns: nvidia-smi {_smi_sample()}")
    for bwd in ("xla", "mm", "auto", "auto", "mm", "xla"):
        ev = {k: _events() for k in parts}
        acc = dict.fromkeys(parts, 0.0)
        for r in range(reps + 1):             # the first is a warm-up
            _train_step(*models[bwd], parts_in, r, lambda k, i: ev[k][i].record())
            torch.cuda.synchronize()
            if r:
                for k in parts:
                    acc[k] += ev[k][0].elapsed_time(ev[k][1]) / reps
        steps.setdefault(bwd, []).append(acc)
    step_ms = {}
    for bwd, runs in steps.items():
        mean = {k: sum(r[k] for r in runs) / len(runs) for k in parts}
        step_ms[bwd] = {**mean, "step": sum(mean.values())}
        log(f"phase 22: train step conv_bwd={bwd!r} (bf16, batch 2, {size}^2, 'xla'): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms[bwd].items())
            + f" (runs {[round(sum(r.values()), 3) for r in runs]})")
    n = 3
    for bwd in ("xla", "mm", "auto"):
        window, busy, groups, top = _profile(lambda r: _train_step(*models[bwd], parts_in, r), n)
        step_ms[bwd]["profiled_busy_ms"] = busy / n
        step_ms[bwd]["profiled_ms_per_step"] = {g: ms / n for g, ms in groups.items()}
        log(f"phase 22: profile of {n} steps conv_bwd={bwd!r}: window {window / n:.3f} ms/step, "
            f"device busy {busy / n:.3f} ms/step; by group (ms/step): "
            + ", ".join(f"{g} {ms / n:.3f}" for g, ms in groups.items() if ms))
        for name, ms in top[:4]:
            log(f"phase 22:   {ms / n:9.3f} ms/step  {name[:110]}")
    del models
    if failed:
        raise AssertionError(f"phase 22 failed: {failed}")
    log(f"phase 22: ok in {time.perf_counter() - t_phase:.1f} s")
    out["step_ms"] = step_ms
    return out


# ------------------------------------------------------------------ phase 23
# The mesh paths (tpu_unet_torch/parallel and TileInference(mesh=)) in rank
# processes of this script (`chip_smoke.py --mesh-rank SPEC`), each joined
# through initialize_multihost() from torchrun's variables. NCCL takes one
# rank per card; ranks that share one card take gloo, named explicitly. Every
# result is held against the same computation in this (single) process on the
# same card, from the same weights and inputs.

MESH_TIMEOUT_S = 480           # a group not done by then (a hung collective) fails
MESH_REPS = 3                  # timed calls after the checked one
MESH_TIERS = ("bf16", "int8", "int8-phase", "int4-phase")
# launches per rank per forward (per chunk on the tiles path): {kernel: (all, sm90)}
MESH_FORWARD_LAUNCHES = {"conv3x3_bias_relu": (18, 17)}
MESH_TIER_LAUNCHES = {"bf16": MESH_FORWARD_LAUNCHES,
                      "int8": {"conv3x3_fused": (14, 14), "conv3x3_bias_relu": INT8_FLOAT_K1},
                      "int8-phase": {"conv3x3_fused": (13, 13), "conv_kxk_fused": (2, 2),
                                     "conv3x3_bias_relu": INT8_PHASE_FLOAT_K1},
                      "int4-phase": {"conv_kxk_fused": (2, 2),
                                     "conv3x3_bias_relu": INT8_PHASE_FLOAT_K1}}
MESH_KERNELS = ("conv3x3_bias_relu", "edt_column_pass", "conv3x3_fused", "conv_kxk_fused")


def mesh_groups(world_nccl: int):
    """The groups phase 23 starts: (name, backend, world, {path: mesh shape})."""
    return [
        ("nccl", "nccl", world_nccl, {"dp_step": (world_nccl,),
                                      "halo_inference": (world_nccl,),
                                      "tiles": (world_nccl,)}),
        ("gloo2", "gloo", 2, {"dp_step": (2,), "halo_inference": (2,), "halo_step": (2,),
                              "tiles": (2,)}),
        ("gloo2x2", "gloo", 4, {"dp_halo_step": (2, 2)}),
    ]


def _kernel_fns():
    from tpu_unet_torch.ops.conv_kxk import conv_kxk_fused
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
    from tpu_unet_torch.ops.conv_tiles import conv3x3_fused
    from tpu_unet_torch.ops.edt_pallas import column_pass

    return dict(zip(MESH_KERNELS, (conv3x3_bias_relu, column_pass, conv3x3_fused,
                                   conv_kxk_fused)))


def _counted(fn, device):
    """(fn(), {kernel: (launches, sm90 launches)}): every count set to 0 just
    before the call and read just after it."""
    fns = _kernel_fns()
    for k in fns.values():
        k.launches = k.sm90_launches = 0
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, {name: (k.launches, k.sm90_launches) for name, k in fns.items()}


def _mesh_ms(fn, device, reps):
    """Host ms per call of `fn` over `reps` calls after a warm-up, every rank
    in step (the calls hold collectives)."""
    import torch.distributed as dist

    fn()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    if dist.is_initialized():
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def _state_checksum(model, opt):
    """One int64 per parameter and momentum buffer: the sum of its 32-bit
    words (equal bits give equal sums)."""
    ts = [p.detach() for p in model.parameters()]
    ts += [opt.state[p]["momentum_buffer"] for p in model.parameters()]
    return torch.stack([t.contiguous().view(torch.int32).sum(dtype=torch.int64) for t in ts])


def _replicated(model, opt) -> bool:
    """Every rank's parameters and momentum bit-equal (their checksums
    all-gathered)."""
    import torch.distributed as dist

    mine = _state_checksum(model, opt)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(mine, other) for other in every)


def _fresh(cfg, state, device):
    from tpu_unet_torch.config import OptimConfig
    from tpu_unet_torch.models import UNet
    from tpu_unet_torch.train import make_optimizer

    model = UNet(cfg).to(device)
    model.load_state_dict(state)
    return model, make_optimizer(model.parameters(), OptimConfig())


def _momentum(model, opt):
    return {n: opt.state[p]["momentum_buffer"].detach().cpu()
            for n, p in model.named_parameters()}


def _train_result(model, opt, loss, metrics, launches, rank):
    out = {"loss": float(loss), "metrics": metrics, "launches": launches,
           "replicated": _replicated(model, opt)}
    if rank == 0:
        out["momentum"] = _momentum(model, opt)
    return out


def _mesh_dp_step(inputs, shape, device, reps):
    import torch.distributed as dist
    from tpu_unet_torch.losses.weights import make_weight_fn
    from tpu_unet_torch.parallel import make_dp_train_step, make_mesh, replicate, shard_batch

    mesh = make_mesh(axes=("data",), shape=shape, device=device)
    model, opt = _fresh(inputs["cfg"], inputs["state"], device)
    replicate(model, mesh)
    step = make_dp_train_step(model, make_weight_fn("distance"), "intended", opt, mesh)
    inp, gt = (shard_batch(inputs[k][:2 * shape[0]].to(device), mesh)
               for k in ("dp_inp", "dp_gt"))
    (loss, metrics), launches = _counted(lambda: step(inp, gt), device)
    out = _train_result(model, opt, loss, metrics.cpu(), launches, dist.get_rank())
    out["ms"] = _mesh_ms(lambda: step(inp, gt), device, reps)
    return out


def _mesh_halo_inference(inputs, shape, device, reps):
    import torch.distributed as dist
    from tpu_unet_torch.parallel import halo_strip_inference, make_mesh, shard_batch

    mesh = make_mesh(axes=("spatial",), shape=shape, device=device)
    model, _ = _fresh(inputs["cfg"], inputs["state"], device)
    fwd = halo_strip_inference(model, mesh, inputs["strip"], inputs["strip"])
    strip = shard_batch(inputs["halo_img"][:shape[0] * inputs["strip"]].to(device), mesh, "spatial")
    logits, launches = _counted(lambda: fwd(strip), device)
    out = {"launches": launches, "ms": _mesh_ms(lambda: fwd(strip), device, reps)}
    if dist.get_rank() == 0:
        out["logits"] = logits.cpu()
    return out


def _mesh_halo_step(inputs, shape, device, reps):
    import torch.distributed as dist
    from tpu_unet_torch.parallel import make_halo_train_step, make_mesh, replicate, shard_batch

    mesh = make_mesh(axes=("spatial",), shape=shape, device=device)
    model, opt = _fresh(inputs["cfg"], inputs["state"], device)
    replicate(model, mesh)
    step = make_halo_train_step(model, opt, mesh, inputs["strip"], inputs["strip"])
    img, gt = (shard_batch(inputs[k][:shape[0] * inputs["strip"]].to(device), mesh, "spatial")
               for k in ("halo_img", "halo_gt"))
    (loss, metrics), launches = _counted(lambda: step(img, gt), device)
    return _train_result(model, opt, loss, torch.stack(metrics).cpu(), launches,
                         dist.get_rank())


def _mesh_dp_halo_step(inputs, shape, device, reps):
    import torch.distributed as dist
    from tpu_unet_torch.parallel import make_dp_halo_train_step, make_mesh, replicate, shard_batch

    mesh = make_mesh(axes=("data", "spatial"), shape=shape, device=device)
    model, opt = _fresh(inputs["cfg"], inputs["state"], device)
    replicate(model, mesh)
    step = make_dp_halo_train_step(model, opt, mesh, inputs["strip"], inputs["strip"])

    def block(x):        # P('data', 'spatial', None)
        x = shard_batch(x.to(device), mesh, "data").transpose(0, 1)
        return shard_batch(x, mesh, "spatial").transpose(0, 1)

    imgs, gts = block(inputs["mesh_imgs"]), block(inputs["mesh_gts"])
    (loss, metrics), launches = _counted(lambda: step(imgs, gts), device)
    return _train_result(model, opt, loss, torch.stack(metrics).cpu(), launches,
                         dist.get_rank())


def _tier_fns(inputs, model, device):
    """{tier: the apply_fn TileInference serves it through (None: the model)}."""
    from tpu_unet_torch.infer.quant import QuantInference

    return {"bf16": None,
            "int8": QuantInference(inputs["qp8"], impl="pallas", device=device).apply,
            "int8-phase": QuantInference(inputs["qp8"], impl="pallas", phase_level0="int8",
                                         device=device).apply,
            "int4-phase": QuantInference(inputs["qp4"], impl="pallas", phase_level0="int8",
                                         device=device).apply}


def _mesh_tiles(inputs, shape, device, reps):
    import torch.distributed as dist
    from tpu_unet_torch.infer import TileInference
    from tpu_unet_torch.parallel import make_mesh

    mesh = make_mesh(axes=("data",), shape=shape, device=device)
    model, _ = _fresh(inputs["cfg"], inputs["state"], device)
    images, labels = inputs["images"].to(device), inputs["labels"].to(device)
    side = images.shape[-1]
    out = {}
    for tier, apply_fn in _tier_fns(inputs, model, device).items():
        if tier not in inputs["tiers"]:
            continue
        eng = TileInference(model, side, side, tile_out=inputs["tile_out"], mesh=mesh,
                            apply_fn=apply_fn)
        (metrics, preds), launches = _counted(lambda: eng.evaluate_batch(images, labels),
                                              device)
        out[tier] = {"metrics": metrics.cpu(), "launches": launches, "ms": _mesh_ms(
            lambda: eng.evaluate_batch(images, labels), device, reps)}
        if dist.get_rank() == 0:
            out[tier]["preds"] = preds.cpu()
    return out


MESH_PATHS = {"dp_step": _mesh_dp_step, "halo_inference": _mesh_halo_inference,
              "halo_step": _mesh_halo_step, "dp_halo_step": _mesh_dp_halo_step,
              "tiles": _mesh_tiles}


def mesh_rank_main(spec_path: str) -> None:
    """One rank of a phase 23 group (`chip_smoke.py --mesh-rank SPEC`): join
    the group from torchrun's variables, drive the spec's paths, save this
    rank's results beside the spec."""
    import torch.distributed as dist
    from tpu_unet_torch.parallel import initialize_multihost

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    torch.backends.cudnn.allow_tf32 = False        # as the single-process runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if not initialize_multihost(backend=spec["backend"], device=device,
                                timeout=datetime.timedelta(seconds=spec["timeout_s"])):
        raise RuntimeError("no rank variables: start through phase 23")
    rank = dist.get_rank()
    inputs = torch.load(spec["inputs"], weights_only=False)
    results = {}
    for path, shape in spec["paths"].items():
        t0 = time.perf_counter()
        results[path] = MESH_PATHS[path](inputs, tuple(shape), device, spec["reps"])
        if rank == 0:
            log(f"rank 0 of {spec['name']}: {path} in {time.perf_counter() - t0:.1f} s")
    torch.save(results, os.path.join(spec["dir"], f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_mesh_group(name, backend, world, paths, inputs_path, out_dir):
    """Start `world` ranks of this script, wait for all of them (at most
    MESH_TIMEOUT_S), stop every one still running, and return their results;
    a rank that fails or a group that hangs raises, with each rank's log."""
    os.makedirs(out_dir, exist_ok=True)
    spec = {"name": name, "backend": backend, "device": DEVICE, "paths": paths,
            "inputs": inputs_path, "dir": out_dir, "reps": MESH_REPS,
            "timeout_s": MESH_TIMEOUT_S}
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                       PYTHONPATH=os.pathsep.join([HERE] + [p for p in [
                           os.environ.get("PYTHONPATH")] if p]))
            logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank", spec_path],
                cwd=HERE, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if failed or time.perf_counter() - t0 > MESH_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    wall = time.perf_counter() - t0
    if any(rc != 0 for rc in rcs):
        for r in range(len(procs)):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            print(f"--- {name} rank {r} (exit {rcs[r]}) ---\n{tail}", flush=True)
        raise AssertionError(f"phase 23: group {name} ({backend}, {world} ranks) failed or "
                             f"hung: exit codes {rcs} after {wall:.1f} s")
    log(f"phase 23: group {name} ({backend}, {world} ranks on {torch.cuda.device_count()} "
        f"card(s)) done in {wall:.1f} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


MESH_LOSS_RTOL = 1e-3          # the train steps' loss: the gradient sums' order only
# the train steps' per-sample metrics (class maps of the same logits): equal
# but for pixels whose top-2 margin lies within the forward's rounding
MESH_METRIC_ATOL = 1e-3


def _windows(img, n, strip):
    """[n * strip, strip] -> the n strips' mirror-padded windows
    [n, strip + 184, strip + 184, 1], as the halo exchange builds them."""
    from tpu_unet_torch.ops.pad import reflect_pad

    pad = (TILE_IN - TILE_OUT) // 2
    padded = reflect_pad(img, pad)
    return torch.stack([padded[i * strip:i * strip + strip + 2 * pad]
                        for i in range(n)])[..., None]


def _mesh_inputs(cfg, served_state, data, qp8, qp4, n_dp, n_strips, strip):
    """What every rank reads: the served weights, `n_dp` DIC-HeLa samples,
    an image of `n_strips` strips and two of 2 strips (normalized) with
    their labels, the serving set, both quant parameter sets."""
    from tpu_unet_torch.config import DATASETS
    from tpu_unet_torch.data import synthetic_dataset
    from tpu_unet_torch.data.augment import AugmentPipeline

    train = _train_data()
    arrays = [torch.from_numpy(a).to(DEVICE) for a in (
        train.images, train.targets, train.crop_log_probs, train.crop_pairs)]
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    inp, gt = AugmentPipeline(DATASETS["DIC-C2DH-HeLa"].augment())(
        *arrays, np.arange(n_dp) % len(train), gen)

    def images(n, rows, seed):
        d = synthetic_dataset(n_images=n, h=rows, w=strip, crop=strip, seed=seed)
        lo = d.images.min(axis=(1, 2), keepdims=True)
        img = (d.images - lo) / np.maximum(d.images.max(axis=(1, 2), keepdims=True) - lo, 1e-12)
        return (torch.from_numpy(img.astype(np.float32)),
                torch.from_numpy((d.targets > 127).astype(np.int32)))

    halo_img, halo_gt = images(1, n_strips * strip, 231)
    mesh_imgs, mesh_gts = images(2, 2 * strip, 232)
    return {"cfg": cfg, "state": served_state, "strip": strip, "tile_out": TILE_OUT,
            "dp_inp": inp.cpu(), "dp_gt": gt.cpu(), "halo_img": halo_img[0],
            "halo_gt": halo_gt[0], "mesh_imgs": mesh_imgs, "mesh_gts": mesh_gts,
            "images": torch.from_numpy(data.images),
            "labels": torch.from_numpy((data.targets > 127).astype(np.uint8)),
            "qp8": qp8, "qp4": qp4, "tiers": MESH_TIERS}


def _single_train(inputs, kind, n):
    """The single-process counterpart of a mesh train step, from the same
    weights: (loss, metrics, momentum, ms per step or None)."""
    from tpu_unet_torch.losses.bce import binary_cross_entropy
    from tpu_unet_torch.losses.weights import class_balance, make_weight_fn
    from tpu_unet_torch.train.trainer import make_train_step

    model, opt = _fresh(inputs["cfg"], inputs["state"], DEVICE)
    if kind == "dp_step":
        step = make_train_step(model, make_weight_fn("distance"), "intended", opt)
        inp, gt = inputs["dp_inp"][:n].to(DEVICE), inputs["dp_gt"][:n].to(DEVICE)
        loss, metrics = step(inp, gt)
        out = (loss.item(), metrics.cpu(), _momentum(model, opt))
        return out + (_mesh_ms(lambda: step(inp, gt), DEVICE, MESH_REPS),)
    # the halo steps' oracle: every strip's window in one batch, class balance
    # per image, the mean over all pixels (kind 'halo_step': one image of n
    # strips; 'dp_halo_step': the 2 images of 2 strips each)
    s = inputs["strip"]
    if kind == "halo_step":
        imgs, gts = inputs["halo_img"][None, :n * s], inputs["halo_gt"][None, :n * s]
    else:
        imgs, gts = inputs["mesh_imgs"], inputs["mesh_gts"]
    imgs, gts = imgs.to(DEVICE), gts.to(DEVICE)
    n_s = imgs.shape[1] // s
    windows = torch.cat([_windows(i, n_s, s) for i in imgs])
    opt.zero_grad(set_to_none=True)
    logits = model(windows).reshape(*gts.shape, -1)
    loss = (class_balance(gts)[..., None] * binary_cross_entropy(logits, gts)).mean()
    loss.backward()
    opt.step()
    with torch.no_grad():
        p, g = logits.argmax(-1) != 0, gts != 0
        inter, union = (p & g).sum((1, 2)).float(), (p | g).sum((1, 2)).float()
        pe = (logits.argmax(-1) - gts).abs().sum((1, 2)).float() / float(n_s * s * s)
        if kind == "halo_step":
            metrics = torch.stack([inter[0] / union[0], pe[0]])
        else:
            metrics = torch.stack([(inter / union.clamp_min(1.0)).mean(), pe.mean()])
    return loss.item(), metrics.cpu(), _momentum(model, opt), None


def _momentum_err(got, want) -> float:
    """The worst tensor's relative L2 error (phase 7's measure)."""
    return max(((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)).item()
               for n in want)


def _check_mesh_launches(where, got, want, failed):
    """Per rank: each kernel's (launches, sm90 launches) as `want` has them
    (absent: none), K2 at least once and all on sm90 where want names it
    with None."""
    for kernel in MESH_KERNELS:
        w = want.get(kernel, (0, 0))
        g = tuple(got[kernel])
        ok = (g[0] >= 1 and g[1] == g[0]) if w is None else g == w
        if not ok:
            failed.append(f"{where}: {kernel} launches {g}, want "
                          f"{'>= 1, all sm90' if w is None else w}")


def phase23_mesh(smi, cfg, served_state, data, qp8, qp4):
    """The mesh paths in rank processes (NCCL one rank per card; gloo, 2
    ranks sharing the card and a 2 x 2 mesh of 4), each result held against
    this process's run on the same card: train steps at MESH_LOSS_RTOL and
    STEP_GRAD_TOL (momentum after one step), halo logits and served maps bit
    for bit, every rank's parameters and momentum bit-equal, launches by
    route per rank. Times of ranks sharing one card are not a scaling
    figure. Returns a summary dict."""
    from tpu_unet_torch.infer import TileInference

    t_phase = time.perf_counter()
    world_nccl = torch.cuda.device_count() if DEVICE == "cuda" else 1
    strip = TILE_OUT
    root = os.path.join(HERE, "build", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    groups = mesh_groups(world_nccl)
    sizes = {path: max([math.prod(paths[path]) for _, _, _, paths in groups if path in paths],
                       default=1) for path in MESH_PATHS}
    inputs = _mesh_inputs(cfg, served_state, data, qp8, qp4, 2 * sizes["dp_step"],
                          max(sizes["halo_inference"], sizes["halo_step"]), strip)
    inputs_path = os.path.join(root, "inputs.pt")
    torch.save(inputs, inputs_path)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True           # as in the ranks

    # the single-process runs, from the same weights and inputs
    single = {}
    for name, _, world, paths in groups:
        for path, shape in paths.items():
            n = math.prod(shape)
            if (path, n) in single or path == "tiles":
                continue
            if path == "halo_inference":
                model, _ = _fresh(cfg, served_state, DEVICE)
                windows = _windows(inputs["halo_img"][:n * strip].to(DEVICE), n, strip)
                with torch.inference_mode():
                    fwd = lambda: model(windows).reshape(n * strip, strip, -1)  # noqa: E731
                    single[(path, n)] = (fwd().cpu(), _mesh_ms(fwd, DEVICE, MESH_REPS))
            else:
                single[(path, n)] = _single_train(inputs, path, 2 * n if path == "dp_step"
                                                  else n)
    model, _ = _fresh(cfg, served_state, DEVICE)
    images, labels = inputs["images"].to(DEVICE), inputs["labels"].to(DEVICE)
    side = images.shape[-1]
    for tier, apply_fn in _tier_fns(inputs, model, DEVICE).items():
        eng = TileInference(model, side, side, tile_out=TILE_OUT, apply_fn=apply_fn)
        metrics, preds = eng.evaluate_batch(images, labels)
        single[("tiles", tier)] = (metrics.cpu(), preds.cpu(), _mesh_ms(
            lambda: eng.evaluate_batch(images, labels), DEVICE, MESH_REPS))
    n_tiles = len(data) * eng.plan.num_tiles
    del model, eng
    torch.backends.cudnn.deterministic = deterministic
    if DEVICE == "cuda":
        torch.cuda.empty_cache()           # leave the card's memory to the ranks

    failed, summary, launches = [], {}, {}
    for name, backend, world, paths in groups:
        ranks = run_mesh_group(name, backend, world, paths, inputs_path,
                               os.path.join(root, name))
        cards = torch.cuda.device_count() if DEVICE == "cuda" else 0
        # ranks that share a card: their times are no scaling figure
        timing = ("shared-card" if world > cards else "one rank a card")
        res = summary[name] = {"backend": backend, "ranks": world, "cards": cards,
                               "timing": timing}
        for path, shape in paths.items():
            n = math.prod(shape)
            got = ranks[0][path]
            where = f"{name} {path} {shape}"
            if path in ("dp_step", "halo_step", "dp_halo_step"):
                loss, metrics, momentum, ms = single[(path, n)]
                err = _momentum_err(got["momentum"], momentum)
                metric_err = (got["metrics"] - metrics).abs().max().item()
                res[path] = {"loss": got["loss"], "single_loss": loss, "momentum_rel_err": err,
                             "metrics_max_abs_err": metric_err,
                             "replicated": [r[path]["replicated"] for r in ranks]}
                if not abs(got["loss"] - loss) <= MESH_LOSS_RTOL * abs(loss):
                    failed.append(f"{where}: loss {got['loss']!r}, single {loss!r}")
                if not err <= STEP_GRAD_TOL:
                    failed.append(f"{where}: momentum relative error {err:.3g}")
                if not metric_err <= MESH_METRIC_ATOL:
                    failed.append(f"{where}: metrics differ by {metric_err:.3g}")
                if not all(res[path]["replicated"]):
                    failed.append(f"{where}: ranks' parameters or momentum differ "
                                  f"{res[path]['replicated']}")
                if path == "dp_step":
                    res[path].update(ms=[r[path]["ms"] for r in ranks], single_ms=ms)
                    log(f"phase 23: {where}: step {res[path]['ms']} ms a rank ({timing}) "
                        f"against {ms} ms for the global batch of {2 * n} in one process")
                want = dict(MESH_FORWARD_LAUNCHES, **(
                    {"edt_column_pass": None} if path == "dp_step" else {}))
                lines = [(path, want, [r[path]["launches"] for r in ranks])]
                log(f"phase 23: {where}: loss {got['loss']!r} (single process {loss!r}), "
                    f"momentum within {err:.3g} of its norm, metrics within {metric_err:.3g}, "
                    f"ranks' state bit-equal {res[path]['replicated']}")
            elif path == "halo_inference":
                want_logits, ms = single[(path, n)]
                diff = (got["logits"] - want_logits).abs().max().item()
                scale = want_logits.abs().max().item()
                equal = torch.equal(got["logits"], want_logits)
                maps = torch.equal(got["logits"].argmax(-1), want_logits.argmax(-1))
                res[path] = {"bit_equal": equal, "max_abs_err": diff, "class_maps_equal": maps,
                             "ms": [r[path]["ms"] for r in ranks], "single_ms": ms}
                if not (equal or (diff <= BF16_TOL * scale and maps)):
                    failed.append(f"{where}: logits differ by {diff:.3g} (scale {scale:.3g}), "
                                  f"class maps equal {maps}")
                lines = [(path, MESH_FORWARD_LAUNCHES, [r[path]["launches"] for r in ranks])]
                log(f"phase 23: {where}: logits [{n * strip}, {strip}, 2] "
                    f"{'equal' if equal else f'within {diff:.3g}'} to the single-process "
                    f"windows'; {timing} ms {res[path]['ms']} against {ms} in one process")
            else:
                res[path], lines = {}, []
                for tier in MESH_TIERS:
                    metrics, preds, ms = single[("tiles", tier)]
                    same = [np.array_equal(r[path][tier]["metrics"].numpy(), metrics.numpy(),
                                           equal_nan=True) for r in ranks]
                    maps = torch.equal(got[tier]["preds"], preds)
                    ms_mesh = [r[path][tier]["ms"] for r in ranks]
                    res[path][tier] = {
                        "class_maps_equal": maps, "metrics_equal": same,
                        "tiles_per_s": n_tiles / (ms_mesh[0] / 1e3),
                        "single_tiles_per_s": n_tiles / (ms / 1e3)}
                    if not (maps and all(same)):
                        failed.append(f"{where} {tier}: class maps equal {maps}, metrics "
                                      f"equal per rank {same}")
                    lines.append((f"{path}_{tier}", MESH_TIER_LAUNCHES[tier],
                                  [r[path][tier]["launches"] for r in ranks]))
                    log(f"phase 23: {where} evaluate_batch {tier}: maps and metrics "
                        f"{'equal' if maps and all(same) else 'DIFFER'} on every rank; "
                        f"{res[path][tier]['tiles_per_s']:.1f} tiles/s {timing} against "
                        f"{res[path][tier]['single_tiles_per_s']:.1f} in one process")
            for key, want, per_rank in lines:
                for r, got_launches in enumerate(per_rank):
                    _check_mesh_launches(f"{name} rank {r} {key}", got_launches, want, failed)
                launches[f"{name}_{key}"] = per_rank[0]
    shutil.rmtree(root, ignore_errors=True)
    if failed:
        raise AssertionError("phase 23 failed:\n  " + "\n  ".join(failed))
    log(f"phase 23: ok in {time.perf_counter() - t_phase:.1f} s ({smi.splitlines()[0]}; "
        f"times of ranks sharing one card are not a scaling figure)")
    return {"groups": summary, "launches": launches}


# (name, source, the TPU kernel it replaces, the formulation it runs on)
RESEARCH_KERNELS = [
    ("enc0_chain", "tpu_unet_torch/csrc/enc0_chain.cu", "tpu_unet/ops/fused_level0.py:136",
     "fused"),
    ("concat_quantize", "tpu_unet_torch/csrc/concat_quantize.cu",
     "tpu_unet/ops/fused_level0.py:273", "fused"),
    ("pair_batch_channels", "tpu_unet_torch/csrc/interleave.cu",
     "tpu_unet/ops/interleave.py:42", "pair"),
    ("unpair_batch_channels", "tpu_unet_torch/csrc/interleave.cu",
     "tpu_unet/ops/interleave.py:73", "pair"),
    ("interleave_pairs", "tpu_unet_torch/csrc/interleave.cu",
     "tpu_unet/ops/interleave.py:101", "pair"),
]


def _k4_routes(launches, times):
    """The K4 line's keys by route: per-chunk times of both in turns, and the
    research fused path's launches by route."""
    fused = launches["fused"]
    return {"ms_by_route": {"sm90": times["enc0_chain"]["kernel"],
                            "simple": times["enc0_chain"]["simple"]},
            "launches_by_route": {"serve_int8_research_fused": {
                "sm90": fused["enc0_chain_sm90"],
                "simple": fused["enc0_chain"] - fused["enc0_chain_sm90"]}},
            "sources": ["tpu_unet_torch/csrc/enc0_chain.cu", "tpu_unet_torch/csrc/enc0_conv1.cuh",
                        "tpu_unet_torch/csrc/conv3x3_sm90.cuh"]}


def research_kernel_lines(errs, launches, times, tiles_s):
    return [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[path][name],
        "max_abs_err": errs[name],
        "ms": times[name]["kernel"],
        "plain_ms": times[name]["plain"],
        "bound_ms": times[name]["bound"],
        "bound_by": times[name]["bound_by"],
        "library_ms": times[name]["library"],
        "launches_by_path": {f"serve_int8_research_{path}": launches[path][name]},
        "evaluate_tiles_per_s": tiles_s,
        **(_k4_routes(launches, times) if name == "enc0_chain" else {}),
    } for name, source, replaces, path in RESEARCH_KERNELS]


# (name, key in the phase's errors, its timed forms (the first is the
# line's), the pallas_calls and kernel bodies it stands for)
STAGE_KERNELS = [
    ("enc0_conv1_stage", "conv1", ["conv1"],
     "scripts/tpu_mosaic_probe.py:49 (k_conv1 :61)",
     ["scripts/tpu_mosaic_probe3.py:60 (A :77, G :208, H :252)"]),
    ("enc0_conv2_stage", "conv2", ["conv2 f32", "conv2 relu_bf16"],
     "scripts/tpu_mosaic_probe.py:49 (k_pair :75)",
     ["scripts/tpu_mosaic_probe3.py:60 (B :110, C :131, D :154, G :208, H :252)"]),
    ("enc0_pool_quant_stage", "pool_quant", ["pool", "pool + int8 skip"],
     "scripts/tpu_mosaic_probe.py:49 (k_pool :102, k_q8 :112, k_multi :121)",
     ["scripts/tpu_mosaic_probe3.py:60 (E :176, F :192, G :208, H :252)"]),
]


def stage_kernel_lines(errs, times, launches):
    chunk = f"bf16 x [{BATCH_TILES},{TILE_IN},{TILE_IN},1], C {ENC0_C}"
    return [{
        "name": name,
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/enc0_stages.cu",
        "sources": ["tpu_unet_torch/csrc/enc0_stages.cu"] + {
            "conv1": ["tpu_unet_torch/csrc/enc0_conv1.cuh"],
            "conv2": ["tpu_unet_torch/csrc/conv3x3_sm90.cuh"]}.get(key, []),
        "replaces": replaces,
        "replaces_also": also,
        "launches": launches[name],
        "max_abs_err": errs[key],
        "ms": times[forms[0]]["kernel"],
        "plain_ms": times[forms[0]]["plain"],
        "bound_ms": times[forms[0]]["bound"],
        "bound_by": times[forms[0]]["bound_by"],
        "library_ms": times[forms[0]]["library"],
        "launches_by_path": {"mosaic_probe": launches[name]},
        "shape": f"{forms[0]} at K4's serving chunk, {chunk}",
        "forms": {k: times[k] for k in forms},
    } for name, key, forms, replaces, also in STAGE_KERNELS]


def _mesh_paths(mesh, name):
    """{'mesh_<group>_<path>': launches per rank} of kernel `name` on phase
    23's paths that launch it (rank 0's count; every rank's is gated)."""
    return {f"mesh_{key}": counts[name][0] for key, counts in mesh["launches"].items()
            if counts[name][0]}


def _by_route(launches, name):
    """{route: launches} of kernel `name` from a {name, name_sm90} count."""
    return {"sm90": launches[f"{name}_sm90"],
            "simple": launches[name] - launches[f"{name}_sm90"]}


def end_to_end(tiles_s, research_tiles_s, step_ms):
    """The three end-to-end paths this script times in turns (recorded, no
    claim), each with its device's idle share: 1 - the profiler's device
    busy time per call over the call's time with CUDA events, unprofiled
    (the profiler's own window also holds its host overhead)."""
    float_ms, fused_ms = tiles_s["pallas ms"], research_tiles_s["research fused ms"]
    fused_busy = research_tiles_s["research fused profiled_ms_per_call"]["device_busy"]
    return {
        "float_serving_pallas": {"tiles_per_s": tiles_s["pallas"], "ms": float_ms,
                                 "idle_share": 1.0 - tiles_s["pallas profiled_busy_ms"] / float_ms},
        "research_fused": {"tiles_per_s": research_tiles_s["research fused"], "ms": fused_ms,
                           "idle_share": 1.0 - fused_busy / fused_ms},
        "train_step_pallas": {"ms": step_ms["pallas"]["step"],
                              "idle_share": 1.0 - step_ms["pallas"]["profiled_busy_ms"]
                              / step_ms["pallas"]["step"]}}


TRANSUNET_DECODER_CALLS = 9


def _draw_batchnorms(model, seed: int) -> None:
    """The decoder's BatchNorm affines and running statistics drawn from
    `seed` (scales 1 + 0.1 N, shifts and means 0.1 N, variances
    exp(0.2 N)), so that each folded bias is off 0 and off the bf16 grid."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.startswith("decoder.") and name.split(".")[-2] == "1":
                z = torch.randn(t.shape, generator=gen, device=DEVICE)
                t.copy_(torch.exp(0.2 * z) if name.endswith("running_var")
                        else (name.endswith("weight") + 0.1 * z))
    model.prepare()


@torch.inference_mode()
def phase24_transunet_decoder():
    """K1 at the TransUNet decoder's nine shapes, each on its input as an
    eager forward of one 16-slice chunk computes it, against its plain
    version; then the launches of one eager forward. Returns (max |err|,
    {'conv3x3_bias_relu', 'attention'}: launches a forward)."""
    import tpu_unet_torch.models.transunet as tu
    from tpu_unet_torch.config import TransUNetConfig
    from tpu_unet_torch.ops.attention import attention
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu, conv3x3_bias_relu_plain

    cfg = TransUNetConfig(conv_impl="pallas")
    with torch.device(DEVICE):
        model = tu.TransUNet(cfg, generator=torch.Generator(device=DEVICE).manual_seed(4))
    model.cuda_graphs = False
    _draw_batchnorms(model, 5)
    s = cfg.img_size
    x = torch.rand(BATCH_TILES, s, s, 1, device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(6))
    calls = []

    def keeping(xb, w, b):
        calls.append((xb, w, b))
        return conv3x3_bias_relu(xb, w, b)
    tu.conv3x3_bias_relu = keeping
    try:
        model(x)
    finally:
        tu.conv3x3_bias_relu = conv3x3_bias_relu
    if len(calls) != TRANSUNET_DECODER_CALLS:
        raise AssertionError(f"{len(calls)} K1 calls a forward, not {TRANSUNET_DECODER_CALLS}")
    max_err = 0.0
    for i, (xb, w, b) in enumerate(calls):
        if b.dtype != torch.float32 or w.dtype != torch.bfloat16 or xb.dtype != torch.bfloat16:
            raise AssertionError(f"call {i}: x {xb.dtype}, w {w.dtype}, b {b.dtype}")
        if torch.equal(b.to(torch.bfloat16).float(), b):
            raise AssertionError(f"call {i}: the folded bias is bf16-exact")
        sm90 = conv3x3_bias_relu.sm90_launches
        got = conv3x3_bias_relu(xb, w, b)
        route = "sm90" if conv3x3_bias_relu.sm90_launches > sm90 else "simple"
        cin, cout = w.shape[2:]
        if route != _route_of(cin):
            raise AssertionError(f"call {i}: Cin {cin} took the {route} route")
        ref = conv3x3_bias_relu_plain(xb, w, b)
        if got.dtype != torch.bfloat16 or got.shape != ref.shape:
            raise AssertionError(f"call {i}: {got.dtype} {tuple(got.shape)}, want "
                                 f"{tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        bar = BF16_TOL * max(ref.float().abs().max().item(), 1.0)
        if not err <= bar:
            raise AssertionError(f"call {i} x{list(xb.shape)} -> {cout}: max |err| {err} > {bar}")
        max_err = max(max_err, err)
        log(f"phase 24: decoder conv {i} x{list(xb.shape)} -> {cout} ({route}), f32 bias: "
            f"max|err| {err:.3g} (bound {bar:.3g})")
        del got, ref
    del calls
    conv3x3_bias_relu.launches, attention.launches = 0, 0
    model(x)
    launches = {"conv3x3_bias_relu": conv3x3_bias_relu.launches,
                "attention": attention.launches}
    if launches != {"conv3x3_bias_relu": TRANSUNET_DECODER_CALLS,
                    "attention": cfg.layers}:
        raise AssertionError(f"an eager forward launched {launches}")
    log(f"phase 24: ok, the nine decoder convs within {BF16_TOL} of their scale; an eager "
        f"forward launches K1 {launches['conv3x3_bias_relu']} and attention "
        f"{launches['attention']} times")
    return max_err, launches


def main() -> None:
    smi = phase1_device()
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
    model, data, qp, int8_launches, int8_k1 = phase10_serve_int8(cfg)
    k3_total, int8_tiles_s = phase11_time_int8(cfg, model, data, qp)
    del model
    research_errs = phase12_research_kernels()
    model, qp, research_launches = phase13_serve_research(cfg, data)
    research_tiles_s, research_ms = phase14_time_research(model, data, qp)
    kxk_err = phase15_kxk_vs_plain(cfg)
    qp_phase, phase_launches, phase_agree = phase16_serve_int8_phase(cfg, model, data, qp)
    phase_tiles_s, kxk_ms, phase_train_ms, probe, probe_launches = phase17_time_phase(
        cfg, model, data, qp, qp_phase)
    served_state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    gather_err, gather_ms, gather_probe, gather_launches = phase18_gather()
    stage_errs, stage_ms, mosaic_probe, stage_launches = phase19_enc0_stages()
    cli_runs, cli_errs = phase20_cli(smi, cfg, served_state)
    int4 = phase21_int4(cfg, served_state, data, qp)
    conv_bwd = phase22_conv_bwd(cfg)
    from tpu_unet_torch.infer.quant import load_quant_params
    qp4 = load_quant_params(os.path.join(HERE, "build", "chip_smoke_int4.npz"))
    mesh = phase23_mesh(smi, cfg, served_state, data, qp, qp4)
    transunet_err, transunet_launches = phase24_transunet_decoder()
    cli_launches = {name: {k: v[0] for k, v in r["launches"].items()}
                    for name, r in cli_runs.items() if "launches" in r}
    band_key = f"num_valid [5, 0], band {EDT_BAND}"
    live_key = f"all 64 planes live, band {EDT_BAND}"
    # the two JSON lines are printed bare (no time stamp), to be parsed whole
    print(json.dumps({"kernels": [{
        "name": "conv3x3_bias_relu",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv3x3_bias_relu.cu",
        "replaces": "tpu_unet/ops/conv_pallas.py:57",
        "launches": launches["conv3x3_bias_relu"],
        "max_abs_err": max_err,
        "max_abs_err_transunet_decoder": transunet_err,
        "ms": total["kernel"],
        "plain_ms": total["plain"],
        "bound_ms": total["bound"],
        "bound_by": total["bound_by"],
        "library_ms": total["cudnn"],
        "backward_route": "library",
        "launches_by_path": {"serve": sum(serve_launches.values()),
                             "train": launches["conv3x3_bias_relu"],
                             "cli_test_pallas": cli_launches["TESTING pallas bf16"][
                                 "conv3x3_bias_relu"],
                             "serve_int8_float": int8_k1["launches"],
                             "serve_transunet": transunet_launches["conv3x3_bias_relu"],
                             "serve_int4_float": int4["launches"]["serve_int4_float"][0],
                             "serve_int4_calibration": int4["launches"][
                                 "serve_int4_calibration"][0],
                             **_mesh_paths(mesh, "conv3x3_bias_relu")},
        "launches_by_route": {"serve": serve_launches,
                              "train": {"sm90": launches["conv3x3_bias_relu_sm90"],
                                        "simple": launches["conv3x3_bias_relu"]
                                        - launches["conv3x3_bias_relu_sm90"]}},
        "ms_by_route": {"sm90_at_its_17_shapes": total["sm90"],
                        "simple_at_the_17_shapes": total["simple_at_sm90_shapes"],
                        "simple_at_all_18": total["simple"],
                        "cudnn_at_the_17_shapes": total["cudnn_at_sm90_shapes"],
                        "bound_at_the_17_shapes": total["bound_sm90"]},
        "per_shape": total["per_shape"],
        "sources": ["tpu_unet_torch/csrc/conv3x3_bias_relu.cu",
                    "tpu_unet_torch/csrc/conv3x3_sm90.cuh"],
        "grad_max_rel_err": grad_err,
        "f32_bias_max_abs_err": {"int8_float_convs": int8_k1["k1_vs_plain"],
                                 "int8_conv_f_vs_library": int8_k1["conv_f_vs_library"]},
        "cli_max_abs_err": cli_errs["conv3x3_bias_relu"],
        "evaluate_tiles_per_s": tiles_s,
    }, {
        "name": "edt_column_pass",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/edt_column_pass.cu",
        "replaces": "tpu_unet/ops/edt_pallas.py:102",
        "launches": launches["edt_column_pass"],
        "max_abs_err": edt_err,
        "ms": edt_ms[band_key]["per_call"]["sm90"],
        "plain_ms": edt_ms[band_key]["plain"],
        "bound_ms": edt_ms[band_key]["bound"],
        "bound_by": edt_ms[band_key]["bound_by"],
        "library_ms": None,
        "device_ms": edt_ms[band_key]["device"]["sm90"],
        "all_live": {k: edt_ms[live_key][k] for k in ("bound", "bound_by")}
        | {"device_ms": edt_ms[live_key]["device"]["sm90"],
           "ms": edt_ms[live_key]["per_call"]["sm90"]},
        "routes": {"sm90": "column_pass (edt_batch)",
                   "simple": "_column_pass_route_forward only"},
        "launches_by_path": {"train": launches["edt_column_pass"],
                             "cli_train": cli_launches["TRAINING"]["edt_column_pass"],
                             **_mesh_paths(mesh, "edt_column_pass")},
        "launches_by_route": {"train": {"sm90": launches["edt_column_pass_sm90"],
                                        "simple": launches["edt_column_pass"]
                                        - launches["edt_column_pass_sm90"]}},
        "ms_by_case": edt_ms,
        "train_step_device_ms": step_ms["pallas"]["profiled_k2_group_ms"],
    }, {
        "name": "conv3x3_fused",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv3x3_fused.cu",
        "replaces": "tpu_unet/ops/conv_tiles.py:155",
        "launches": sum(int8_launches.values()),
        "max_abs_err": k3_err,
        "ms": k3_total["kernel"],
        "plain_ms": k3_total["plain"],
        "bound_ms": k3_total["bound"],
        "bound_by": k3_total["bound_by"],
        "library_ms": k3_total["library"],
        "bf16_max_abs_err": k3_bf16_err,
        "cli_max_abs_err": cli_errs["conv3x3_fused"],
        "launches_by_path": {"serve_int8": sum(int8_launches.values()),
                             "serve_int8_phase": phase_launches["conv3x3_fused"],
                             **{f"serve_int8_research_{k}": v["conv3x3_fused"]
                                for k, v in research_launches.items()},
                             "cli_test_pallas_int8": cli_launches["TESTING pallas int8"][
                                 "conv3x3_fused"],
                             "cli_test_pallas_int8_phase": cli_launches[
                                 "TESTING pallas int8-phase"]["conv3x3_fused"],
                             "serve_int4": int4["launches"]["serve_int4"][0],
                             **_mesh_paths(mesh, "conv3x3_fused")},
        "launches_by_route": {
            "serve_int8": int8_launches,
            "serve_int4": {"sm90": int4["launches"]["serve_int4"][1],
                           "simple": int4["launches"]["serve_int4"][0]
                           - int4["launches"]["serve_int4"][1]},
            "serve_int8_phase": _by_route(phase_launches, "conv3x3_fused"),
            **{f"serve_int8_research_{k}": _by_route(v, "conv3x3_fused")
               for k, v in research_launches.items()}},
        "ms_by_route": {"sm90": k3_total["kernel"], "simple": k3_total["simple"]},
        "per_shape": k3_total["per_shape"],
        "sources": ["tpu_unet_torch/csrc/conv3x3_fused.cu", "tpu_unet_torch/csrc/conv_fused.cuh",
                    "tpu_unet_torch/csrc/conv3x3_sm90.cuh"],
        "evaluate_tiles_per_s": int8_tiles_s,
    }] + research_kernel_lines(research_errs, research_launches, research_ms,
                               research_tiles_s) + [{
        "name": "conv_kxk_fused",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/conv_kxk_fused.cu",
        "replaces": "scripts/tpu_deep_shootout_r4.py:111",
        "replaces_also": "scripts/tpu_deep_shootout_r4.py:184",
        "launches": phase_launches["conv_kxk_fused"],
        "max_abs_err": kxk_err,
        "cli_max_abs_err": cli_errs["conv_kxk_fused"],
        "ms": kxk_ms["kernel"],
        "plain_ms": kxk_ms["plain"],
        "bound_ms": kxk_ms["bound"],
        "bound_by": kxk_ms["bound_by"],
        "library_ms": kxk_ms["library"],
        "launches_by_path": {"serve_int8_phase": phase_launches["conv_kxk_fused"],
                             "probe": probe_launches,
                             "cli_test_pallas_int8_phase": cli_launches[
                                 "TESTING pallas int8-phase"]["conv_kxk_fused"],
                             "serve_int4_phase": int4["launches"]["serve_int4_phase"][0],
                             **_mesh_paths(mesh, "conv_kxk_fused")},
        "launches_by_route": {"serve_int8_phase": _by_route(phase_launches, "conv_kxk_fused")},
        "ms_by_route": {"sm90": kxk_ms["kernel"], "simple": kxk_ms["simple"]},
        "per_shape": kxk_ms["per_shape"],
        "sources": ["tpu_unet_torch/csrc/conv_kxk_fused.cu", "tpu_unet_torch/csrc/conv_fused.cuh",
                    "tpu_unet_torch/csrc/conv3x3_sm90.cuh"],
        "evaluate_tiles_per_s": phase_tiles_s,
        "class_map_agreement_vs_int8": phase_agree,
        "probe": [{k: r[k] for k in ("section", "route", "ms", "tops")} for r in probe],
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "tpu_unet_torch/csrc/row_gather.cu",
        "replaces": "scripts/tpu_gather_probe.py:116",
        "replaces_also": ["scripts/tpu_gather_probe.py:130", "scripts/tpu_gather_probe.py:155"],
        "launches": gather_launches,
        "max_abs_err": gather_err,
        "ms": gather_ms["C 2"]["kernel"],
        "plain_ms": gather_ms["C 2"]["plain"],
        "bound_ms": gather_ms["C 2"]["bound"],
        "bound_by": gather_ms["C 2"]["bound_by"],
        "library_ms": gather_ms["C 2"]["library"],
        "launches_by_path": {"gather_probe": gather_launches},
        "device_ms": gather_ms["C 2"]["kernel_device"],
        "library_device_ms": gather_ms["C 2"]["library_device"],
        "shape": f"{GATHER_S ** 2} rows of C 2 from [{GATHER_S ** 2}, 2]",
        "ms_by_case": gather_ms,
        "probe": [{k: r[k] for k in ("section", "label", "route", "ms")} for r in gather_probe],
    }] + stage_kernel_lines(stage_errs, stage_ms, stage_launches),
        "enc0_chain_at_chunk_ms": stage_ms["chain"],
        "staged_chain_pooled_equal_k4": stage_ms["staged_pooled_equal_k4"],
        "mosaic_probe": [{k: r[k] for k in ("section", "name", "ms")} for r in mosaic_probe],
        "end_to_end": end_to_end(tiles_s, research_tiles_s, step_ms),
        "train_step_ms": step_ms, "step_pallas_vs_xla_grad_rel_err": step_err,
        "phase_level0_train_step_ms": phase_train_ms,
        "cli_runs": cli_runs, "cli_served_logits_max_abs_err": cli_errs["served_logits"],
        "int4": int4, "conv_bwd": conv_bwd, "mesh": mesh["groups"]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(sys.argv[2])
    else:
        main()
