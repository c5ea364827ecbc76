"""Run K4's pieces as stage kernels on the card, each against its oracle.

    python -m tpu_unet_torch.probes.mosaic_probe [--device cuda|cpu]

The port's counterpart of ``scripts/tpu_mosaic_probe.py`` and
``scripts/tpu_mosaic_probe3.py`` (their ``main``), which compile K4's
pieces one at a time at the block (bh, bw, c) = (8, 512, 64). Here every
piece runs through the stage kernels of `ops.enc0_stages`, with random
data from a seeded ``torch.Generator``, in the scripts' order:

  probe 1: conv1-bcast, pair-dot, pool-strided, int8-store, multi-out
           (each against the stage's plain version);
  probe 3: A conv1 as a 9-tap product, B/C/D conv2 with the weights in the
           nconcat, rows3 and im2col layouts, E/F the pool (one pass here),
           G the chain conv1 -> conv2 -> ReLU -> bf16 skip + pool, H the
           chain with an int8 skip at 37.5 (A-F against the script's own
           oracle at its atol; G and H against the script's kernel
           ``k_chain`` written out in PyTorch, stage by stage: h1, the bf16
           skip and the pool within one bf16 ulp, H's int8 skip within 1,
           since the stages quantize bf16(h2) where the script quantizes the
           f32 h2; the script's atol is printed beside them);
  then K4 (`ops.fused_level0.enc0_chain`) at the script's four sizes and K5
  (`concat_quantize`) at its four sizes with their `block_rows`, each
  against its plain version;
  and the staged chain at K4's serving chunk (bf16 x [16, 572, 572, 1],
  C = 64): conv1 -> conv2 (ReLU, bf16) -> pool + int8 skip at K4's scale,
  three launches, held against K4 (b2 = 0: the stages have no conv2 bias;
  the pooled maps equal bit for bit, since K4's sm90 route and the conv2
  stage issue one MMA step on the same h1)
  and timed in turns with K4 and the library level 0 (the production int8
  forward's: two cuDNN convs in TF32 on bf16 values, the quantize and the
  pool).

Each line gives the route's ms (CUDA events after a warm-up; "not timed"
on the CPU), its max |err| against the oracle or plain version, and
``** MISMATCH **`` beyond the bar; the exit code is 1 on any mismatch.
With ``--device cpu`` (or ``run(device="cpu")``) it runs untimed on the
CPU, where the wrappers take their plain versions; the default needs a
card and raises RuntimeError without one.
"""

from __future__ import annotations

import argparse
import contextlib
import math
from typing import Callable, List

import torch
import torch.nn.functional as F

from tpu_unet_torch.models.unet import _max_pool2
from tpu_unet_torch.ops import enc0_stages as st
from tpu_unet_torch.ops import fused_level0
from tpu_unet_torch.ops.conv_tiles import _scalar, quantize_activations, tf32_for_bf16_values
from tpu_unet_torch.probes import log, time_ms

BLOCK = (8, 512, 64)
# (batch, n, block_cols): x [batch, n, n, 1] (tpu_mosaic_probe.py:142-147)
K4_CASES = ((1, 68, 64), (1, 260, 256), (1, 1372, 512), (8, 1372, 512))
# (batch, m, block_rows): halves [batch, m, m, 64] (tpu_mosaic_probe.py:149-153)
K5_CASES = ((1, 72, 8), (1, 328, 8), (8, 1192, 8), (8, 1192, 16))
# (batch, n, C): K4's serving chunk, x [batch, n, n, 1]
CHUNK = (16, 572, 64)
# bf16 outputs of kernel and plain version: summation order and the last
# bf16 rounding, 2e-2 of the output's scale (chip_smoke.py's BF16_TOL)
BF16_TOL = 2e-2
REPS = 5


@contextlib.contextmanager
def _no_tf32():
    """The oracles' and plain versions' f32 convs in full f32."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _max_err(got, ref) -> List[float]:
    errs = []
    for g, r in zip(_tuple(got), _tuple(ref)):
        if g.shape != r.shape:
            errs.append(math.inf)
        else:
            errs.append((g.float() - r.float()).abs().max().item() if g.numel() else 0.0)
    return errs


def _bf16_bar(ref) -> float:
    return BF16_TOL * max(ref.float().abs().max().item(), 1.0)


def _bf16_ulps(got, ref) -> float:
    """Max |got - ref| in units of one bf16 ulp of `ref` (2^(e - 8) for
    |ref| = m 2^e, m in [0.5, 1)) plus 1e-5 of the output's scale (values
    near 0, whose sign the f32 sums' order decides)."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        return math.inf
    _, e = torch.frexp(r)
    unit = torch.ldexp(torch.ones_like(r), e - 8) + 1e-5 * max(r.abs().max().item(), 1.0)
    return ((g - r).abs() / unit).max().item() if g.numel() else 0.0


def _library_level0(x, w1, b1, w2, b2, scale):
    """The production int8 forward's level 0 through the library
    (`QuantInference._conv_f`'s expression off K1, twice, the int8 capture
    of the skip and the pool)."""
    def conv(v, w, b):
        with tf32_for_bf16_values():
            y = F.conv2d(v.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                         w.float().permute(3, 2, 0, 1))
        return torch.relu(y.permute(0, 2, 3, 1) + b).to(torch.bfloat16)
    h2 = conv(conv(x, w1, b1), w2, b2)
    return quantize_activations(h2, _scalar(scale, x.device)), _max_pool2(h2)


@torch.inference_mode()
def run(device: str = "cuda", seed: int = 0) -> List[dict]:
    """Run every section at the sizes BLOCK, K4_CASES, K5_CASES and CHUNK
    (None: no chunk section); returns one record per line: section, name,
    ms (None when untimed), err (max |err| per output), bar, mismatch."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('the mosaic probe times the card and finds no CUDA device; '
                           'pass device="cpu" (--device cpu) to run it untimed on the CPU')
    with _no_tf32():
        return _run(device, seed)


def _run(device: str, seed: int) -> List[dict]:
    gen = torch.Generator(device=device).manual_seed(seed)
    bh, bw, c = BLOCK
    out: List[dict] = []

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def line(section: str, name: str, fn: Callable, ref_fn: Callable, bars,
             ulps=(), note: str = "") -> None:
        """One route against its reference: max |err| per output, or, for
        the outputs numbered in `ulps`, its error in bf16 ulps (bar 1)."""
        got, ref = fn(), ref_fn()
        errs = _max_err(got, ref)
        bars = [b(r) if callable(b) else b
                for b, r in zip(_tuple(bars) * len(errs), _tuple(ref))][:len(errs)]
        for k in ulps:
            errs[k], bars[k] = _bf16_ulps(_tuple(got)[k], _tuple(ref)[k]), 1.0
        bad = any(not e <= b for e, b in zip(errs, bars))
        del got, ref
        ms = time_ms(fn, device, REPS)
        shown = ", ".join(f"{e:.2e}{' ulp' if k in ulps else ''} (bar {b:.2e})"
                          for k, (e, b) in enumerate(zip(errs, bars)))
        log(f"  {name:34s}: " + (f"{ms:9.4f} ms" if ms is not None else "not timed")
            + f"  max|err|={shown}" + note + ("  ** MISMATCH **" if bad else ""))
        out.append({"section": section, "name": name, "ms": ms, "err": errs, "bar": bars,
                    "mismatch": bad})

    log(f"probe 1: the pieces at block ({bh}, {bw}, {c}), against the plain versions")
    x = torch.rand((1, bh + 4, bw + 4), generator=gen, device=device)
    w9 = normal(9, c, scale=0.5)
    line("probe1", "conv1-bcast", lambda: st.conv1_stage(x, w9),
         lambda: st.conv1_stage_plain(x, w9), _bf16_bar)
    h = torch.relu(normal(1, bh + 2, bw + 2, c, scale=0.5)).to(torch.bfloat16)
    wp = normal(5, 2 * c, c, scale=0.05).to(torch.bfloat16)
    w_pair = st.hwio_from_pair(wp)
    line("probe1", "pair-dot", lambda: st.conv2_stage(h, w_pair, relu_bf16=True),
         lambda: st.conv2_stage_plain(h, w_pair, relu_bf16=True), _bf16_bar)
    hb = torch.rand((1, bh, bw, c), generator=gen, device=device).to(torch.bfloat16)
    line("probe1", "pool-strided-ref", lambda: st.pool_quant_stage(hb)[1],
         lambda: st.pool_quant_stage_plain(hb)[1], 0.0)
    line("probe1", "int8-store",
         lambda: st.pool_quant_stage(hb, skip="int8", skip_scale=50.0, pool=False)[0],
         lambda: st.pool_quant_stage_plain(hb, skip="int8", skip_scale=50.0, pool=False)[0],
         0.0)
    h2 = x[:, :bh, :bw, None].expand(1, bh, bw, c)
    line("probe1", "multi-out+scratch", lambda: st.pool_quant_stage(h2, skip="bf16"),
         lambda: st.pool_quant_stage_plain(h2, skip="bf16"), 0.0)
    del x, w9, h, wp, w_pair, hb, h2

    log("probe 3: the reformulated pieces, against the script's oracles")
    rows, cols = bh + 2, bw + 2
    slab9 = normal(1, rows, cols, 9)
    w9 = normal(9, c, scale=0.1)
    line("probe3", "A conv1-im2col-2Ddot", lambda: st.conv1_stage(slab9, w9, taps=True),
         lambda: torch.relu(torch.einsum("brct,tk->brck", slab9, w9)).to(torch.bfloat16),
         2e-2)
    h1 = torch.relu(normal(1, bh + 2, bw + 2, c, scale=0.5)).to(torch.bfloat16)
    w2 = normal(3, 3, c, c, scale=0.05).to(torch.bfloat16)

    def conv2_oracle():
        return F.conv2d(h1.float().permute(0, 3, 1, 2),
                        w2.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)

    w2cat = torch.zeros((3, c, 3 * 128), dtype=torch.bfloat16, device=device)
    for dy in range(3):
        for dx in range(3):
            w2cat[dy, :, dx * 128:dx * 128 + c] = w2[dy, dx]
    for name, w_hwio in (("B conv2-nconcat-pad128", st.hwio_from_nconcat(w2cat)),
                         ("C conv2-rows3-buf", st.hwio_from_rows3(w2.reshape(3, 3 * c, c))),
                         ("D conv2-im2col9", st.hwio_from_im2col(w2.reshape(9 * c, c)))):
        line("probe3", name, lambda w_=w_hwio: st.conv2_stage(h1, w_), conv2_oracle, 1e-1)
    hp = normal(1, bh, bw, c).abs().to(torch.bfloat16)

    def pool_oracle():
        return hp.float().reshape(1, bh // 2, 2, bw // 2, 2, c).amax(dim=(2, 4)).to(
            torch.bfloat16)

    line("probe3", "E pool-reshape-lanehalf", lambda: st.pool_quant_stage(hp)[1],
         pool_oracle, 0.0)
    line("probe3", "F pool-reshape-from-scratch", lambda: st.pool_quant_stage(hp)[1],
         pool_oracle, 0.0)
    slab9b = normal(1, bh + 4, bw + 4, 9)
    w_nc = st.hwio_from_nconcat(w2cat)

    held = {}

    def chain(int8_skip: bool):
        h1s = st.conv1_stage(slab9b[:, 1:bh + 3, 1:bw + 3], w9, taps=True)
        held["h1"] = h1s
        y = st.conv2_stage(h1s, w_nc, relu_bf16=True)
        if int8_skip:
            return (h1s,) + st.pool_quant_stage(y, skip="int8", skip_scale=37.5)
        return h1s, y, st.pool_quant_stage(y)[1]

    def k_chain(int8_skip: bool):
        """The script's k_chain / k_chain_q (tpu_mosaic_probe3.py:208-230,
        :252-275): h1 = bf16(relu(a1)); conv2 summed in f32 and ReLU; the
        skip and the pool taken from the f32 h2. conv2 reads the chain's
        own h1, held to A's oracle in the first output, so that an h1
        rounding flip (f32 sums in another order) is not carried into h2."""
        a1 = torch.einsum("brct,tk->brck", slab9b[:, 1:bh + 3, 1:bw + 3], w9)
        h1o = torch.relu(a1).to(torch.bfloat16)
        y = F.conv2d(held["h1"].float().permute(0, 3, 1, 2), w2.float().permute(3, 2, 0, 1))
        y = torch.relu(y.permute(0, 2, 3, 1))
        pool = y.reshape(1, bh // 2, 2, bw // 2, 2, c).amax(dim=(2, 4)).to(torch.bfloat16)
        if int8_skip:
            return h1o, torch.round(y * 37.5).clamp(0, 127).to(torch.int8), pool
        return h1o, y.to(torch.bfloat16), pool

    line("probe3", "G chain-conv1-conv2-pool", lambda: chain(False),
         lambda: k_chain(False), 1.0, ulps=(0, 1, 2), note="  (script atol 2e-1)")
    line("probe3", "H chain+int8skip", lambda: chain(True), lambda: k_chain(True),
         1.0, ulps=(0, 2), note="  (script atol none: H is only compiled)")
    del slab9, h1, w2, w2cat, hp, slab9b

    log("K4 and K5 at the script's sizes, against their plain versions")
    c4 = 64
    w1 = normal(3, 3, 1, c4, scale=0.5)
    b1 = normal(c4, scale=0.1)
    w2 = normal(3, 3, c4, c4, scale=math.sqrt(2 / (9 * c4)))
    b2 = normal(c4, scale=0.1)
    for bsz, n, bc in K4_CASES:
        x = torch.rand((bsz, n, n, 1), generator=gen, device=device)
        line("k4", f"enc0_chain {bsz}x{n} bc={bc}",
             lambda: fused_level0.enc0_chain(x, w1, b1, w2, b2, block_rows=8, block_cols=bc),
             lambda: fused_level0.enc0_chain_plain(x, w1, b1, w2, b2), _bf16_bar)
        del x
    for bsz, m, br in K5_CASES:
        a = ((torch.rand((bsz, m, m, c4), generator=gen, device=device) * 2.6 - 1.3)
             * 127 * 0.02).to(torch.bfloat16)
        line("k5", f"concat_quantize {bsz}x{m} br={br}",
             lambda: fused_level0.concat_quantize(a, a, 0.02, block_rows=br),
             lambda: fused_level0.concat_quantize_plain(a, a, 0.02), 0.0)
        del a
    if CHUNK is not None:
        out += _chunk_section(CHUNK, gen, device)
    log("done")
    return out


def _chunk_section(chunk, gen, device) -> List[dict]:
    """The staged chain at K4's serving chunk against K4, and the three
    routes' times in turns."""
    bsz, n, c = chunk
    log(f"the staged chain at K4's serving chunk: bf16 x [{bsz},{n},{n},1], C {c}")
    x = torch.rand((bsz, n, n, 1), generator=gen, device=device).to(torch.bfloat16)
    w1 = (torch.randn((3, 3, 1, c), generator=gen, device=device) * 0.5).to(torch.bfloat16)
    b1 = torch.randn((c,), generator=gen, device=device) * 0.1
    w2 = (torch.randn((3, 3, c, c), generator=gen, device=device)
          * math.sqrt(2 / (9 * c))).to(torch.bfloat16)
    b2 = torch.zeros((c,), device=device)
    scale = fused_level0.enc0_chain(x, w1, b1, w2, b2)[0].float().max().item() / 110.0
    inv = fused_level0._inverse(scale)
    w9 = w1.float().reshape(9, c)

    def staged():
        h1 = st.conv1_stage(x[..., 0], w9, b1)
        h2 = st.conv2_stage(h1, w2, relu_bf16=True)
        return st.pool_quant_stage(h2, skip="int8", skip_scale=inv)

    routes = {"staged chain (3 launches)": staged,
              "enc0_chain (K4)": lambda: fused_level0.enc0_chain(x, w1, b1, w2, b2,
                                                                 skip_scale=scale),
              "library level 0": lambda: _library_level0(x, w1, b1, w2, b2, scale)}
    (skip, pooled), (k_skip, k_pooled) = staged(), routes["enc0_chain (K4)"]()
    d = (skip.float() - k_skip.float()).abs()
    share = (d > 0).float().mean().item()
    errs = [d.max().item(), (pooled.float() - k_pooled.float()).abs().max().item()]
    bars = [1.0, _bf16_bar(k_pooled)]
    pooled_equal = bool(torch.equal(pooled, k_pooled))
    # the conv2 stage and K4 issue one MMA step on the same h1: equal pooled
    # maps are part of the bar
    bad = any(not e <= b for e, b in zip(errs, bars)) or not pooled_equal
    del skip, pooled, k_skip, k_pooled, d
    log(f"  staged chain vs K4: int8 skip max|err| {errs[0]:.0f} on a share {share:.3e} "
        f"(bar 1: the stages round h2 to bf16 before the quantize), pooled max|err| "
        f"{errs[1]:.2e} (bar {bars[1]:.2e}), pooled equal {pooled_equal} (bar: equal)"
        + ("  ** MISMATCH **" if bad else ""))
    times = {k: [] for k in routes}
    for key in list(routes) + list(reversed(routes)):
        times[key].append(time_ms(routes[key], device, REPS))
    out = []
    for key, ts in times.items():
        ms = None if ts[0] is None else sum(ts) / len(ts)
        log(f"  {key:34s}: " + (f"{ms:9.4f} ms (runs {[round(t, 4) for t in ts]})"
                                if ms is not None else "not timed"))
        rec = {"section": "chunk", "name": key, "ms": ms, "err": None, "bar": None,
               "mismatch": False}
        if key.startswith("staged"):
            rec.update(err=errs, bar=bars, mismatch=bad, int8_share_off_by_1=share,
                       pooled_equal=pooled_equal)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    results = run(device=args.device)
    bad = [r for r in results if r["mismatch"]]
    if bad:
        log(f"FAIL: lines beyond their bar: {[r['name'] for r in bad]}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
