"""Time the int8 deep serving convs on the card, route by route.

    python -m tpu_unet_torch.probes.deep_shootout [--batch 16] [--section N] [--only ...]

The port's counterpart of ``scripts/tpu_deep_shootout_r4.py`` (its
``main``): the same four sections at the same shapes, random int8 data
drawn from a seeded ``torch.Generator``, alpha = 1e-4, beta = 0:

  1. enc1_conv2          3x3 int8 128->128 @ 762^2
  2. dec1_conv1          3x3 int8 256->128 @ 678^2
  3. dec0_conv1 packed   2x2 int8 256->256 @ 676^2
  4. dec0_conv2 packed   2x2 int8 256->256 @ 675^2

In each section it times, with CUDA events after a warm-up, the library
route (`ops.conv_tiles.conv3x3_int8_xla`: im2col + ``torch._int_mm``, the
script's ``xla-int8``), K3 at the 3x3 shapes (`ops.conv_tiles.conv3x3_fused`,
the script's ``pallas-nconcat``) and the fused k x k kernel through both of
its wrapper names (`ops.conv_kxk.conv2x2_fused`, `conv_rows3_col`), with the
tiling arguments the script passes (they steer nothing here). Each line
gives ms, T/s (2 k^2 Cin Cout operations per output pixel) and the share of
outputs that differ from the library route's, which must be 0: the exit
code is 1 otherwise. `--section` runs one section (0: all); `--only` keeps
the routes whose names contain one of its comma-separated parts.
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, List, Optional

import torch

from tpu_unet_torch.ops.conv_kxk import conv2x2_fused, conv_rows3_col
from tpu_unet_torch.ops.conv_tiles import conv3x3_fused, conv3x3_int8_xla
from tpu_unet_torch.probes import log, time_ms

# section -> (label, k, H = W, Cin, Cout)
SECTIONS = {
    1: ("enc1_conv2", 3, 762, 128, 128),
    2: ("dec1_conv1", 3, 678, 256, 128),
    3: ("dec0_conv1 packed", 2, 676, 256, 256),
    4: ("dec0_conv2 packed", 2, 675, 256, 256),
}
REPS = 5
DEVICE = "cuda"


def _routes(section: int) -> Dict[str, Callable]:
    """The routes the script times in `section`, by its names; the library
    route first."""
    routes = {"xla-int8": functools.partial(conv3x3_int8_xla, out_kind="int8")}
    if section == 1:
        for var in ("nconcat", "rows3", "im2col"):
            routes[f"pallas-{var}-br8"] = functools.partial(
                conv3x3_fused, out_kind="int8", block_rows=8, cout_tile=128, variant=var)
        cols = ((8, 256), (16, 128), (8, 128))
    elif section == 2:
        routes["pallas-nconcat-br16"] = functools.partial(
            conv3x3_fused, out_kind="int8", block_rows=16, cout_tile=128, variant="nconcat")
        cols = ((8, 256), (16, 128))
    elif section == 3:
        for var in ("im2col4", "rows2"):
            routes[f"pallas-{var}-br8"] = functools.partial(
                conv2x2_fused, block_rows=8, variant=var)
        cols = ((8, 256), (16, 128))
    else:
        cols = ((8, 256),)
    kind = "rows3col" if section <= 2 else "rows2col"
    for br, wc in cols:
        routes[f"pallas-{kind}-{br}x{wc}"] = functools.partial(
            conv_rows3_col, block_rows=br, block_cols=wc,
            cout_tile=128 if section <= 2 else 256)
    return routes


def _data(batch: int, h: int, cin: int, cout: int, k: int, seed: int):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randint(-127, 128, (batch, h, h, cin), generator=gen, device=DEVICE,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device=DEVICE,
                      dtype=torch.int8)
    alpha = torch.full((cout,), 1e-4, device=DEVICE)
    return x, w, alpha, torch.zeros((cout,), device=DEVICE)


@torch.inference_mode()
def run(batch: int = 16, section: int = 0, only: str = "") -> List[dict]:
    """Time every route of the chosen sections; returns one record per
    route: section, label, route, ms, tops, mismatch (None for the library
    route itself)."""
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the deep-shootout probe times the card: no CUDA device")
    keep = [s for s in only.split(",") if s]
    out = []
    for sec, (label, k, h, cin, cout) in SECTIONS.items():
        if section not in (0, sec):
            continue
        log(f"== {label}  {k}x{k} int8 {cin}->{cout} @ {h}^2  batch {batch} ==")
        args = _data(batch, h, cin, cout, k, seed=sec)
        ops = 2 * batch * (h - k + 1) ** 2 * k * k * cin * cout
        ref: Optional[torch.Tensor] = None
        for name, fn in _routes(sec).items():
            if name != "xla-int8" and keep and not any(s in name for s in keep):
                continue
            y = fn(*args)
            mismatch = None
            if ref is None:
                ref = y
            else:
                mismatch = (y != ref).float().mean().item()
            del y
            ms = time_ms(lambda: fn(*args), DEVICE, REPS)
            tops = None if ms is None else ops / ms / 1e9
            log(f"  {name:26s}: " + (f"{ms:8.3f} ms  {tops:7.1f} T/s" if ms is not None
                                     else "not timed")
                + (f"  mismatch={mismatch:.2e}" if mismatch is not None else ""))
            out.append({"section": sec, "label": label, "route": name, "ms": ms,
                        "tops": tops, "mismatch": mismatch})
        del args, ref
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    log("done")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--section", type=int, default=0, choices=[0, *SECTIONS],
                    help="1..4 runs one shape only; 0 runs all")
    ap.add_argument("--only", default="",
                    help="comma-separated substrings of the route names to time beside "
                         "the library route")
    args = ap.parse_args(argv)
    results = run(args.batch, args.section, args.only)
    bad = [r for r in results if r["mismatch"]]
    if bad:
        log(f"FAIL: routes that differ from the library route: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
