"""Time the gather mechanisms of the augmentation warp on the card.

    python -m tpu_unet_torch.probes.gather_probe [--size 572] [--device cuda|cpu]

The port's counterpart of ``scripts/tpu_gather_probe.py`` (its ``main``):
the same five sections at the same sizes (S = 572, S^2 = 327,184 points),
random data drawn from a seeded ``torch.Generator``:

  1. a take of S^2 points from a flat ``[S^2, C]`` source at C = 2, 8 and
     128; the 4-tap bilinear (C = 2); the stacked single take ``[S^2, 8]``;
  2. whole-row gathers of S and 2S rows of an ``[S, S]`` image;
  3. the in-kernel take and vector indexing (`ops.gather.take_rows`,
     `vecidx_rows`): 128 rows of a ``[4096, 128]`` source;
  4. the scalar row loop (`ops.gather.rowloop_rows`) at nrows 128 and 1024,
     on 1024 drawn indices (the script's ``run_rowloop(1024)`` reads past
     the 128 it passes);
  5. the fused warp `data.augment._fused_rotate_elastic_multi` of a
     ``[388, 388, 2]`` source onto an S^2 canvas, ``gather='take4'`` and
     ``'stacked'``.

Sections 1-4 run each gather through torch indexing (the script's XLA
route) and through the row-gather kernel (`ops.gather.row_gather`); every
kernel route must equal its torch route bit for bit, and in section 5
'stacked' must equal 'take4'. Each line gives the route's ms (CUDA events
after a warm-up; "not timed" on the CPU) and the share of values that
differ. The exit code is 1 when any share is not 0.

With ``--device cpu`` (or ``run(device="cpu")``) it runs untimed on the
CPU, where the kernel routes take their plain version; the default needs a
card and raises RuntimeError without one.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import torch

from tpu_unet_torch.data.augment import _fused_rotate_elastic_multi
from tpu_unet_torch.ops import gather
from tpu_unet_torch.ops.warp import elastic_fields
from tpu_unet_torch.probes import log, time_ms

SIZE = 572
# the elastic field's blur (sigma 10, radius 40) needs a canvas this wide
MIN_SIZE = 48
# the source of section 5 at S = 572 (the DIC-HeLa crop)
WARP_SOURCE = 388
SRC_ROWS = 4096
REPS = 20


def _differ(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of values of `a` that differ from `b` (1.0 for another shape)."""
    if a.shape != b.shape:
        return 1.0
    return (a != b).float().mean().item()


def _bilinear_4tap(take: Callable, s: torch.Tensor, i: torch.Tensor, size: int):
    v00, v01 = take(s, i), take(s, i + 1)
    v10, v11 = take(s, i + size), take(s, i + size + 1)
    return v00 * 0.25 + v01 * 0.25 + v10 * 0.25 + v11 * 0.25


def _bilinear_stacked(take: Callable, s: torch.Tensor, i: torch.Tensor, size: int):
    nb = torch.cat([s, torch.roll(s, -1, 0), torch.roll(s, -size, 0),
                    torch.roll(s, -(size + 1), 0)], dim=1)            # [S^2, 8]
    g = take(nb, i)
    return g[:, 0:2] * 0.25 + g[:, 2:4] * 0.25 + g[:, 4:6] * 0.25 + g[:, 6:8] * 0.25


def _torch_take(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return s[i]


@torch.inference_mode()
def run(size: int = SIZE, device: str = "cuda", seed: int = 0) -> List[dict]:
    """Run the five sections; returns one record per route: section,
    label, route, ms (None when untimed), mismatch (None for a reference
    route)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('the gather probe times the card and finds no CUDA device; '
                           'pass device="cpu" (--device cpu) to run it untimed on the CPU')
    gen = torch.Generator(device=device).manual_seed(seed)
    s, n_pts = size, size * size
    out: List[dict] = []

    def pair(section: int, label: str, ref_fn: Callable, fn: Callable,
             names=("torch", "kernel")) -> None:
        ref = ref_fn()
        got = fn()
        mismatch = _differ(got, ref)
        del ref, got
        for name, f, mm in ((names[0], ref_fn, None), (names[1], fn, mismatch)):
            ms = time_ms(f, device, REPS)
            log(f"  {label:44s} {name:8s}: "
                + (f"{ms:8.4f} ms" if ms is not None else "not timed")
                + (f"  mismatch={mm:.2e}" if mm is not None else ""))
            out.append({"section": section, "label": label, "route": name, "ms": ms,
                        "mismatch": mm})

    kernel_take = gather.row_gather
    idx = torch.randint(0, n_pts - s - 2, (n_pts,), generator=gen, device=device,
                        dtype=torch.int32)
    log(f"1. take of {n_pts} points, flat [S^2, C] source (S = {s}):")
    for c in (2, 8, 128):
        src = torch.rand((n_pts, c), generator=gen, device=device)
        pair(1, f"take C={c}", lambda: _torch_take(src, idx), lambda: kernel_take(src, idx))
        del src
    src2 = torch.rand((n_pts, 2), generator=gen, device=device)
    pair(1, "bilinear 4-tap C=2 (workload)",
         lambda: _bilinear_4tap(_torch_take, src2, idx, s),
         lambda: _bilinear_4tap(kernel_take, src2, idx, s))
    pair(1, "bilinear stacked 1-take C=2",
         lambda: _bilinear_stacked(_torch_take, src2, idx, s),
         lambda: _bilinear_stacked(kernel_take, src2, idx, s))
    del src2

    log(f"2. whole-row gathers of a [{s}, {s}] image:")
    img = torch.rand((s, s), generator=gen, device=device)
    for k in (1, 2):
        ridx = torch.randint(0, s - 1, (k * s,), generator=gen, device=device,
                             dtype=torch.int32)
        pair(2, f"take {k * s} rows", lambda: _torch_take(img, ridx),
             lambda: kernel_take(img, ridx))
    del img

    rows = min(SRC_ROWS, n_pts)
    srcp = torch.rand((rows, 128), generator=gen, device=device)
    ridx = torch.randint(0, rows, (1024,), generator=gen, device=device, dtype=torch.int32)
    log(f"3. in-kernel gather: 128 rows of a [{rows}, 128] source:")
    row = ridx[None, :128]
    pair(3, f"in-kernel take ({rows}x128 src, 128 idx)", lambda: _torch_take(srcp, row[0]),
         lambda: gather.take_rows(srcp, row))
    pair(3, "in-kernel vector ref index", lambda: _torch_take(srcp, row[0]),
         lambda: gather.vecidx_rows(srcp, row))
    log("4. scalar row loop (1024 drawn indices):")
    for nrows in (128, 1024):
        pair(4, f"row loop n={nrows}", lambda: _torch_take(srcp, ridx[:nrows]),
             lambda: gather.rowloop_rows(ridx, srcp, nrows))
    del srcp

    log("5. the fused warp itself:")
    side = max(4, size * WARP_SOURCE // SIZE)
    src = torch.rand((side, side, 2), generator=gen, device=device)
    dx, dy = elastic_fields((s, s), 200.0, 10.0, generator=gen)
    angle = torch.tensor(30.0, device=device)
    pair(5, f"fused warp {s}^2 (1 sample, 2ch)",
         lambda: _fused_rotate_elastic_multi(src, angle, dx, dy, s, order=1, gather="take4"),
         lambda: _fused_rotate_elastic_multi(src, angle, dx, dy, s, order=1, gather="stacked"),
         names=("take4", "stacked"))
    log("done")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=SIZE, help="the warp canvas S")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.size < MIN_SIZE:
        ap.error(f"--size must be at least {MIN_SIZE}")
    results = run(args.size, args.device)
    bad = [r for r in results if r["mismatch"]]
    if bad:
        log(f"FAIL: routes that differ from their reference: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
