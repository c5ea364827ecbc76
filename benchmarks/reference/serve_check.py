"""The comparison that decides `correct` in a serving cell.

For each sampled request the program hands over its tile logits (as the
timed path computed them, for the tiles this rank ran), the class maps and
the metrics it returned. The reference cuts the request's frames into
tiles itself, runs its f32 network over them and judges:

* ``logit_err_vs_control``: the RMS gap between the program's logits and
  the reference's (float32, or the integer tier the configuration states,
  worked out again), over the RMS gap between the control's (the
  reference one precision step below, lowp.py) and the reference's on the
  same tiles; worst request. The seed's weights scale
  both gaps alike, so the ratio holds still where each gap swings from
  seed to seed; the control reads 1;
* ``map_vs_own_logits``: pixels of the returned maps that differ from the
  argmax of the program's own logits of the tile that last wrote them
  (exact ties left out), summed; on a mesh every rank's returned maps are
  held to the argmax of the rank that ran each tile;
* ``metrics_off``: returned (IoU, pixel error) values off those the
  reference computes from the returned maps.

``logit_rel_rms``, ``control_rel_rms`` and, for an integer tier,
``stated_rel_rms`` (each gap to the f32 logits over their RMS) are
reported beside them and not compared.

`calibration_scales` works out the int8 tier's activation scales again.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmarks.reference import tiles as rt
from benchmarks.reference import unet as ru


def owner_map(plan: rt.Plan) -> np.ndarray:
    """[H, W]: the index of the tile that writes each pixel last."""
    own = np.zeros(plan.canvas, np.int64)
    to = plan.tile_out
    for i, (y, x) in enumerate(plan.origins):
        own[y:y + to, x:x + to] = i
    return own[:plan.h, :plan.w]


def tile_ids(tiles: Sequence[int], logits: np.ndarray) -> Dict[int, np.ndarray]:
    """{tile: argmax class of its logits [to, to, C], -1 where tied}."""
    out = {}
    for k, i in enumerate(tiles):
        top = np.sort(logits[k], axis=-1)
        out[int(i)] = np.where(top[..., -1] > top[..., -2], logits[k].argmax(-1), -1).astype(np.int8)
    return out


def map_vs_own_logits(plan: rt.Plan, ids: Dict[int, np.ndarray], maps: np.ndarray) -> int:
    """Pixels of `maps` [N, H, W] that differ from `ids` (`tile_ids`, the
    tiles numbered over the request) where that tile wrote last and is not
    tied."""
    own = owner_map(plan)
    to, t = plan.tile_out, plan.num_tiles
    bad = 0
    for i, want in ids.items():
        img, j = divmod(i, t)
        y, x = plan.origins[j]
        mask = own[y:y + to, x:x + to][:min(to, plan.h - y), :min(to, plan.w - x)] == j
        want = want[:mask.shape[0], :mask.shape[1]]
        got = maps[img, y:y + mask.shape[0], x:x + mask.shape[1]]
        bad += int(((got != want) & mask & (want >= 0)).sum())
    return bad


def metrics_off(maps: np.ndarray, labels: np.ndarray, got: np.ndarray) -> int:
    """Returned (IoU, pixel error) values more than `METRICS_TOL` from those
    the reference computes from the returned maps (NaN equal to NaN)."""
    want = rt.metrics(maps, labels)
    same = np.isclose(got.astype(np.float64), want, rtol=0.0, atol=METRICS_TOL, equal_nan=True)
    return int((~same).sum())


#: Both sides count the same pixels; the program divides in float32, which
#: rounds a ratio by at most 6e-8.
METRICS_TOL = 1e-6


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(a * a)))


def judge(samples: List[dict], params: Dict[str, torch.Tensor], mcfg: dict,
          plan: rt.Plan, device, quant, block: int = 4, ref_quant=None) -> Dict[str, float]:
    """`samples`: dicts with 'frames' [N, H, W], 'labels' [N, H, W], 'maps'
    [N, H, W] and 'metrics' [N, 2] as returned, 'tile_ids' and 'logits'
    [len(tile_ids), to, to, C] of this rank's tiles (host arrays), and on
    a mesh 'ids', every rank's `tile_ids` of its own tiles.
    `quant`: the control's hook; `ref_quant`: the hook of the precision the
    configuration states, where it is below float32."""
    worst: Dict[str, float] = {}
    flips, off = 0, 0
    with ru.exact_f32():
        for s in samples:
            x = torch.from_numpy(plan.tiles(s["frames"])[list(s["tile_ids"])]).to(device)
            f32 = ru.forward_blocks(params, x, mcfg, block).double().cpu().numpy()
            ctl = ru.forward_blocks(params, x, mcfg, block, quant).double().cpu().numpy()
            stated = f32 if ref_quant is None else \
                ru.forward_blocks(params, x, mcfg, block, ref_quant).double().cpu().numpy()
            got = s["logits"].astype(np.float64)
            scale = _rms(f32)
            r = {"logit_err_vs_control": _rms(got - stated) / _rms(ctl - stated),
                 "logit_rel_rms": _rms(got - f32) / scale,
                 "control_rel_rms": _rms(ctl - f32) / scale}
            if ref_quant is not None:
                r["stated_rel_rms"] = _rms(stated - f32) / scale
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
            ids = s.get("ids") or tile_ids(s["tile_ids"], s["logits"])
            flips += map_vs_own_logits(plan, ids, s["maps"])
            off += metrics_off(s["maps"], s["labels"], s["metrics"])
    return dict(worst, map_vs_own_logits=flips, metrics_off=off)


def control_sample(s: dict, params, mcfg: dict, plan: rt.Plan, device, quant,
                   block: int = 4) -> dict:
    """The sample a control puts in the program's place: its logits in the
    lower precision over the same tiles, its maps stitched from them and
    the metrics of those maps."""
    with ru.exact_f32():
        x = torch.from_numpy(plan.tiles(s["frames"])).to(device)
        lg = ru.forward_blocks(params, x, mcfg, block, quant=quant).cpu().numpy()
    maps = plan.stitch(lg.argmax(-1).astype(np.int32))
    return dict(s, logits=lg[list(s["tile_ids"])], maps=maps, ids=None,
                metrics=rt.metrics(maps, s["labels"]))


def calibration_scales(params, frames: np.ndarray, mcfg: dict, device,
                       size: int = 188) -> Dict[str, float]:
    """The int8 tier's activation scales, worked out again: each frame
    min/ptp normalised and centre-cropped to size x size; abs-max / 127 of
    the input, of each 3x3 conv's output after its ReLU, of each up-conv's
    and the head's output; each decoder concat at the larger scale of its
    two sources."""
    crops = []
    for f in frames:
        a = f.astype(np.float32)
        a = (a - a.min()) / max(float(np.ptp(a)), 1e-12)
        h, w = a.shape
        if h < size or w < size:
            a = np.pad(a, ((0, max(0, size - h)), (0, max(0, size - w))), mode="reflect")
            h, w = a.shape
        y0, x0 = (h - size) // 2, (w - size) // 2
        crops.append(a[y0:y0 + size, x0:x0 + size])
    x = torch.from_numpy(np.stack(crops)[..., None]).to(device)
    cap: Dict[str, torch.Tensor] = {}
    with ru.exact_f32(), torch.no_grad():
        ru.forward(params, x, mcfg, capture=cap)
    scales = {"input": float(x.abs().max()) / 127.0}
    for name, t in cap.items():
        scales[name] = max(float(t.abs().max()), 1e-6) / 127.0
    for d in range(mcfg["depth"]):
        scales[f"dec{d}_conv1:cat"] = max(scales[f"enc{d}_conv2"], scales[f"up{d}"])
    return scales


def calibration_amax(scales: Dict[str, float]):
    """({conv: abs-max of its input}, {conv: abs-max of its output}) on the
    calibration crops, from `calibration_scales`."""
    ins = {k[:-3]: v * 127.0 for k, v in scales.items() if k.endswith(":in")}
    return ins, {k: scales[k] * 127.0 for k in ins}


def calib_rel_err(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The largest |got / want - 1| over the scales the program keeps (the
    conv inputs' ``:in`` entries are the reference's alone); a scale the
    reference has and the program lacks reads inf."""
    return max(abs(got[k] / want[k] - 1.0) if k in got else float("inf")
               for k in want if not k.endswith(":in"))
