"""The comparison that decides `correct` in a TransUNet serving cell, as
serve_check.py's for the U-Net: each sampled request's slice logits (as
the timed path computed them), class maps and metrics against the f32
reference (transunet.py) on the same slices.

* ``logit_err_vs_control``: the RMS gap between the program's logits and
  the f32 reference's over the RMS gap between the control's (the
  reference with every conv and linear input and weight in fp8) and the
  reference's; worst request. The control reads 1;
* ``token_err_vs_control``: the same ratio at the ViT's output, the
  encoded tokens after its final LN (`TransUNet.encode` of the request's
  slices), which holds the trunk and the ViT, attention included, to the
  reference where the logits, through the decoder's convs, hold them
  loosely;
* ``map_vs_own_logits``: pixels of the returned maps that differ from the
  argmax of the program's own logits of their slice (exact ties left out);
* ``metrics_off``: returned (IoU, pixel error) values off those computed
  from the returned maps (`transunet.metrics`).

``logit_rel_rms``, ``control_rel_rms``, ``token_rel_rms`` and
``control_token_rel_rms`` (each gap over the f32 logits' or tokens' RMS)
are reported beside them and not compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmarks.reference import serve_check as sc
from benchmarks.reference import transunet as rtu


def map_vs_own_logits(ids: Dict[int, np.ndarray], maps: np.ndarray) -> int:
    """Pixels of `maps` [N, S, S] that differ from `ids` ({slice: argmax of
    its logits, -1 where tied}, `serve_check.tile_ids`) where not tied."""
    return int(sum(((maps[i] != want) & (want >= 0)).sum() for i, want in ids.items()))


def metrics_off(maps: np.ndarray, labels: np.ndarray, got: np.ndarray) -> int:
    want = rtu.metrics(maps, labels)
    same = np.isclose(got.astype(np.float64), want, rtol=0.0, atol=sc.METRICS_TOL,
                      equal_nan=True)
    return int((~same).sum())


def judge(samples: List[dict], params: Dict[str, torch.Tensor], mcfg: dict, device,
          quant, block: int) -> Dict[str, float]:
    """`samples`: dicts with 'frames', 'labels', 'maps' [N, S, S], 'metrics'
    [N, 2] as returned, 'logits' [N, S, S, C] and 'tokens' [N, T, hidden]
    (host arrays), and 'ids' where a control put its own maps in place.
    `quant`: the control's hook."""
    worst: Dict[str, float] = {}
    flips, off = 0, 0
    with rtu.exact_f32():
        for s in samples:
            x = torch.from_numpy(rtu.slices(s["frames"])).to(device)
            f32, f32_tok = (t.double().cpu().numpy() for t in
                            rtu.forward_blocks(params, x, mcfg, block, tokens=True))
            ctl, ctl_tok = (t.double().cpu().numpy() for t in
                            rtu.forward_blocks(params, x, mcfg, block, quant, tokens=True))
            got, tok = s["logits"].astype(np.float64), s["tokens"].astype(np.float64)
            scale, tok_scale = sc._rms(f32), sc._rms(f32_tok)
            r = {"logit_err_vs_control": sc._rms(got - f32) / sc._rms(ctl - f32),
                 "token_err_vs_control": sc._rms(tok - f32_tok) / sc._rms(ctl_tok - f32_tok),
                 "logit_rel_rms": sc._rms(got - f32) / scale,
                 "control_rel_rms": sc._rms(ctl - f32) / scale,
                 "token_rel_rms": sc._rms(tok - f32_tok) / tok_scale,
                 "control_token_rel_rms": sc._rms(ctl_tok - f32_tok) / tok_scale}
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
            ids = s.get("ids") or sc.tile_ids(range(len(got)), s["logits"])
            flips += map_vs_own_logits(ids, s["maps"])
            off += metrics_off(s["maps"], s["labels"], s["metrics"])
    return dict(worst, map_vs_own_logits=flips, metrics_off=off)


def control_sample(s: dict, params, mcfg: dict, device, quant, block: int) -> dict:
    """The sample a control puts in the program's place: its logits and
    tokens in the lower precision over the same slices, the logits' argmax
    maps and the metrics of those maps."""
    with rtu.exact_f32():
        x = torch.from_numpy(rtu.slices(s["frames"])).to(device)
        lg, tok = (t.cpu().numpy() for t in
                   rtu.forward_blocks(params, x, mcfg, block, quant=quant, tokens=True))
    maps = lg.argmax(-1).astype(np.int32)
    return dict(s, logits=lg, tokens=tok, maps=maps, ids=None,
                metrics=rtu.metrics(maps, s["labels"]))
