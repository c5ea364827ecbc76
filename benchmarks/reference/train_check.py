"""The comparison that decides `correct` in a training cell.

The program hands over, for its first steps (driven through the window's
own call), the augmented inputs and labels, the weight maps, the losses,
its optimizer's momentum after step 1 (the first gradient as SGD got it)
and the parameters after the last step checked. The reference redraws the
weights from the seed and follows the same steps in float32 (TF32 off):
its own crops (augment.py), its own weight maps (weightmap.py), the plain
U-Net (unet.py), the weighted BCE and SGD with momentum. It imports
nothing of the program. Numbers:

* ``aug_input_err``: the largest gap between the program's inputs and the
  reference's; ``aug_label_flips``: labels that differ, summed;
* ``weight_map_err``: the largest gap between the program's weight maps
  and the reference's map of the program's labels, over w0;
* ``loss_rel_err``: the largest relative gap of a step's loss;
* ``grad_norm_err``: the worst leaf's gap between the norms of the
  program's first gradient and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``update_norm_err``: the same of the parameters' change over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both norm gaps: they move by round-off alone.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmarks.reference import augment as ra
from benchmarks.reference import unet as ru
from benchmarks.reference.weightmap import weight_map


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                 half_batch: bool = False) -> torch.Tensor:
    """Mean of w * BCE over [B, h, w, 2] logits against one-hot labels;
    `half_batch` (a planted fault) takes the mean over the first half."""
    y = labels.float()
    z = torch.stack([1.0 - y, y], -1)
    x = logits.float()
    bce = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    loss = weights[..., None] * bce
    if half_batch:
        loss = loss[:max(1, loss.shape[0] // 2)]
    return loss.mean()


def reference_steps(params0: Dict[str, torch.Tensor], data: dict, steps: Sequence[tuple],
                    seed: int, mcfg: dict, aug: dict, loss: dict, optim: dict, device,
                    quant=None, half_batch: bool = False) -> dict:
    """Follow `steps` [(epoch, step in epoch, frame indices)] from `params0`.
    `data`: host arrays 'images', 'targets', 'log_probs' (device tensor),
    'pairs'. Returns inputs, labels, maps, losses, the first gradient and
    the parameters after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    bufs: Dict[str, torch.Tensor] = {}
    out: dict = {"inp": [], "gt": [], "w": [], "loss": []}
    size, crop = aug["size"], aug["crop"]
    with ru.exact_f32():
        for k, (epoch, b, idx) in enumerate(steps):
            gen = torch.Generator(device=device).manual_seed(ra.batch_seed(seed, epoch, b))
            inps, gts = [], []
            for i in idx:
                d = ra.draw(gen, data["log_probs"][i], size, aug["rotate_step"], aug["skip"])
                a, g = ra.augment_one(data["images"][i], data["targets"][i], data["pairs"],
                                      d, crop, size, aug["alpha"], aug["sigma"])
                inps.append(a)
                gts.append(g)
            inp, gt = np.stack(inps).astype(np.float32), np.stack(gts)
            w = np.stack([weight_map(g, loss["w0"], loss["sigma2"], loss["max_objects"])
                          for g in gts]).astype(np.float32)
            out["inp"].append(inp)
            out["gt"].append(gt)
            out["w"].append(w)
            x = torch.from_numpy(inp[..., None]).to(device)
            logits = ru.forward(params, x, mcfg, quant)
            logits = ru.center_crop(logits.permute(0, 3, 1, 2), crop, crop).permute(0, 2, 3, 1)
            lv = weighted_bce(logits, torch.from_numpy(gt).to(device),
                              torch.from_numpy(w).to(device), half_batch)
            grads = torch.autograd.grad(lv, list(params.values()))
            out["loss"].append(float(lv.detach()))
            with torch.no_grad():
                for (name, p), g in zip(params.items(), grads):
                    bufs[name] = g.clone() if name not in bufs else bufs[name].mul_(
                        optim["momentum"]).add_(g)
                    p.sub_(optim["lr"] * bufs[name])
            if k == 0:
                out["g1"] = {n: t.clone() for n, t in bufs.items()}
    out["theta"] = {n: p.detach() for n, p in params.items()}
    return out


def _norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> float:
    gn = {n: float(got[n].double().norm()) for n in keep}
    wn = {n: float(want[n].double().norm()) for n in keep}
    med = float(np.median(list(wn.values())))
    return max(abs(gn[n] - wn[n]) / max(wn[n], med) for n in keep)


def judge(prog: dict, ref: dict, params0: Dict[str, torch.Tensor], w0: float,
          loss: dict) -> Dict[str, float]:
    """`prog`: the program's 'inp', 'gt', 'w', 'loss' per step, 'g1' and
    'theta' by leaf name (host arrays and tensors)."""
    inp_err = max(float(np.abs(p - r).max()) for p, r in zip(prog["inp"], ref["inp"]))
    flips = sum(int((p != r).sum()) for p, r in zip(prog["gt"], ref["gt"]))
    wm_err = 0.0
    for gts, ws in zip(prog["gt"], prog["w"]):
        for g, w in zip(gts, ws):
            want = weight_map(g, loss["w0"], loss["sigma2"], loss["max_objects"])
            wm_err = max(wm_err, float(np.abs(w - want).max()) / w0)
    loss_err = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    gnorm = {n: float(g.double().norm()) for n, g in ref["g1"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = [n for n, v in gnorm.items() if v >= 1e-3 * med]
    dp = {n: prog["theta"][n].float() - params0[n] for n in keep}
    dr = {n: ref["theta"][n].float() - params0[n] for n in keep}
    return {"aug_input_err": inp_err, "aug_label_flips": flips, "weight_map_err": wm_err,
            "loss_rel_err": loss_err,
            "grad_norm_err": _norm_gap(prog["g1"], ref["g1"], keep),
            "update_norm_err": _norm_gap(dp, dr, keep)}
