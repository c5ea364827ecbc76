"""The reference in the precision a configuration states, and one step
below it: the controls that `correct` has to reject. Each is a `quant(name,
role, t)` hook for `reference.unet.forward`.

* 'fp8' (below bf16): every conv's input and weight rounded to
  float8_e4m3fn, each tensor scaled so its largest magnitude lands on 448,
  the format's largest value; the sums stay f32.
* an integer tier, worked out again from the layers its configuration
  lists (`quant.layers`, {conv: grid}): each listed conv takes its grid's
  weights (per output channel) and inputs and outputs (per tensor at the
  abs-max the calibration crops give, clipped beyond it); every other
  layer bfloat16 inputs, weights and outputs, with float32 sums. The
  control of such a tier puts every listed conv on the grid one step
  below ('int4' below 'int8').

The grids (`GRIDS`): 'int8', 127 levels either side; 'int4', 7 levels for
the weights, 15 for an activation after a ReLU, 7 either side for a
signed one.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


class _RoundGrad(torch.autograd.Function):
    """Identity in the forward; the backward rounds the incoming gradient
    to float8_e5m2 (per tensor at its abs-max over 57344), as a float8
    training step carries it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        s = g.abs().amax().clamp_min(1e-30) / 57344.0
        return (g / s).to(torch.float8_e5m2).float() * s


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8_e4m3fn at a per-tensor scale; the gradient
    passes straight through (and is rounded to e5m2 on its way back)."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return _RoundGrad.apply(t + (q - t.detach()))


def grid_round(t: torch.Tensor, levels: float, amax=None, per_channel: bool = False
               ) -> torch.Tensor:
    """`t` on a symmetric integer grid of `levels` steps either side: per
    output channel for an OIHW weight, else per tensor at `amax` (its own
    abs-max when None), values beyond it clipped."""
    if per_channel:
        amax = t.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12 * levels)
    elif amax is None:
        amax = t.abs().amax().clamp_min(1e-30)
    s = amax / levels
    return torch.round(t / s).clamp(-levels, levels) * s


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


#: Integer grids: (weight levels, levels of a nonnegative activation, of a
#: signed one). int4 activations after a ReLU take the unsigned 4-bit grid.
GRIDS = {"int8": (127.0, 127.0, 127.0), "int4": (7.0, 15.0, 7.0)}


def fp8_quant(name, role, t):
    """The fp8 control's hook: every conv's input and weight in fp8."""
    return t if role == "y" else fp8_round(t)


def grid_quant(grids: dict, in_amax: dict, out_amax: dict):
    """The hook of an integer tier: the convs of `grids` ({conv: grid name
    of `GRIDS`}) on their grids, their inputs and outputs at `in_amax` and
    `out_amax` ({conv: abs-max of its input, of its output after the ReLU,
    on the calibration crops}), clipped beyond them, their weights per
    output channel; every other layer takes bfloat16 inputs, weights and
    outputs."""
    unknown = set(grids.values()) - set(GRIDS)
    if unknown:
        raise ValueError(f"unknown grids {sorted(unknown)}")

    def hook(name, role, t):
        if name not in grids:
            return bf16_round(t)
        w_levels, pos_levels, sym_levels = GRIDS[grids[name]]
        if role == "w":
            return grid_round(t, w_levels, per_channel=True)
        amax = (in_amax if role == "x" else out_amax)[name]
        return grid_round(t, pos_levels if bool((t >= 0).all()) else sym_levels, amax)
    return hook


def for_config(cfg: dict, kind: str, in_amax=None, out_amax=None):
    """The hook of precision `kind` for the configuration `cfg`: None for
    float32; the fp8 control; the tier's own layers on their grids (`kind`
    is the precision `cfg` states); or every layer the tier lists on the
    grid `kind` (the control below an integer tier)."""
    if kind == "f32":
        return None
    if kind == "fp8":
        return fp8_quant
    layers = cfg["quant"]["layers"]
    grids = layers if kind == cfg["precision"] else dict.fromkeys(layers, kind)
    return grid_quant(grids, in_amax, out_amax)
