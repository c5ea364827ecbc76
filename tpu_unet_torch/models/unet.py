"""The 23-layer valid-convolution U-Net (Ronneberger et al. 2015) in PyTorch.

Counterpart of ``tpu_unet/models/unet.py::UNet``: the same `ModelConfig`,
the same NHWC input and f32 NHWC logits, the same layer names
(``enc0_conv1`` ... ``head``), both skip variants and both init schemes.
Parameters use PyTorch's layouts — Conv2d ``[O, I, kh, kw]``,
ConvTranspose2d ``[I, O, kh, kw]`` — so a JAX parameter tree crosses
through `tpu_unet_torch.convert.state_dict_from_jax_params`, and a reference
``.pth`` through `state_dict_from_reference`.

``conv_impl='pallas'`` runs the 3x3 convs through the fused conv + bias +
ReLU kernel (`ops.conv_pallas.conv3x3_bias_relu`); ``'xla'`` through
``F.conv2d``, with the decoder's first convs in the split-concat form.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_unet.config import ModelConfig
from tpu_unet.core.geometry import output_size_for_input
from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def center_crop_or_pad(a: torch.Tensor, target_hw: Sequence[int],
                       fill=0) -> torch.Tensor:
    """Center-crop (if larger) or pad with `fill` (if smaller) NHWC `a` to
    target H, W. Offsets truncate toward zero like the reference's
    ``int((A - B) * 0.5)``."""
    h, w = a.shape[1], a.shape[2]
    th, tw = target_hw
    dh = int((h - th) * 0.5)
    dw = int((w - tw) * 0.5)
    if dh > 0 or dw > 0:  # crop
        y0, x0 = max(dh, 0), max(dw, 0)
        a = a[:, y0:y0 + min(th, h), x0:x0 + min(tw, w), :]
    if dh < 0 or dw < 0:  # pad
        ph, pw = max(-dh, 0), max(-dw, 0)
        a = F.pad(a, (0, 0, pw, tw - a.shape[2] - pw, ph, th - a.shape[1] - ph),
                  value=fill)
    return a


def _init_spec(scheme: str, k: int, fan_in: float, *, first: bool = False,
               parity_n: Optional[float] = None) -> Tuple[float, Optional[float]]:
    """(weight std, bias bound or None for zero biases) of a conv layer —
    ``tpu_unet/models/unet.py::_conv_inits``."""
    if scheme == "paper":
        return math.sqrt(2.0 / (k * k * fan_in)), None
    if scheme == "parity":
        std = math.sqrt(2.0) if first else 2.0 / math.sqrt(parity_n)
        return std, 1.0 / math.sqrt(k * k * fan_in)
    raise ValueError(f"unknown init scheme: {scheme}")


def matmul_upconv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """2x2 stride-2 transposed conv as one matmul + depth-to-space, NHWC.

    The stride equals the kernel size, so output windows never overlap:
    y[b, 2i+dy, 2j+dx, o] = x[b, i, j, :] @ weight[:, o, dy, dx] + bias[o]
    (`weight` in ConvTranspose2d layout ``[Cin, Cout, 2, 2]``)."""
    b, h, w, cin = x.shape
    co = weight.shape[1]
    wr = weight.to(dtype).permute(0, 2, 3, 1).reshape(cin, 4 * co)
    y = torch.matmul(x.to(dtype).reshape(b * h * w, cin), wr).float()
    y = (y.reshape(b, h, w, 2, 2, co) + bias.float()).to(dtype)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, co)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class UNet(nn.Module):
    """Valid-conv U-Net. Input NHWC [B, H, W, in_channels] with H, W valid
    input sizes (core.geometry); output f32 logits
    [B, H-ctx, W-ctx, num_classes].

    Weights are drawn from `generator` (default: a generator seeded 0)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        pdt = _DTYPES[cfg.param_dtype]
        widths = cfg.widths
        scheme = cfg.init_scheme
        self._init: Dict[str, Tuple[float, Optional[float]]] = {}

        def layer(name, wshape, cout, spec):
            self.add_module(name, nn.ParameterDict({
                "weight": nn.Parameter(torch.empty(wshape, dtype=pdt)),
                "bias": nn.Parameter(torch.empty(cout, dtype=pdt)),
            }))
            self._init[name] = spec

        def conv3(name, cin, cout, **kw):
            layer(name, (cout, cin, 3, 3), cout, _init_spec(scheme, 3, cin, **kw))

        for d in range(cfg.depth):
            cin = cfg.in_channels if d == 0 else widths[d - 1]
            conv3(f"enc{d}_conv1", cin, widths[d], first=(d == 0),
                  parity_n=cin * 9.0)
            conv3(f"enc{d}_conv2", widths[d], widths[d],
                  parity_n=widths[d] * 9.0)
        wb = widths[cfg.depth]
        conv3("bottleneck_conv1", widths[cfg.depth - 1], wb,
              parity_n=widths[cfg.depth - 1] * 9.0)
        conv3("bottleneck_conv2", wb, wb, parity_n=wb * 9.0)
        for d in reversed(range(cfg.depth)):
            fan_in, feat = widths[d + 1], widths[d]
            if scheme == "paper":
                spec = _init_spec("paper", 2, fan_in)
            else:
                # upconv std uses the previous 3x3 kernel size in N; the
                # bias bound is torch's ConvTranspose2d default.
                spec = (2.0 / math.sqrt(fan_in * 9.0), 1.0 / math.sqrt(feat * 4.0))
            layer(f"up{d}", (fan_in, feat, 2, 2), feat, spec)
            # parity N sums both concat sources with their own kernel sizes
            conv3(f"dec{d}_conv1", 2 * feat, feat, parity_n=feat * 13.0)
            conv3(f"dec{d}_conv2", feat, feat, parity_n=feat * 9.0)
        fan_in = widths[0]
        if scheme == "paper":
            spec = _init_spec("paper", 1, fan_in)
        else:
            spec = (2.0 / math.sqrt(fan_in * 9.0), 1.0 / math.sqrt(fan_in))
        layer("head", (cfg.num_classes, fan_in, 1, 1), cfg.num_classes, spec)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Draw every weight from N(0, std) and every bias from U(-bound,
        bound) (zero when the scheme has no bound), layer by layer."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, (std, bound) in self._init.items():
            p = getattr(self, name)
            w = torch.randn(p["weight"].shape, generator=generator) * std
            p["weight"].copy_(w)
            if bound is None:
                p["bias"].zero_()
            else:
                u = torch.rand(p["bias"].shape, generator=generator)
                p["bias"].copy_(u * (2 * bound) - bound)

    def _wb(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        p = getattr(self, name)
        return p["weight"].to(self.compute_dtype), p["bias"].to(self.compute_dtype)

    def _conv3_relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self._wb(name)
        if self.cfg.conv_impl == "pallas":
            return conv3x3_bias_relu(x.contiguous(),
                                     w.permute(2, 3, 1, 0).contiguous(), b)
        return _nhwc(F.relu(F.conv2d(_nchw(x), w, b)))

    def _split_concat_conv3_relu(self, name: str, a: torch.Tensor,
                                 b_: torch.Tensor) -> torch.Tensor:
        """relu(conv3x3(concat(a, b_)) + bias) without building the concat."""
        w, b = self._wb(name)
        ca = a.shape[-1]
        y = F.conv2d(_nchw(a), w[:, :ca]) + F.conv2d(_nchw(b_), w[:, ca:], b)
        return _nhwc(F.relu(y))

    def _upconv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.upconv_impl == "matmul":
            p = getattr(self, name)
            return matmul_upconv(x, p["weight"], p["bias"],
                                 dtype=self.compute_dtype)
        w, b = self._wb(name)
        return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # Reject sizes the valid-conv geometry can't carry (pooling would
        # silently floor odd extents and misalign the skips).
        for dim in (1, 2):
            try:
                output_size_for_input(x.shape[dim], cfg.depth)
            except ValueError as e:
                raise ValueError(
                    f"input axis {dim} has size {x.shape[dim]}, not a valid U-Net "
                    f"input size for depth {cfg.depth} (use core.geometry."
                    f"input_size_compute)") from e
        x = x.to(self.compute_dtype)
        skips = []
        for d in range(cfg.depth):
            x = self._conv3_relu(f"enc{d}_conv1", x)
            x = self._conv3_relu(f"enc{d}_conv2", x)
            if cfg.skip_variant == "paper":
                skips.append(x)
            x = _max_pool2(x)
            if cfg.skip_variant == "parity":
                skips.append(x)
        x = self._conv3_relu("bottleneck_conv1", x)
        x = self._conv3_relu("bottleneck_conv2", x)
        for d in reversed(range(cfg.depth)):
            x = self._upconv(f"up{d}", x)
            skip = center_crop_or_pad(skips[d], x.shape[1:3])
            if cfg.split_concat_conv and cfg.conv_impl == "xla":
                x = self._split_concat_conv3_relu(f"dec{d}_conv1", skip, x)
            else:
                x = self._conv3_relu(f"dec{d}_conv1", torch.cat([skip, x], -1))
            x = self._conv3_relu(f"dec{d}_conv2", x)
        w, b = self._wb("head")
        return F.linear(x, w.reshape(w.shape[0], w.shape[1]), b).float()


def _check_config(cfg: ModelConfig) -> None:
    if cfg.skip_variant not in ("paper", "parity"):
        raise ValueError(f"skip_variant must be 'paper' or 'parity', got {cfg.skip_variant!r}")
    if cfg.init_scheme not in ("paper", "parity"):
        raise ValueError(f"unknown init scheme: {cfg.init_scheme}")
    if cfg.conv_impl not in ("xla", "pallas"):
        raise ValueError(f"conv_impl must be 'xla' or 'pallas', got {cfg.conv_impl!r}")
    if cfg.upconv_impl not in ("xla", "matmul"):
        raise ValueError(f"upconv_impl must be 'xla' or 'matmul', got {cfg.upconv_impl!r}")
    for field in ("compute_dtype", "param_dtype"):
        if getattr(cfg, field) not in _DTYPES:
            raise ValueError(f"{field} must be one of {sorted(_DTYPES)}, got "
                             f"{getattr(cfg, field)!r}")
    if cfg.conv_bwd not in ("auto", "mm", "xla"):
        raise ValueError(f"conv_bwd must be 'auto', 'mm' or 'xla', got {cfg.conv_bwd!r}")
    if cfg.conv_bwd != "xla":
        raise NotImplementedError(
            "conv_bwd 'mm'/'auto' is not ported yet (ROADMAP queue 1, item 13)")
    if cfg.phase_level0:
        raise NotImplementedError(
            "phase_level0 is not ported yet (ROADMAP queue 1, item 8)")
    if cfg.remat:
        raise NotImplementedError(
            "remat is not ported yet (ROADMAP queue 1, item 6: training)")
