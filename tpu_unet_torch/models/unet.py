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
``F.conv2d``, with the decoder's first convs in the split-concat form. Both
train: the kernel's gradient is its autograd.Function, the split form's is
autograd's (the same cotangents as the JAX package's ``_scc_bwd``), and
``remat`` checkpoints each encoder level, as the JAX package does.

``conv_bwd`` ('mm' or 'auto'; 'xla' is plain autograd) routes the weight
gradient of each plain 3x3 conv under ``conv_impl='xla'`` through the
im2col matmul of `ops.conv_bwd.conv3x3_bias` ('auto': the layers
`auto_wgrad_impl` picks at their input size), as the JAX package's
``conv3`` does; the forward is unchanged, bit for bit. The split-concat
decoder convs, the phase-packed level 0 and ``'pallas'`` keep their own
backward.

``phase_level0`` runs level 0 (enc0's convs, pool0, up0, dec0's convs and
the head) on the 2x2 phase decomposition of the input (ops/phase.py): the
3x3 convs as 2x2 convs at 4x the channels with the kernels packed inside the
forward, differentiably, so the parameters stay the canonical ones and
checkpoints do not change. It needs ``conv_impl='xla'`` and even H, W, as
the JAX package's does.

``forward(x, capture=d)`` fills the dict `d` with every 3x3 conv's output,
every ``up{d}`` output and the head's output, by layer name: the counterpart
of Flax's ``capture_intermediates``, which quantized serving's calibration
reads. A 3x3 conv's output is recorded after its ReLU (K1 fuses the two):
its maximum clipped at 0, all that calibration reads, is the same either
way. Under ``phase_level0`` the level-0 outputs are recorded packed, as in
the JAX package: the same values in another order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.core.geometry import (TilePlan, input_size_compute, output_size_for_input,
                                         plan_tiles)
from tpu_unet_torch.ops import phase as ph
from tpu_unet_torch.ops.conv_bwd import auto_wgrad_impl, conv3x3_bias
from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: Smallest tile_out: below one pooling period (16 px) the planned stride
#: exceeds the tile and the plan leaves gaps between tiles.
MIN_TILE_OUT = 16


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

    def tile_plan(self, image_h: int, image_w: int, tile_out=None) -> TilePlan:
        """The overlap-tile plan of the engine (infer/tiles.py) over
        image_h x image_w frames: `core.geometry.plan_tiles` at output tiles
        of `tile_out` (None: one tile covering the larger side; an (h, w)
        pair: strip tiles), at least `MIN_TILE_OUT`."""
        if tile_out is None:
            tile_out = input_size_compute(max(image_h, image_w))[2]
        if min(tile_out if isinstance(tile_out, tuple) else (tile_out,)) < MIN_TILE_OUT:
            raise ValueError(f"tile_out must be >= {MIN_TILE_OUT} (one pooling "
                             f"period), got {tile_out!r}")
        return plan_tiles(image_h, image_w, tile_out)

    def _wb(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        p = getattr(self, name)
        return p["weight"].to(self.compute_dtype), p["bias"].to(self.compute_dtype)

    def _wgrad_impl(self, x: torch.Tensor) -> str:
        """The weight gradient's route of a plain 3x3 conv of `x` under
        ``conv_impl='xla'``: 'mm' or 'xla', by ``cfg.conv_bwd``."""
        if self.cfg.conv_bwd == "auto":
            return auto_wgrad_impl(x.shape[1], x.shape[-1])
        return self.cfg.conv_bwd

    def _conv3_relu(self, name: str, x: torch.Tensor,
                    capture: Optional[dict] = None) -> torch.Tensor:
        w, b = self._wb(name)
        if self.cfg.conv_impl == "pallas":
            y = conv3x3_bias_relu(x.contiguous(), w.permute(2, 3, 1, 0).contiguous(), b)
        elif self._wgrad_impl(x) == "mm":
            y = F.relu(conv3x3_bias(x, w.permute(2, 3, 1, 0), b, wgrad="mm", dgrad="xla"))
        else:
            y = _nhwc(F.relu(F.conv2d(_nchw(x), w, b)))
        if capture is not None:
            capture[name] = y
        return y

    def _split_concat_conv3_relu(self, name: str, a: torch.Tensor,
                                 b_: torch.Tensor,
                                 capture: Optional[dict] = None) -> torch.Tensor:
        """relu(conv3x3(concat(a, b_)) + bias) without building the concat."""
        w, b = self._wb(name)
        ca = a.shape[-1]
        y = F.conv2d(_nchw(a), w[:, :ca]) + F.conv2d(_nchw(b_), w[:, ca:], b)
        y = _nhwc(F.relu(y))
        if capture is not None:
            capture[name] = y
        return y

    def _upconv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.upconv_impl == "matmul":
            p = getattr(self, name)
            return matmul_upconv(x, p["weight"], p["bias"],
                                 dtype=self.compute_dtype)
        w, b = self._wb(name)
        return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=2))

    # -- the phase-packed level 0 (ops/phase.py) ------------------------------
    # Each layer packs its canonical weights per call; NHWC packed in and out.

    def _packed(self, name: str, ci: slice = slice(None)) -> torch.Tensor:
        """`name`'s 3x3 kernel (input channels `ci`) packed, as OIHW."""
        w, _ = self._wb(name)
        return ph.phase_pack_kernel_torch(w[:, ci].permute(2, 3, 1, 0)).permute(3, 2, 0, 1)

    def _phase_conv_relu(self, name: str, xp: torch.Tensor,
                         capture: Optional[dict] = None) -> torch.Tensor:
        y = F.conv2d(_nchw(xp), self._packed(name), ph.phase_bias(self._wb(name)[1]))
        y = _nhwc(F.relu(y))
        if capture is not None:
            capture[name] = y
        return y

    def _phase_split_concat_conv_relu(self, name: str, ap: torch.Tensor, bp: torch.Tensor,
                                      capture: Optional[dict] = None) -> torch.Tensor:
        """relu(conv(concat(ap, bp)) + bias), packed, without building the
        concat. The JAX package routes this form's backward through the
        concat form (a custom VJP) only to avoid an XLA TPU compile assert;
        autograd through the split form gives the same cotangents."""
        ca = ap.shape[-1] // 4
        b = ph.phase_bias(self._wb(name)[1])
        y = (F.conv2d(_nchw(ap), self._packed(name, slice(None, ca)))
             + F.conv2d(_nchw(bp), self._packed(name, slice(ca, None)), b))
        y = _nhwc(F.relu(y))
        if capture is not None:
            capture[name] = y
        return y

    def _phase_upconv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """up{d} emitting a packed output: one matmul (the JAX layout's
        kernel is the ConvTranspose2d weight permuted and flipped back)."""
        w, b = self._wb(name)
        return ph.phase_upconv_matmul(x, w.permute(2, 3, 0, 1).flip((0, 1)), b,
                                      dtype=self.compute_dtype)

    def _enc_level(self, x: torch.Tensor, d: int,
                   capture: Optional[dict] = None) -> torch.Tensor:
        if d == 0 and self.cfg.phase_level0:
            # s2d once on the raw input; returns the packed conv2 output
            xp = self._phase_conv_relu("enc0_conv1", ph.space_to_depth(x), capture)
            return self._phase_conv_relu("enc0_conv2", xp, capture)
        x = self._conv3_relu(f"enc{d}_conv1", x, capture)
        return self._conv3_relu(f"enc{d}_conv2", x, capture)

    def forward(self, x: torch.Tensor, capture: Optional[dict] = None) -> torch.Tensor:
        cfg = self.cfg
        phase = cfg.phase_level0
        if phase and (x.shape[1] % 2 or x.shape[2] % 2):
            raise ValueError(f"phase_level0 needs even H, W (got {x.shape[1]}x"
                             f"{x.shape[2]}); every valid U-Net input size is even")
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
            if cfg.remat and torch.is_grad_enabled() and capture is None:
                # keep only the level's input; rerun its convs in the backward
                x = checkpoint(self._enc_level, x, d, use_reentrant=False)
            else:
                x = self._enc_level(x, d, capture)
            if cfg.skip_variant == "paper":
                skips.append(x)                  # packed at d = 0 under phase
            # pool0 packed is a max over the phase groups: the result is the
            # unpacked level-1 tensor
            x = ph.phase_pool(x) if phase and d == 0 else _max_pool2(x)
            if cfg.skip_variant == "parity":
                skips.append(x)
        x = self._conv3_relu("bottleneck_conv1", x, capture)
        x = self._conv3_relu("bottleneck_conv2", x, capture)
        for d in reversed(range(cfg.depth)):
            if phase and d == 0:
                # packed dec0: the skip arrives packed and is cropped in the
                # packed domain ('paper'), or is zero-padded at full
                # resolution and packed here ('parity'); the concat is split
                x = self._phase_upconv("up0", x)
                if capture is not None:
                    capture["up0"] = x
                if cfg.skip_variant == "paper":
                    skip = center_crop_or_pad(skips[0], x.shape[1:3])
                else:
                    skip = ph.space_to_depth(center_crop_or_pad(
                        skips[0], (2 * x.shape[1], 2 * x.shape[2])))
                x = self._phase_split_concat_conv_relu("dec0_conv1", skip, x, capture)
                x = self._phase_conv_relu("dec0_conv2", x, capture)
                continue
            x = self._upconv(f"up{d}", x)
            if capture is not None:
                capture[f"up{d}"] = x
            skip = center_crop_or_pad(skips[d], x.shape[1:3])
            if cfg.split_concat_conv and cfg.conv_impl == "xla":
                x = self._split_concat_conv3_relu(f"dec{d}_conv1", skip, x, capture)
            else:
                x = self._conv3_relu(f"dec{d}_conv1", torch.cat([skip, x], -1), capture)
            x = self._conv3_relu(f"dec{d}_conv2", x, capture)
        w, b = self._wb("head")
        if phase:
            x = ph.phase_head_matmul(x, w.permute(2, 3, 1, 0), b)
        else:
            x = F.linear(x, w.reshape(w.shape[0], w.shape[1]), b)
        if capture is not None:
            capture["head"] = x
        return (ph.depth_to_space(x) if phase else x).float()


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
    if cfg.phase_level0 and cfg.conv_impl != "xla":
        raise ValueError("phase_level0 requires conv_impl='xla' (the phase path "
                         "replaces the level-0 convs)")
