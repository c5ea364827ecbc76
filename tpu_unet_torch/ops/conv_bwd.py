"""Matmul forms of the 3x3 valid conv's backward (counterpart of
``tpu_unet/ops/conv_bwd.py``), behind ``ModelConfig.conv_bwd='mm'|'auto'``.

The JAX package measured this path negative on its TPU and keeps plain
autodiff (``conv_bwd='xla'``) as the default; the module stays as the tested
alternative whose per-layer balance can be measured again. Layouts at the
functions' boundary are the JAX package's: x NHWC ``[B, H, W, Cin]``, the
kernel HWIO ``[3, 3, Cin, Cout]``; H may differ from W (the JAX functions
take square images).

* `wgrad_mm`: dK as one im2col matmul, patches(x) ``[B*Ho*Wo, 9*Cin]``
  transposed times the cotangent ``[B*Ho*Wo, Cout]``;
* `dgrad_mm`: dx as the full correlation with the flipped kernel, patches
  of the cotangent padded by 2 times the flipped kernel ``[9*Cout, Cin]``;
* `conv3x3_bias`: the conv + bias as a ``torch.autograd.Function`` whose
  backward takes each gradient from 'xla' (the library's transposed convs,
  what autograd gives) or 'mm' (the forms above), per layer.

Both matmuls sum bf16 products in f32, as ``preferred_element_type=f32``
does, and the gradient is rounded to the primal's dtype once. On the card
they may run in TF32 when the operands hold bf16 values, which TF32
represents exactly; f32 operands run in the precision the caller set.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops.conv_tiles import tf32_for_bf16_values

_IMPLS = ("xla", "mm")


def conv3x3_valid(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC x [B, H, W, Cin], HWIO kernel [3, 3, Cin, Cout] -> [B, H-2, W-2,
    Cout]. A `bias` is added inside the one ``F.conv2d`` call, so a bf16
    output is rounded once, as the model's own conv rounds it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias)
    return y.permute(0, 2, 3, 1)


def _patches9(a: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*out_h*out_w, 9*C]: the nine 3x3-tap shifted views
    stacked (tap index 3*dy + dx), each row [tap0 C..., tap1 C..., ...]."""
    b, c = a.shape[0], a.shape[-1]
    pats = torch.stack([a[:, dy:dy + out_h, dx:dx + out_w, :]
                        for dy in range(3) for dx in range(3)], dim=3)
    return pats.reshape(b * out_h * out_w, 9 * c)


def wgrad_mm(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dK for y = conv3x3_valid(x, K), as one im2col matmul (patches(x)
    [B*Ho*Wo, 9*Cin] transposed times g [B*Ho*Wo, Cout]):
    dk[dy, dx, ci, co] = sum_{b,i,j} x[b, i+dy, j+dx, ci] * g[b, i, j, co],
    in f32 ([3, 3, Cin, Cout]); the caller casts it to the kernel's dtype."""
    b, ho, wo, cout = g.shape
    cin = x.shape[-1]
    pats = _patches9(x, ho, wo)
    with tf32_for_bf16_values(g.dtype == torch.bfloat16):
        dk = pats.t().float() @ g.reshape(b * ho * wo, cout).float()
    return dk.reshape(3, 3, cin, cout)


def dgrad_mm(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx for y = conv3x3_valid(x, K), the full correlation with the
    spatially flipped kernel as one matmul:
    dx[b, p, q, ci] = sum_{dy,dx,co} pad(g, 2)[b, p+dy, q+dx, co]
    * K[2-dy, 2-dx, ci, co], in f32 ([B, H, W, Cin])."""
    b, ho, wo, cout = g.shape
    cin = kernel.shape[2]
    pats = _patches9(F.pad(g, (0, 0, 2, 2, 2, 2)), ho + 2, wo + 2)
    kf = kernel.flip((0, 1)).permute(0, 1, 3, 2).reshape(9 * cout, cin)
    with tf32_for_bf16_values(g.dtype == torch.bfloat16):
        dx = pats.float() @ kf.float()
    return dx.reshape(b, ho + 2, wo + 2, cin)


def auto_wgrad_impl(in_hw: int, cin: int) -> str:
    """The JAX package's static per-layer wgrad choice, from its TPU
    per-shape probe: 'mm' for tiny Cin and for the shallow mid-size layers,
    else 'xla'. Kept so that ``conv_bwd='auto'`` routes as it does there;
    its own end-to-end A/B picked plain 'xla'."""
    so = in_hw - 2
    if cin <= 4:
        return "mm"
    if 150 <= so <= 320 and cin <= 128:
        return "mm"
    return "xla"


class _Conv3x3Bias(torch.autograd.Function):
    """conv3x3_valid(x, kernel) + bias with each gradient from 'xla' or
    'mm'. The forward is `conv3x3_valid` with the bias, the model's own
    ``F.conv2d`` call, so its output equals the plain conv's bit for bit."""

    @staticmethod
    def forward(ctx, x, kernel, bias, wgrad: str, dgrad: str):
        ctx.save_for_backward(x, kernel)
        ctx.impls = (wgrad, dgrad)
        return conv3x3_valid(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        wgrad, dgrad = ctx.impls
        g_nchw = g.permute(0, 3, 1, 2)
        if dgrad == "mm":
            dx = dgrad_mm(g, kernel)
        else:
            dx = torch.nn.grad.conv2d_input(
                x.permute(0, 3, 1, 2).shape, kernel.permute(3, 2, 0, 1), g_nchw
            ).permute(0, 2, 3, 1)
        if wgrad == "mm":
            dk = wgrad_mm(g, x)
        else:
            dk = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).shape, g_nchw
            ).permute(2, 3, 1, 0)
        db = g.sum(dim=(0, 1, 2))
        return dx.to(x.dtype), dk.to(kernel.dtype), db, None, None


def conv3x3_bias(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, *,
                 wgrad: str = "mm", dgrad: str = "xla") -> torch.Tensor:
    """conv3x3_valid(x, kernel) + bias, NHWC out, with each gradient's route
    chosen: `wgrad`, `dgrad` 'xla' (the transposed convs autograd would run)
    or 'mm' (`wgrad_mm`, `dgrad_mm`: the same sums, f32-accumulated, cast
    back to the primal's dtype)."""
    if wgrad not in _IMPLS or dgrad not in _IMPLS:
        raise ValueError(f"wgrad/dgrad must be 'xla' or 'mm', got {wgrad!r}/{dgrad!r}")
    return _Conv3x3Bias.apply(x, kernel, bias, wgrad, dgrad)
