"""Fused 3x3 valid convolution + bias + ReLU: the Hopper kernels and their
plain PyTorch version.

Counterpart of ``tpu_unet/ops/conv_pallas.py``. The layout is the JAX
package's: x NHWC ``[B, H, W, Cin]``, w HWIO ``[3, 3, Cin, Cout]``, b
``[Cout]`` -> ``[B, H-2, W-2, Cout]``; beside a bf16 x, b may be f32 (the
int8 tier's float layers add an f32 bias before the one bf16 rounding). The
kernels are CUDA C++ in
``tpu_unet_torch/csrc/conv3x3_bias_relu.cu``, built on first use
(``ops/_build.py``), on one of two routes that `conv3x3_route` picks by
shape: ``"sm90"`` (bf16, Cin and Cout multiples of 8, x 16-byte aligned:
the wgmma loops of ``csrc/conv3x3_sm90.cuh``, flat or strip, as
`sm90_plan` picks them) and ``"simple"`` (the one-stage kernels: Cin = 1,
f32, ragged or misaligned shapes).

`conv3x3_bias_relu` dispatches on the device of `x`: a CPU tensor goes to
`conv3x3_bias_relu_plain`, a CUDA tensor launches the kernel or raises. It
is differentiable on both devices through one `torch.autograd.Function`
whose backward is that of the JAX package's custom VJP
(``tpu_unet/ops/conv_pallas.py:94-103``): the cotangent gated by the fused
output's ReLU mask, then the conv transposes (library convs, cuDNN on the
card, as JAX leaves them to XLA) for dx and dw, and a sum for db.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1

#: The flat loop's blocks csrc/conv3x3_bias_relu.cu builds (BM output
#: pixels x BN output channels): 128 x 64, two per SM, where Cout <= 64;
#: 256 x 128, one per SM (half the weight traffic per output), above.
SM90_FLAT_BLOCKS = ((128, 64), (256, 128))


@dataclasses.dataclass(frozen=True)
class Sm90Plan:
    """Which sm90 loop runs a conv: `kind` 'strip' (Cin and Cout <= 64;
    csrc/conv3x3_sm90.cuh's persistent loop, whose tile, ring and grid are
    its own) or 'flat', with blocks of `bm` output pixels (flat over the
    batch) x `bn` output channels. The ring, grid and shared memory follow
    from these in the CUDA entry."""
    kind: str
    bm: int = 0
    bn: int = 0


def sm90_plan(cin: int, cout: int) -> Sm90Plan:
    """The sm90 loop for a conv of `cin` -> `cout` channels: the strip loop
    where both are <= 64 (one K step per tap, one block column), else the
    flat loop with 128 x 64 blocks where Cout <= 64 and 256 x 128 above."""
    if cin <= 64 and cout <= 64:
        return Sm90Plan("strip")
    bm, bn = SM90_FLAT_BLOCKS[0] if cout <= 64 else SM90_FLAT_BLOCKS[1]
    return Sm90Plan("flat", bm, bn)


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    """The SMs of a CUDA device, which sizes the strip loop's grid."""
    return _sms_of(device.index if device.index is not None else torch.cuda.current_device())


def conv3x3_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route `conv3x3_bias_relu` takes for x and w on the card:
    ``"sm90"`` for bf16 with Cin and Cout multiples of 8 and x 16-byte
    aligned, else ``"simple"``. It depends on dtype, channel counts and the
    alignment of x only, not on the device (the sm90 route reads a fresh
    K-major copy of w)."""
    cin, cout = x.shape[-1], w.shape[-1]
    if (x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0
            and x.data_ptr() % 16 == 0):
        return "sm90"
    return "simple"


def _check_shapes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, Cin], got shape {tuple(x.shape)}")
    bsz, h, wd, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin) or w.dim() != 4:
        raise ValueError(f"w must be HWIO [3, 3, {cin}, Cout], got shape "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be [{w.shape[3]}], got shape {tuple(b.shape)}")
    if h < 3 or wd < 3:
        raise ValueError(f"a 3x3 valid conv needs H, W >= 3, got {h}x{wd}")


def conv3x3_bias_relu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """relu(conv3x3_valid(x, w) + b) computed in f32 and cast to `out_dtype`
    (default: x's dtype) — the semantics of the JAX package's
    ``conv3x3_bias_relu_xla``. On a card, f32 convs run in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False."""
    _check_shapes(x, w, b)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 b.float())
    return torch.relu(y).permute(0, 2, 3, 1).to(out_dtype or x.dtype).contiguous()


def _check_kernel_args(x, w, b, out_dtype) -> None:
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}: the kernel takes one dtype")
    if b.dtype != x.dtype and (x.dtype, b.dtype) != (torch.bfloat16, torch.float32):
        raise TypeError(f"b is {b.dtype}, x is {x.dtype}: the kernel takes b in x's "
                        f"dtype, or float32 beside bfloat16")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    if out_dtype is not None and out_dtype != x.dtype:
        raise TypeError(f"the kernel writes x's dtype {x.dtype}, not {out_dtype}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[0] < 1 or w.shape[3] < 1:
        raise ValueError(f"empty batch or Cout: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if max(x.shape) > _INT32_MAX or 9 * x.shape[3] > _INT32_MAX:
        raise ValueError(f"dimension past int32 in x {tuple(x.shape)}")


class _Conv3x3BiasReLU(torch.autograd.Function):
    """The fused forward (`_forward`) with the JAX package's backward."""

    @staticmethod
    def forward(ctx, x, w, b, out_dtype):
        y = _forward(x, w, b, out_dtype)
        ctx.save_for_backward(x, w, y)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        # d relu(pre) / d pre at the fused output: pre > 0 <=> y > 0; the
        # transposes run in x's dtype (g arrives in y's)
        g = torch.where(y > 0, g, 0).to(x.dtype).permute(0, 3, 1, 2)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                (x.shape[0], x.shape[3], x.shape[1], x.shape[2]),
                w.permute(3, 2, 0, 1), g)
            dx = dx.permute(0, 2, 3, 1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3), g)
            dw = dw.permute(2, 3, 1, 0).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3)).to(ctx.b_dtype)
        return dx, dw, db, None


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, H, W, Cin], w [3, 3, Cin, Cout], b [Cout] ->
    relu(conv_valid(x, w) + b) [B, H-2, W-2, Cout], differentiable in x, w
    and b.

    On a CPU tensor: `conv3x3_bias_relu_plain`. On a CUDA tensor: a Hopper
    kernel on the route `conv3x3_route` picks, which takes contiguous
    float32 or bfloat16 tensors of one dtype, or a float32 b beside
    bfloat16 x and w, and writes x's dtype. Each
    launch counts in ``conv3x3_bias_relu.launches``, and the sm90 route's
    also in ``conv3x3_bias_relu.sm90_launches``. The backward runs library
    convs on either device."""
    return _Conv3x3BiasReLU.apply(x, w, b, out_dtype)


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, w, b, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bias_relu runs on cpu or cuda, not {x.device}")
    _check_shapes(x, w, b)
    _check_kernel_args(x, w, b, out_dtype)
    if conv3x3_route(x, w) == "sm90":
        return _launch_sm90(x, w, b)
    return _launch_simple(x, w, b)


def _launch_sm90(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sm90 route on checked bf16 CUDA tensors, on `sm90_plan`'s loop."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    plan = sm90_plan(cin, cout)
    wk = w.permute(3, 0, 1, 2).contiguous()          # [Cout, 9, Cin]: K-major rows
    y = torch.empty((bsz, h - 2, wd - 2, cout), dtype=x.dtype, device=x.device)
    _build.launch("conv3x3_bias_relu", _build.load_library().conv3x3_bias_relu_sm90, x.get_device(),
                  x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout,
                  int(plan.kind == "strip"), plan.bm, plan.bn, _sms(x.device),
                  int(b.dtype == torch.float32), shapes=(("x", x), ("w", w)))
    conv3x3_bias_relu.launches += 1
    conv3x3_bias_relu.sm90_launches += 1
    return y


def _launch_simple(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The simple route (the one-stage kernels) on checked CUDA tensors."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((bsz, h - 2, wd - 2, cout), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    ve = 16 // x.element_size()        # elements per 16-byte load
    vec = int(cin % ve == 0 and cout % ve == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w)))
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, cin, cout, vec)
    if x.dtype == torch.bfloat16:
        fn, args = lib.conv3x3_bias_relu_bf16, args + (int(b.dtype == torch.float32),)
    else:
        fn = lib.conv3x3_bias_relu_f32
    _build.launch("conv3x3_bias_relu", fn, x.get_device(), *args, shapes=(("x", x), ("w", w)))
    conv3x3_bias_relu.launches += 1
    return y


def _conv3x3_route_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           route: str) -> torch.Tensor:
    """The forward on CUDA tensors through the named route, whatever
    `conv3x3_route` would pick: the simple kernel at a shape the sm90 loop
    takes. For comparing and timing the two on the card; no path of the
    model calls it."""
    if x.device.type != "cuda":
        raise ValueError(f"the routes run on cuda, not {x.device}")
    _check_shapes(x, w, b)
    _check_kernel_args(x, w, b, None)
    if route == "simple":
        return _launch_simple(x, w, b)
    if route != "sm90":
        raise ValueError(f"no route {route!r}")
    if conv3x3_route(x, w) != "sm90":
        raise ValueError(f"the sm90 route does not take {x.dtype} x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    return _launch_sm90(x, w, b)


#: Kernel launches since the count was last set to 0 (CPU calls don't
#: count): all routes, and the sm90 route's alone.
conv3x3_bias_relu.launches = 0
conv3x3_bias_relu.sm90_launches = 0
