"""Fused 3x3 valid convolution + bias + ReLU: the Hopper kernel and its
plain PyTorch version.

Counterpart of ``tpu_unet/ops/conv_pallas.py``. The layout is the JAX
package's: x NHWC ``[B, H, W, Cin]``, w HWIO ``[3, 3, Cin, Cout]``, b
``[Cout]`` -> ``[B, H-2, W-2, Cout]``. The kernel is CUDA C++ in
``tpu_unet_torch/csrc/conv3x3_bias_relu.cu``, built on first use
(``ops/_build.py``).

`conv3x3_bias_relu` dispatches on the device of `x`: a CPU tensor goes to
`conv3x3_bias_relu_plain`, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


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
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: the kernel "
                            f"takes one dtype")
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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        # No silent loss of the gradient: the kernel backward is ROADMAP
        # item 6 (training).
        raise RuntimeError(
            "conv3x3_bias_relu has no backward on CUDA yet; call it under "
            "torch.no_grad() or torch.inference_mode()")


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [B, H, W, Cin], w [3, 3, Cin, Cout], b [Cout] ->
    relu(conv_valid(x, w) + b) [B, H-2, W-2, Cout].

    On a CPU tensor: `conv3x3_bias_relu_plain`. On a CUDA tensor: the Hopper
    kernel, which takes contiguous float32 or bfloat16 tensors of one dtype,
    writes that dtype, and counts each launch in
    ``conv3x3_bias_relu.launches``."""
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, w, b, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bias_relu runs on cpu or cuda, not {x.device}")
    _check_shapes(x, w, b)
    _check_kernel_args(x, w, b, out_dtype)
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((bsz, h - 2, wd - 2, cout), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    fn = (lib.conv3x3_bias_relu_bf16 if x.dtype == torch.bfloat16
          else lib.conv3x3_bias_relu_f32)
    ve = 16 // x.element_size()        # elements per 16-byte load
    vec = int(cin % ve == 0 and cout % ve == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                bsz, h, wd, cin, cout, vec, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bias_relu launch failed: CUDA error {rc} "
                           f"({_build.cuda_error_string(rc)}) at x "
                           f"{tuple(x.shape)}, w {tuple(w.shape)}")
    conv3x3_bias_relu.launches += 1
    return y


#: Kernel launches since the count was last set to 0 (CPU calls don't count).
conv3x3_bias_relu.launches = 0
