"""Fused k x k int8 valid conv (k = 2 or 3) + scale + bias + ReLU + int8
requantize: the Hopper kernel in ``tpu_unet_torch/csrc/conv_kxk_fused.cu``,
its plain PyTorch version, and the two wrapper names of the TPU probe it
replaces.

The TPU kernels are ``conv2x2_fused`` and ``conv_rows3_col`` inside
``scripts/tpu_deep_shootout_r4.py::main``, written for the packed 2x2
256->256 int8 convs of the phase-packed level 0. Both compute

    y = clamp(round(relu(conv_kxk_valid(x, w)_i32 * alpha + beta)), 0, 127)

with x NHWC int8 ``[B, H, W, Cin]``, w HWIO int8 ``[k, k, Cin, Cout]``,
alpha and beta f32 ``[Cout]`` -> int8 ``[B, H-k+1, W-k+1, Cout]``; the
epilogue is `conv_tiles.epilogue` (two f32 roundings, half to even).
Quantized serving's phase path (infer/quant.py, ``phase_level0='int8'``,
``impl='pallas'``) runs its packed ``enc0_conv2`` and ``dec0_conv2``
through it.

The kernels are K3's (``csrc/conv_fused.cuh``) at k = 2 or 3, on the same
two routes, which `conv_kxk_route` picks by shape: ``"sm90"`` (Cin and Cout
multiples of 16, x 16-byte aligned: the int8 wgmma loop, in the block
``conv_tiles.sm90_block`` picks) and ``"simple"`` (the one-stage kernel).

Both wrapper names take the TPU kernels' tiling arguments, check them as
the script uses them (the Cout tile divides Cout, the variant is known, the
sizes are at least 1) and pass nothing of them on. On a CPU tensor they run
`conv_kxk_fused_plain`; on a CUDA tensor `conv_kxk_fused` launches a kernel
or raises, and counts the launch in ``conv_kxk_fused.launches`` (the sm90
route's also in ``conv_kxk_fused.sm90_launches``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.conv_tiles import (_check_kernel_args, _check_shapes, check_route,
                                           epilogue, int8_sm90_takes, k_major_weights,
                                           launch_fused, sm90_block)

_SIZES = (2, 3)
_VARIANTS_2X2 = ("im2col4", "rows2")


def conv_kxk_fused_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                         beta: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the conv in f64 (exact
    for int8 values: |acc| <= 9 * Cin * 127^2 < 2^53), rounded to int32,
    then `epilogue` to int8."""
    _check_shapes(x, w, alpha, beta, sizes=_SIZES)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype} and {w.dtype}")
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1))
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    return epilogue(acc, alpha, beta, "int8").contiguous()


def conv_kxk_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route `conv_kxk_fused` takes for x and w on the card:
    ``"sm90"`` where ``conv_tiles.int8_sm90_takes`` (int8 x, Cin and Cout
    multiples of 16, x 16-byte aligned), else ``"simple"``; not on the
    device."""
    return "sm90" if int8_sm90_takes(x, w.shape[-1], "int8") else "simple"


def _kxk_forward(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                 route: str) -> torch.Tensor:
    """The k x k kernel on checked int8 CUDA tensors through `route`."""
    bsz, h, wd, _ = x.shape
    kh, cout = w.shape[0], w.shape[3]
    y = torch.empty((bsz, h - kh + 1, wd - kh + 1, cout), dtype=torch.int8, device=x.device)
    wk = k_major_weights(w)
    lib = _build.load_library()
    if route == "sm90":
        launch_fused("conv_kxk_fused", lib.conv_kxk_fused_sm90, x, wk, alpha, beta, y, kh,
                     *sm90_block(cout))
        conv_kxk_fused.sm90_launches += 1
    else:
        vec = int(x.shape[3] % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, wk)))
        launch_fused("conv_kxk_fused", lib.conv_kxk_fused_s8, x, wk, alpha, beta, y, kh, vec)
    conv_kxk_fused.launches += 1
    return y


def _check_int8(x: torch.Tensor) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"the kernel takes int8 x and w, got {x.dtype}")


def conv_kxk_fused(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """The fused int8 k x k conv: `conv_kxk_fused_plain` on a CPU tensor,
    a Hopper kernel on the route `conv_kxk_route` picks on a CUDA tensor
    (contiguous int8 x and w, f32 alpha and beta, all on x's device;
    anything else raises)."""
    _check_shapes(x, w, alpha, beta, sizes=_SIZES)
    if x.device.type == "cpu":
        return conv_kxk_fused_plain(x, w, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"conv_kxk_fused runs on cpu or cuda, not {x.device}")
    _check_kernel_args(x, w, alpha, beta)
    _check_int8(x)
    return _kxk_forward(x, w, alpha, beta, conv_kxk_route(x, w))


def _conv_kxk_route_forward(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                            beta: torch.Tensor, route: str) -> torch.Tensor:
    """The k x k kernel on CUDA tensors through the named route, whatever
    `conv_kxk_route` would pick. For comparing and timing the two on the
    card; no path calls it. Refuses the sm90 route at a shape it does not
    take, on any device."""
    _check_shapes(x, w, alpha, beta, sizes=_SIZES)
    check_route(route, conv_kxk_route(x, w), f"{x.dtype} x {tuple(x.shape)} -> {w.shape[3]}")
    if x.device.type != "cuda":
        raise ValueError(f"the routes run on cuda, not {x.device}")
    _check_kernel_args(x, w, alpha, beta)
    _check_int8(x)
    return _kxk_forward(x, w, alpha, beta, route)


#: Kernel launches since the count was last set to 0 (CPU calls don't
#: count): all routes, and the sm90 route's alone.
conv_kxk_fused.launches = 0
conv_kxk_fused.sm90_launches = 0


def _check_cout_tile(cout: int, cout_tile: int) -> None:
    if cout_tile < 1 or cout % cout_tile:
        raise ValueError(f"cout_tile {cout_tile} does not divide Cout {cout}")


def conv2x2_fused(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                  beta: torch.Tensor, *, block_rows: int = 8, cout_tile: int = 256,
                  variant: str = "im2col4") -> torch.Tensor:
    """The 2x2 case (``tpu_deep_shootout_r4.py::conv2x2_fused``): w is
    ``[2, 2, Cin, Cout]``. `block_rows`, `cout_tile` and `variant` are
    checked and steer nothing."""
    _check_shapes(x, w, alpha, beta, sizes=(2,))
    if variant not in _VARIANTS_2X2:
        raise ValueError(f"variant must be one of {_VARIANTS_2X2}, got {variant!r}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    _check_cout_tile(w.shape[3], cout_tile)
    return conv_kxk_fused(x, w, alpha, beta)


def conv_rows3_col(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor, *, block_rows: int = 8, block_cols: int = 256,
                   cout_tile: Optional[int] = None) -> torch.Tensor:
    """The k x k case, k = w.shape[0] in (2, 3)
    (``tpu_deep_shootout_r4.py::conv_rows3_col``). `block_rows`,
    `block_cols` and `cout_tile` (default min(Cout, 256)) are checked and
    steer nothing."""
    _check_shapes(x, w, alpha, beta, sizes=_SIZES)
    if block_rows < 1 or block_cols < 1:
        raise ValueError(f"block_rows and block_cols must be >= 1, got {block_rows} "
                         f"and {block_cols}")
    cout = w.shape[3]
    _check_cout_tile(cout, cout_tile or min(cout, 256))
    return conv_kxk_fused(x, w, alpha, beta)
