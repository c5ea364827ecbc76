"""Fused level-0 kernels of the research int8 forward (``fused_enc0``,
``fused_concat`` in infer/quant_research.py): K4 and K5, the Hopper kernels
in ``tpu_unet_torch/csrc/enc0_chain.cu`` and ``csrc/concat_quantize.cu``,
and their plain PyTorch versions.

Counterpart of ``tpu_unet/ops/fused_level0.py``, with the Pallas kernels'
numerics (not those of the unfused composition):

* `enc0_chain`: conv3x3(1 -> C) + ReLU, conv3x3(C -> C) + ReLU and the 2x2
  max-pool in one pass. conv1 is an f32 sum of f32 products (x and w1 as
  given), + b1, ReLU, one bf16 rounding; conv2 multiplies bf16 by bf16
  (w2 rounded to bf16) and sums in f32, + b2, ReLU: h2 in f32. The skip is
  bf16(h2), or, when ``skip_scale`` > 0, int8 clamp(rint(h2 *
  f32(1/skip_scale)), 0, 127) from the f32 h2; the pooled map is bf16(max
  of h2).
* `concat_quantize`: round(concat(a, b) * f32(1/scale)) clamped to int8
  [-127, 127]; an int8 half passes through. It multiplies by the f32
  reciprocal, as the Pallas kernel does (the production
  `quantize_activations` divides).

Each wrapper runs its plain version on a CPU tensor; on a CUDA tensor it
launches its kernel or raises, and counts the launch in
``<wrapper>.launches``. K4 has two routes: ``"sm90"`` (what `enc0_chain`
takes: the strip loop's wgmma step of ``csrc/conv3x3_sm90.cuh`` fed by the
conv1 producer of ``csrc/enc0_conv1.cuh``, walking `enc0_plan`'s tiles,
also counted in ``enc0_chain.sm90_launches``) and ``"simple"`` (the first
kernel, run only through `_enc0_chain_route_forward`, for comparisons).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.models.unet import _max_pool2
from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.conv_pallas import _sms
from tpu_unet_torch.ops.conv_tiles import _scalar
from tpu_unet_torch.ops.enc0_stages import _aligned
from tpu_unet_torch.ops.interleave import _on_cuda, _packed

_POOL_MODES = ("fused", "cols", "none")
#: Largest C the K4 kernels take: conv2's weights (9 x 64 x 64) stay in
#: shared memory.
ENC0_MAX_C = 64
#: K4's routes: "sm90" (the strip wgmma loop with the conv1 producer, what
#: `enc0_chain` takes) and "simple" (the first kernel, only when forced).
ENC0_ROUTES = ("sm90", "simple")
#: Output rows x columns of a tile of the sm90 route: one pool row pair,
#: 44 pool windows.
ENC0_TILE = (2, 88)


def _inverse(scale) -> float:
    """float32(1 / scale), the reciprocal computed in double as the JAX
    package computes it on the host."""
    return float(np.float32(1.0 / float(scale)))


# --- K4 ---------------------------------------------------------------------

def _check_enc0(x, w1, b1, w2, b2, block_rows, block_cols, skip_scale, pool_mode) -> None:
    """The JAX function's checks (its asserts, as ValueError here), plus the
    shapes of the weights and the pool_mode name."""
    if x.dim() != 4 or x.shape[3] != 1:
        raise ValueError(f"enc0_chain fuses the single-channel stem: x must be "
                         f"[B, H, W, 1], got {tuple(x.shape)}")
    ho, wo = x.shape[1] - 4, x.shape[2] - 4
    if ho < 2 or wo < 2 or ho % 2 or wo % 2:
        raise ValueError(f"enc0_chain needs H - 4 and W - 4 even and positive, got "
                         f"{ho} and {wo}")
    if block_rows % 2 or block_cols % 16:
        raise ValueError(f"block_rows must be even and block_cols a multiple of 16, got "
                         f"{block_rows} and {block_cols}")
    if pool_mode not in _POOL_MODES:
        raise ValueError(f"pool_mode must be one of {_POOL_MODES}, got {pool_mode!r}")
    if pool_mode == "none" and skip_scale > 0:
        # The JAX function then pools the quantized integers (its skip cast
        # to bf16), a map in units of 1/skip_scale: not copied.
        raise ValueError("pool_mode='none' with an int8 skip (skip_scale > 0) would pool "
                         "the quantized skip; use 'fused' or 'cols'")
    if w1.dim() != 4 or tuple(w1.shape[:3]) != (3, 3, 1):
        raise ValueError(f"w1 must be [3, 3, 1, C], got {tuple(w1.shape)}")
    c = w1.shape[3]
    if tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"w2 must be [3, 3, {c}, {c}], got {tuple(w2.shape)}")
    for name, t in (("b1", b1), ("b2", b2)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(t.shape)}")


def enc0_chain_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     skip_scale: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K4 computes, in plain PyTorch (f32 convs of the same values)."""
    h1 = F.conv2d(x.float().permute(0, 3, 1, 2), w1.float().permute(3, 2, 0, 1))
    h1 = torch.relu(h1.permute(0, 2, 3, 1) + b1.float()).to(torch.bfloat16)
    k2 = w2.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    h2 = F.conv2d(h1.float().permute(0, 3, 1, 2), k2).permute(0, 2, 3, 1)
    h2 = torch.relu(h2 + b2.float())
    if skip_scale > 0:
        inv = _scalar(_inverse(skip_scale), h2.device)
        skip = torch.round(h2 * inv).clamp_(0.0, 127.0).to(torch.int8)
    else:
        skip = h2.to(torch.bfloat16)
    return skip.contiguous(), _max_pool2(h2).to(torch.bfloat16).contiguous()


class Enc0Plan(NamedTuple):
    """The sm90 route's walk over x [B, H, W, 1]: tiles of ENC0_TILE =
    (2, 88) output rows x columns, `tiles_c` per tile row, `tiles_img` per
    image, `tiles` in all (tile t is `enc0_tile(plan, t)`)."""
    tiles_c: int
    tiles_img: int
    tiles: int


def enc0_plan(bsz: int, h: int, w: int) -> Enc0Plan:
    """The walk of K4's sm90 route over x [bsz, h, w, 1]: B * (H-4)/2 *
    ceil((W-4)/88) tiles. The CUDA entry refuses any other plan, so this is
    the arithmetic the kernel uses."""
    ho, wo = h - 4, w - 4
    if bsz < 1 or ho < 2 or wo < 2 or ho % 2 or wo % 2:
        raise ValueError(f"enc0_plan needs B >= 1 and H - 4, W - 4 even and positive, got "
                         f"B {bsz}, H - 4 = {ho}, W - 4 = {wo}")
    tiles_c = -(-wo // ENC0_TILE[1])
    tiles_img = ho // ENC0_TILE[0] * tiles_c
    return Enc0Plan(tiles_c, tiles_img, bsz * tiles_img)


def enc0_tile(plan: Enc0Plan, t: int) -> Tuple[int, int, int]:
    """(image, first output row, first output column) of tile `t`, as the
    kernel decodes it (`walk_at` in csrc/enc0_chain.cu): row pairs run
    fastest, then column tiles, then images, so that a block's contiguous
    range of tiles walks down columns and reuses the h1 rows two vertical
    neighbours share. The tile's outputs are rows oy, oy + 1 and the columns
    ox0 .. ox0 + 87 inside the image; its pooled outputs row oy / 2, columns
    ox0 / 2 .. ox0 / 2 + 43."""
    b, rem = divmod(t, plan.tiles_img)
    pairs = plan.tiles_img // plan.tiles_c
    return b, rem % pairs * ENC0_TILE[0], rem // pairs * ENC0_TILE[1]


def enc0_block_tiles(plan: Enc0Plan, blocks: int, i: int) -> range:
    """The tiles block `i` of a grid of `blocks` walks: a contiguous range,
    i * tiles // blocks up to (i + 1) * tiles // blocks, as the kernel
    splits the walk."""
    return range(i * plan.tiles // blocks, (i + 1) * plan.tiles // blocks)


def enc0_chain_route(x: torch.Tensor, c: int) -> str:
    """The route K4 takes for x [B, H, W, 1] to C channels on the card:
    ``"sm90"`` wherever the kernels take the shape (C a multiple of 8 up to
    ENC0_MAX_C, H - 4 and W - 4 even and positive); ValueError elsewhere.
    ``"simple"``, the first kernel, runs only when forced
    (`_enc0_chain_route_forward`)."""
    ho, wo = x.shape[1] - 4, x.shape[2] - 4
    if c % 8 or not 8 <= c <= ENC0_MAX_C or ho < 2 or wo < 2 or ho % 2 or wo % 2:
        raise ValueError(f"the enc0_chain kernels take C a multiple of 8 up to {ENC0_MAX_C} "
                         f"and H - 4, W - 4 even and positive, got C {c}, x "
                         f"{tuple(x.shape)}")
    return "sm90"


def _enc0_forward(x, w1, b1, w2, b2, skip_scale: float, route: str):
    """K4 on checked CUDA tensors through `route`."""
    bsz, h, w, _ = x.shape
    c = w1.shape[3]
    enc0_chain_route(x, c)
    x2 = x[..., 0]
    if x2.dtype != torch.bfloat16:
        x2 = x2.float()
    x2 = x2.contiguous()
    w1f = _aligned(w1.float().reshape(9, c))
    b1f, b2f = _aligned(b1.float()), _aligned(b2.float())
    skip = torch.empty((bsz, h - 4, w - 4, c), device=x.device,
                       dtype=torch.int8 if skip_scale > 0 else torch.bfloat16)
    pooled = torch.empty((bsz, (h - 4) // 2, (w - 4) // 2, c), dtype=torch.bfloat16,
                         device=x.device)
    common = (int(x2.dtype == torch.bfloat16), int(skip_scale > 0),
              ctypes.c_float(_inverse(skip_scale) if skip_scale > 0 else 0.0))
    lib = _build.load_library()
    shapes = (("x", x), ("C", c))
    if route == "sm90":
        # conv2's weights K-major [C, 9, C], as the strip loop reads them
        w2k = w2.to(torch.bfloat16).reshape(9, c, c).permute(2, 0, 1).contiguous()
        plan = enc0_plan(bsz, h, w)
        _build.launch("enc0_chain (sm90 route)", lib.enc0_chain_sm90, x.get_device(),
                      x2.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), w2k.data_ptr(),
                      b2f.data_ptr(), skip.data_ptr(), pooled.data_ptr(), bsz, h, w, c, *common,
                      plan.tiles, plan.tiles_c, plan.tiles_img, _sms(x.device), shapes=shapes)
    else:
        cp = -(-c // 16) * 16
        # conv2's weights as each output channel's K-contiguous row [C, 9, CP]:
        # tap-major, input channels zero-padded to CP
        w2t = torch.zeros((c, 9, cp), dtype=torch.bfloat16, device=x.device)
        w2t[:, :, :c] = w2.to(torch.bfloat16).reshape(9, c, c).permute(2, 0, 1)
        _build.launch("enc0_chain (simple route)", lib.enc0_chain, x.get_device(),
                      x2.data_ptr(), w1f.data_ptr(), b1f.data_ptr(), w2t.data_ptr(),
                      b2f.data_ptr(), skip.data_ptr(), pooled.data_ptr(), bsz, h, w, c, *common,
                      shapes=shapes)
    enc0_chain.launches += 1
    if route == "sm90":
        enc0_chain.sm90_launches += 1
    return skip, pooled


def enc0_chain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
               b2: torch.Tensor, *, block_rows: int = 8, block_cols: int = 256,
               skip_scale: float = 0.0,
               pool_mode: str = "fused") -> Tuple[torch.Tensor, torch.Tensor]:
    """relu(conv1(x)), relu(conv2(.)) and its 2x2 max-pool in one pass.

    x [B, H, W, 1] f32 or bf16; w1 [3, 3, 1, C]; w2 [3, 3, C, C]; b1, b2 [C].
    Returns (skip [B, H-4, W-4, C] bf16, int8 when `skip_scale` > 0, and
    pooled [B, (H-4)/2, (W-4)/2, C] bf16).

    `block_rows`, `block_cols` and `pool_mode` are the TPU kernel's knobs:
    checked as the JAX function checks them (and pool_mode by name), they
    do not change the result, since every mode returns the same maps.
    pool_mode='none' with an int8 skip raises ValueError: the JAX function
    would pool the quantized skip.

    On a CPU tensor: `enc0_chain_plain`. On a CUDA tensor: the Hopper kernel
    on the route `enc0_chain_route` gives ("sm90"; C a multiple of 8, at
    most ENC0_MAX_C), counted in ``enc0_chain.launches`` and
    ``enc0_chain.sm90_launches``; a refused launch raises RuntimeError."""
    _check_enc0(x, w1, b1, w2, b2, block_rows, block_cols, skip_scale, pool_mode)
    if not _on_cuda("enc0_chain", x, w1, b1, w2, b2):
        return enc0_chain_plain(x, w1, b1, w2, b2, skip_scale)
    return _enc0_forward(x, w1, b1, w2, b2, skip_scale, enc0_chain_route(x, w1.shape[3]))


def _enc0_chain_route_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                              w2: torch.Tensor, b2: torch.Tensor, route: str,
                              skip_scale: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 through the named route, whatever `enc0_chain_route` would pick:
    ``"simple"`` runs the first kernel. For timing the two in turns on the
    card; no path of the model calls it. An unknown route raises
    ValueError; on a CPU tensor every route runs `enc0_chain_plain`."""
    if route not in ENC0_ROUTES:
        raise ValueError(f"no route {route!r}; the routes are {ENC0_ROUTES}")
    _check_enc0(x, w1, b1, w2, b2, 8, 256, skip_scale, "fused")
    if not _on_cuda("enc0_chain", x, w1, b1, w2, b2):
        return enc0_chain_plain(x, w1, b1, w2, b2, skip_scale)
    return _enc0_forward(x, w1, b1, w2, b2, skip_scale, route)


# --- K5 ---------------------------------------------------------------------

def concat_quantize_plain(a: torch.Tensor, b: torch.Tensor, scale) -> torch.Tensor:
    """What K5 computes, in plain PyTorch."""
    inv = _scalar(_inverse(scale), a.device)

    def q(t):
        if t.dtype == torch.int8:
            return t
        return torch.round(t.to(torch.bfloat16).float() * inv).clamp_(-127.0, 127.0).to(
            torch.int8)

    return torch.cat([q(a), q(b)], dim=-1)


def concat_quantize(a: torch.Tensor, b: torch.Tensor, scale, *,
                    block_rows: int = 8) -> torch.Tensor:
    """round(concat([a, b], -1) * f32(1/scale)) clamped to int8 [-127, 127].

    a, b [B, H, W, C], each int8 (already at `scale`, passed through) or
    float (rounded to bf16 first, as the JAX function does) -> [B, H, W, 2C]
    int8.

    `block_rows` is the TPU kernel's row block: an int >= 1 (else
    ValueError; JAX fails on 0 with a ZeroDivisionError), it steers nothing.

    On a CPU tensor: `concat_quantize_plain`. On a CUDA tensor: the Hopper
    kernel, counted in ``concat_quantize.launches``. It reads each half
    through its batch and row strides, so a center-cropped view (the
    decoder's skip) is not copied first; a half whose (W, C) dims are not
    packed is made contiguous."""
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"concat_quantize needs two equal [B, H, W, C] shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if isinstance(block_rows, bool) or not isinstance(block_rows, int) or block_rows < 1:
        raise ValueError(f"block_rows must be an int >= 1, got {block_rows!r}")
    a = a if a.dtype == torch.int8 else a.to(torch.bfloat16)
    b = b if b.dtype == torch.int8 else b.to(torch.bfloat16)
    if not _on_cuda("concat_quantize", a, b):
        return concat_quantize_plain(a, b, scale)
    a, b = _packed(a), _packed(b)
    bsz, h, w, c = a.shape
    out = torch.empty((bsz, h, w, 2 * c), dtype=torch.int8, device=a.device)
    if out.numel() == 0:
        return out
    strides = [t.stride(d) for t in (a, b) for d in (0, 1)]
    vec = int(c % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in (a, b, out))
              and all(t.stride(d) * t.element_size() % 16 == 0
                      for t in (a, b) for d in (0, 1)))
    _build.launch("concat_quantize", _build.load_library().concat_quantize, a.get_device(),
                  a.data_ptr(), b.data_ptr(), out.data_ptr(), *strides, bsz, h, w, c,
                  int(a.dtype == torch.int8), int(b.dtype == torch.int8),
                  ctypes.c_float(_inverse(scale)), vec, shapes=(("a", a),))
    concat_quantize.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls don't count):
#: all routes, and K4's sm90 route alone.
enc0_chain.launches = 0
enc0_chain.sm90_launches = 0
concat_quantize.launches = 0
