"""The level-0 encoder chain in three stages: the Hopper kernels in
``tpu_unet_torch/csrc/enc0_stages.cu``, their plain PyTorch versions, and
converters from the TPU probes' weight layouts.

The TPU kernels are the piece kernels of ``scripts/tpu_mosaic_probe.py``
and ``scripts/tpu_mosaic_probe3.py`` (their ``main``), which compile K4's
pieces one at a time at the block [8, 512, 64]. They compute three
functions:

* `conv1_stage`: the 3x3 1 -> C conv + ReLU, rounded once to bf16, from an
  image (``k_conv1``) or from a 9-tap slab (A, ``k_conv1_dot``). f32 sums
  of f32 products, taps in the order (dy, dx); an optional bias after them.
* `conv2_stage`: the 3x3 C -> C' valid conv of bf16 values with f32 sums,
  stored in f32 (B, C and D: the same conv with the weights in three
  layouts) or as bf16(relu(.)) (``k_pair``, the weights in paired taps).
* `pool_quant_stage`: one pass over h that writes the skip as bf16
  (``k_multi``, G) or as int8 ``clip(rint(h * s), 0, 127)`` (``k_q8``, H),
  and the 2x2/2 max-pool as bf16 (``k_pool``, E, F, G and H's pooled map).

G and H, the assembled chain, compose the three (`probes/mosaic_probe.py`);
they are not K4, which adds biases and reads an image.

Each wrapper runs its plain version on a CPU tensor; on a CUDA tensor it
launches its kernel or raises, and counts the launch in
``<wrapper>.launches``. The kernels take C a multiple of 8 (and conv2 Cin
and Cout at most 64); the plain versions take any C.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.models.unet import _max_pool2
from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.conv_pallas import _sms
from tpu_unet_torch.ops.conv_tiles import _scalar
from tpu_unet_torch.ops.interleave import _on_cuda

SKIP_KINDS = (None, "bf16", "int8")
#: Largest Cin and Cout the conv2 kernel takes: the strip loop of
#: csrc/conv3x3_sm90.cuh keeps 9 x 64 x 64 weights in shared memory.
CONV2_MAX_C = 64


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` if contiguous and 16-byte aligned, else a fresh contiguous copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel_channels(name: str, *cs: int) -> None:
    if any(c % 8 for c in cs):
        raise ValueError(f"the {name} kernel takes channel counts that are multiples of 8, "
                         f"got {cs}")


# --- conv1 ------------------------------------------------------------------

def _check_conv1(x, w9, b, taps) -> None:
    if taps:
        if x.dim() != 4 or x.shape[3] != 9 or x.dtype != torch.float32:
            raise ValueError(f"with taps=True x must be an f32 9-tap slab [B, R, Q, 9], got "
                             f"{x.dtype} {tuple(x.shape)}")
    elif x.dim() != 3 or x.shape[1] < 3 or x.shape[2] < 3 or \
            x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be an f32 or bf16 image [B, H, W] with H, W >= 3, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if w9.dim() != 2 or w9.shape[0] != 9 or w9.shape[1] < 1:
        raise ValueError(f"w9 must be [9, C] (tap 3*dy + dx), got {tuple(w9.shape)}")
    if b is not None and tuple(b.shape) != (w9.shape[1],):
        raise ValueError(f"b must be [{w9.shape[1]}], got {tuple(b.shape)}")


def conv1_stage_plain(x: torch.Tensor, w9: torch.Tensor, b: Optional[torch.Tensor] = None,
                      *, taps: bool = False) -> torch.Tensor:
    """What the conv1 kernel computes, in plain PyTorch: the products and
    sums in f32, one tap after another."""
    _check_conv1(x, w9, b, taps)
    w = w9.float()
    if taps:
        x = x.float()
        acc = torch.zeros(x.shape[:3] + (w.shape[1],), device=x.device)
        for t in range(9):
            acc = acc + x[..., t, None] * w[t]
    else:
        xf = x.float()
        ho, wo = x.shape[1] - 2, x.shape[2] - 2
        acc = torch.zeros((x.shape[0], ho, wo, w.shape[1]), device=x.device)
        for dy in range(3):
            for dx in range(3):
                acc = acc + xf[:, dy:dy + ho, dx:dx + wo, None] * w[3 * dy + dx]
    if b is not None:
        acc = acc + b.float()
    return torch.relu(acc).to(torch.bfloat16)


def conv1_stage(x: torch.Tensor, w9: torch.Tensor, b: Optional[torch.Tensor] = None, *,
                taps: bool = False) -> torch.Tensor:
    """bf16(relu(sum_t x_t * w9[t] + b)).

    taps=False: x an f32 or bf16 image [B, H, W], x_t its window shifted by
    (dy, dx) = divmod(t, 3) -> [B, H-2, W-2, C] (``k_conv1``). taps=True: x
    an f32 9-tap slab [B, R, Q, 9], x_t its tap t -> [B, R, Q, C] (A). w9
    [9, C] f32 (tap 3*dy + dx); b [C] or None (no bias).

    On a CPU tensor: `conv1_stage_plain`. On a CUDA tensor: the kernel (C a
    multiple of 8), counted in ``conv1_stage.launches``."""
    _check_conv1(x, w9, b, taps)
    ts = (x, w9) if b is None else (x, w9, b)
    if not _on_cuda("conv1_stage", *ts):
        return conv1_stage_plain(x, w9, b, taps=taps)
    c = w9.shape[1]
    _kernel_channels("conv1_stage", c)
    x = _aligned(x)
    wf = _aligned(w9.float())
    bf = _aligned(b.float()) if b is not None else torch.zeros(c, device=x.device)
    bsz, h, w = x.shape[:3]
    oshape = (bsz, h, w, c) if taps else (bsz, h - 2, w - 2, c)
    out = torch.empty(oshape, dtype=torch.bfloat16, device=x.device)
    _build.launch("conv1_stage", _build.load_library().enc0_conv1_stage, x.get_device(),
                  x.data_ptr(), wf.data_ptr(), bf.data_ptr(), out.data_ptr(), bsz, h, w, c,
                  int(x.dtype == torch.bfloat16), int(taps), shapes=(("x", x),))
    conv1_stage.launches += 1
    return out


# --- conv2 ------------------------------------------------------------------

def _check_conv2(h, w) -> None:
    if h.dim() != 4 or h.shape[1] < 3 or h.shape[2] < 3:
        raise ValueError(f"h must be [B, H, W, C] with H, W >= 3, got {tuple(h.shape)}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, h.shape[3]):
        raise ValueError(f"w must be HWIO [3, 3, {h.shape[3]}, C'], got {tuple(w.shape)}")
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"h and w must be bf16, got {h.dtype} and {w.dtype}")


def conv2_stage_plain(h: torch.Tensor, w: torch.Tensor, *,
                      relu_bf16: bool = False) -> torch.Tensor:
    """What the conv2 kernel computes, in plain PyTorch: an f32 conv of the
    bf16 values (on the card, with TF32 off, as the caller sets it)."""
    _check_conv2(h, w)
    y = F.conv2d(h.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    y = y.permute(0, 2, 3, 1)
    return torch.relu(y).to(torch.bfloat16) if relu_bf16 else y.contiguous()


def conv2_stage(h: torch.Tensor, w: torch.Tensor, *, relu_bf16: bool = False) -> torch.Tensor:
    """Valid 3x3 conv of bf16 h [B, H, W, C] by bf16 w [3, 3, C, C'] with
    f32 sums -> f32 [B, H-2, W-2, C'] (B, C, D), or bf16(relu(.)) with
    `relu_bf16` (``k_pair``).

    On a CPU tensor: `conv2_stage_plain`. On a CUDA tensor: the kernel (C
    and C' multiples of 8, at most CONV2_MAX_C), counted in
    ``conv2_stage.launches``."""
    _check_conv2(h, w)
    if not _on_cuda("conv2_stage", h, w):
        return conv2_stage_plain(h, w, relu_bf16=relu_bf16)
    bsz, hh, ww, cin = h.shape
    cout = w.shape[3]
    _kernel_channels("conv2_stage", cin, cout)
    if cin > CONV2_MAX_C or cout > CONV2_MAX_C:
        raise ValueError(f"the conv2_stage kernel takes C and C' up to {CONV2_MAX_C}, got "
                         f"{cin} and {cout}")
    h = _aligned(h)
    # each output channel's K-contiguous row [C', 9, C]: tap-major
    w2t = w.reshape(9, cin, cout).permute(2, 0, 1).contiguous()
    out = torch.empty((bsz, hh - 2, ww - 2, cout), device=h.device,
                      dtype=torch.bfloat16 if relu_bf16 else torch.float32)
    _build.launch("conv2_stage", _build.load_library().enc0_conv2_stage, h.get_device(),
                  h.data_ptr(), w2t.data_ptr(), out.data_ptr(), bsz, hh, ww, cin, cout,
                  int(relu_bf16), _sms(h.device), shapes=(("h", h),))
    conv2_stage.launches += 1
    return out


# --- pool / quantize --------------------------------------------------------

def _check_pool(h, skip, skip_scale, pool) -> None:
    if h.dim() != 4 or h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"h must be f32 or bf16 [B, H, W, C], got {h.dtype} "
                         f"{tuple(h.shape)}")
    if h.shape[1] % 2 or h.shape[2] % 2 or h.shape[1] < 2 or h.shape[2] < 2:
        raise ValueError(f"h must have even H and W (a 2x2/2 window pass), got "
                         f"{tuple(h.shape)}")
    if skip not in SKIP_KINDS:
        raise ValueError(f"skip must be one of {SKIP_KINDS}, got {skip!r}")
    if skip == "int8":
        if skip_scale is None or not float(skip_scale) > 0:
            raise ValueError(f"an int8 skip needs skip_scale > 0, got {skip_scale!r}")
    elif skip_scale is not None:
        raise ValueError(f"skip_scale is for the int8 skip, got it with skip={skip!r}")
    if skip is None and not pool:
        raise ValueError("pool_quant_stage needs a skip or the pool")


def pool_quant_stage_plain(h: torch.Tensor, *, skip: Optional[str] = None,
                           skip_scale: Optional[float] = None, pool: bool = True
                           ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """What the pool/quantize kernel computes, in plain PyTorch."""
    _check_pool(h, skip, skip_scale, pool)
    out = None
    if skip == "bf16":
        out = h.to(torch.bfloat16)
    elif skip == "int8":
        s = _scalar(float(np.float32(skip_scale)), h.device)
        out = torch.round(h.float() * s).clamp_(0.0, 127.0).to(torch.int8)
    pooled = _max_pool2(h).to(torch.bfloat16).contiguous() if pool else None
    return out, pooled


def pool_quant_stage(h: torch.Tensor, *, skip: Optional[str] = None,
                     skip_scale: Optional[float] = None, pool: bool = True
                     ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One pass over f32 or bf16 h [B, H, W, C] (H and W even) -> (skip,
    pooled), None where not asked for.

    skip 'bf16': bf16(h). skip 'int8': clip(rint(h * skip_scale), 0, 127)
    in int8, the product rounded to f32 first; `skip_scale` multiplies, as
    the probes' 50 and 37.5 do (K4's `skip_scale` divides: pass
    f32(1 / that) for its numerics). pool: the 2x2/2 max-pool, bf16 [B,
    H/2, W/2, C].

    On a CPU tensor: `pool_quant_stage_plain`. On a CUDA tensor: the kernel
    (C a multiple of 8), counted in ``pool_quant_stage.launches``."""
    _check_pool(h, skip, skip_scale, pool)
    if not _on_cuda("pool_quant_stage", h):
        return pool_quant_stage_plain(h, skip=skip, skip_scale=skip_scale, pool=pool)
    bsz, hh, ww, c = h.shape
    _kernel_channels("pool_quant_stage", c)
    h = _aligned(h)
    out = None
    if skip is not None:
        out = torch.empty((bsz, hh, ww, c), device=h.device,
                          dtype=torch.int8 if skip == "int8" else torch.bfloat16)
    pooled = (torch.empty((bsz, hh // 2, ww // 2, c), dtype=torch.bfloat16, device=h.device)
              if pool else None)
    s = float(np.float32(skip_scale)) if skip == "int8" else 0.0
    _build.launch("pool_quant_stage", _build.load_library().enc0_pool_quant_stage, h.get_device(),
                  h.data_ptr(), out.data_ptr() if out is not None else None,
                  pooled.data_ptr() if pooled is not None else None, bsz, hh, ww, c,
                  int(h.dtype == torch.bfloat16), SKIP_KINDS.index(skip), ctypes.c_float(s),
                  int(pool), shapes=(("h", h),))
    pool_quant_stage.launches += 1
    return out, pooled


#: Kernel launches since the count was last set to 0 (CPU calls don't count).
conv1_stage.launches = 0
conv2_stage.launches = 0
pool_quant_stage.launches = 0


# --- the probes' weight layouts -> HWIO [3, 3, C, C'] -----------------------

def hwio_from_pair(wp: torch.Tensor) -> torch.Tensor:
    """``k_pair``'s [5, 2C, C'] (``tpu_mosaic_probe.py:75-99``): pair p
    stacks taps 2p and 2p + 1 along K; pair 4's second half multiplies
    zeros and is dropped."""
    if wp.dim() != 3 or wp.shape[0] != 5 or wp.shape[1] % 2:
        raise ValueError(f"pair weights must be [5, 2C, C'], got {tuple(wp.shape)}")
    c = wp.shape[1] // 2
    taps = [wp[t // 2, (t % 2) * c:(t % 2 + 1) * c] for t in range(9)]
    return torch.stack(taps).reshape(3, 3, c, wp.shape[2])


def hwio_from_nconcat(wc: torch.Tensor, cout: Optional[int] = None) -> torch.Tensor:
    """B's [3, C, 3L] (``tpu_mosaic_probe3.py:104-108``): row dy holds tap
    (dy, dx) in lanes [dx L, dx L + C'), the rest zero. C' defaults to C
    (the probe's C -> C conv)."""
    if wc.dim() != 3 or wc.shape[0] != 3 or wc.shape[2] % 3:
        raise ValueError(f"nconcat weights must be [3, C, 3L], got {tuple(wc.shape)}")
    lanes = wc.shape[2] // 3
    cout = wc.shape[1] if cout is None else cout
    if not 1 <= cout <= lanes:
        raise ValueError(f"C' must be in [1, {lanes}], got {cout}")
    return torch.stack([torch.stack([wc[dy, :, dx * lanes:dx * lanes + cout]
                                     for dx in range(3)]) for dy in range(3)])


def hwio_from_rows3(wr: torch.Tensor) -> torch.Tensor:
    """C's [3, 3C, C'] (``tpu_mosaic_probe3.py:129``): row dy holds taps
    (dy, 0..2) stacked along K."""
    if wr.dim() != 3 or wr.shape[0] != 3 or wr.shape[1] % 3:
        raise ValueError(f"rows3 weights must be [3, 3C, C'], got {tuple(wr.shape)}")
    return wr.reshape(3, 3, wr.shape[1] // 3, wr.shape[2])


def hwio_from_im2col(wf: torch.Tensor) -> torch.Tensor:
    """D's [9C, C'] (``tpu_mosaic_probe3.py:152``): the nine taps stacked
    along K, tap-major."""
    if wf.dim() != 2 or wf.shape[0] % 9:
        raise ValueError(f"im2col weights must be [9C, C'], got {tuple(wf.shape)}")
    return wf.reshape(3, 3, wf.shape[0] // 9, wf.shape[1])
