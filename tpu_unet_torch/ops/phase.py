"""Phase packing (space-to-depth) of the level-0 neighbourhood: the port's
own copy of ``tpu_unet/ops/phase.py``.

A stride-1 3x3 valid conv over the 2x2 phase decomposition of an image,
``x2[2i+p, 2j+q, c] -> X[i, j, (p*2+q)*C + c]``, is a 2x2 valid conv with
4x the channels and a packed kernel of fixed 9/16 density. Max-pool 2x2
consumes one phase block (a max over the four phase groups, whose result is
the unpacked next-level tensor), the 2x2/stride-2 transposed conv is one
``[.., Ci] @ [Ci, 4Co]`` matmul whose output is already packed, skip crops
are spatial crops by half the (even) margin, and the 1x1 head is a per-phase
matmul; the only depth-to-space runs on the logits.

Layouts are the JAX package's: NHWC activations, HWIO kernels (packed:
``[2, 2, 4Ci, 4Co]``), phase-major channels ``(p*2+q)*C + c``. The numpy
helpers run once per checkpoint; the torch ones are differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.ops.conv_tiles import conv_int8_acc


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] (phase-major), H and W even."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H, W; got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """[B, h, w, 4C] -> [B, 2h, 2w, C]; inverse of `space_to_depth`."""
    b, h, w, c4 = x.shape
    if c4 % 4:
        raise ValueError(f"depth_to_space needs 4|C; got {c4}")
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


# The 9/16 tap placements shared by both packers: (packed window position
# aa/bb, input-phase index p*2+q, output-phase index r*2+s) -> source tap
# (a, b) of the 3x3 kernel. 36 placements.
_PACK_PLACEMENTS: Tuple[Tuple[int, int, int, int, int, int], ...] = tuple(
    (aa, bb, p * 2 + q, r * 2 + s, 2 * aa + p - r, 2 * bb + q - s)
    for aa in range(2) for bb in range(2)
    for p in range(2) for q in range(2)
    for r in range(2) for s in range(2)
    if 0 <= 2 * aa + p - r <= 2 and 0 <= 2 * bb + q - s <= 2)


def _check_3x3(shape, who: str) -> None:
    if tuple(shape[:2]) != (3, 3):
        raise ValueError(f"{who} expects 3x3, got {shape[0]}x{shape[1]}")


def phase_pack_kernel(w) -> np.ndarray:
    """[3, 3, Ci, Co] conv kernel -> its [2, 2, 4Ci, 4Co] phase-domain form
    (numpy): ``conv2x2(s2d(x), phase_pack_kernel(w)) == s2d(conv3x3(x, w))``
    for even input sizes, with ``W2[A, B, (p,q,c), (r,s,o)] =
    w[2A+p-r, 2B+q-s, c, o]`` where the tap indices land in [0, 2] and zero
    elsewhere."""
    w = np.asarray(w)
    _check_3x3(w.shape, "phase_pack_kernel")
    _, _, ci, co = w.shape
    out = np.zeros((2, 2, 4, ci, 4, co), w.dtype)
    for aa, bb, pq, rs, a, b in _PACK_PLACEMENTS:
        out[aa, bb, pq, :, rs, :] = w[a, b]
    return out.reshape(2, 2, 4 * ci, 4 * co)


def phase_pack_kernel_torch(w: torch.Tensor) -> torch.Tensor:
    """Differentiable `phase_pack_kernel` on a torch [3, 3, Ci, Co] kernel,
    so that a training forward keeps the canonical parameters and autograd
    sums the 9/16 placements back onto the 3x3 gradient.

    For output phase (r, s) the taps read, over the packed window position
    and input phase t = 2A + p (and likewise columns), are w[t + 1 - r]:
    one 4 x 4 slice of w zero-padded by one tap on each side. Four slices,
    one stack and one permute build the packed kernel, a handful of kernel
    launches forward and backward where the 36 placements one index write
    each would cost some hundreds."""
    _check_3x3(w.shape, "phase_pack_kernel_torch")
    _, _, ci, co = w.shape
    wp = F.pad(w, (0, 0, 0, 0, 1, 1, 1, 1))                   # [5, 5, Ci, Co]
    out = torch.stack([wp[1 - r:5 - r, 1 - s:5 - s] for r in range(2) for s in range(2)])
    # [rs, (A, p), (B, q), Ci, Co] -> [A, B, (p, q), Ci, rs, Co]
    out = out.reshape(4, 2, 2, 2, 2, ci, co).permute(1, 3, 2, 4, 5, 0, 6)
    return out.reshape(2, 2, 4 * ci, 4 * co)


def phase_bias(bias: torch.Tensor) -> torch.Tensor:
    """[C] bias -> its packed [4C] form (channel phi*C + c reads bias[c])."""
    return bias.repeat(4)


def mirrored_upconv_matrix(kernel):
    """[2, 2, Ci, Co] transposed-conv kernel (the JAX package's layout,
    applied spatially flipped) -> the packed ``[Ci, 4Co]`` matmul matrix,
    columns phase-major ((dy*2+dx)*Co + c). Takes numpy arrays and torch
    tensors."""
    kh, kw, ci, co = kernel.shape
    if (kh, kw) != (2, 2):
        raise ValueError(f"mirrored_upconv_matrix expects 2x2, got {kh}x{kw}")
    if isinstance(kernel, torch.Tensor):
        return kernel.flip((0, 1)).permute(2, 0, 1, 3).reshape(ci, 4 * co)
    return kernel[::-1, ::-1].transpose(2, 0, 1, 3).reshape(ci, 4 * co)


def phase_upconv_matmul(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable packed 2x2/stride-2 transposed conv: [B, h, w, Ci] ->
    packed [B, h, w, 4Co] as one matmul of `dtype` values summed in f32, the
    bias added in f32, one rounding to `dtype`. `kernel` is the JAX layout
    [2, 2, Ci, Co]."""
    b, h, w, cin = x.shape
    wr = mirrored_upconv_matrix(kernel.to(dtype)).float()
    y = x.to(dtype).float().reshape(b * h * w, cin) @ wr
    y = y + phase_bias(bias.float())
    return y.to(dtype).reshape(b, h, w, wr.shape[1])


def phase_head_matmul(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Packed 1x1 head: [B, h, w, 4C] @ [1, 1, C, O] -> packed f32
    [B, h, w, 4O] (block-diagonal over the phase groups, as a per-phase
    matmul of x's values summed in f32, plus the f32 bias)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    k = kernel[0, 0].to(x.dtype).float()
    y = x.float().reshape(b, h, w, 4, c) @ k + bias.float()
    return y.reshape(b, h, w, 4 * k.shape[1])


def phase_pool(x: torch.Tensor) -> torch.Tensor:
    """Packed-domain 2x2/stride-2 max-pool: [B, h, w, 4C] -> [B, h, w, C],
    the unpacked next-level tensor."""
    b, h, w, c4 = x.shape
    return x.reshape(b, h, w, 4, c4 // 4).amax(dim=3)


def phase_upconv_weights(k, bias=None) -> Tuple[np.ndarray, np.ndarray]:
    """2x2/stride-2 transposed-conv kernel [2, 2, Ci, Co] (numpy, the JAX
    layout) -> its packed matmul form ``[Ci, 4Co]`` and the matching [4Co]
    bias."""
    k = np.asarray(k)
    co = k.shape[-1]
    m = mirrored_upconv_matrix(k)
    if bias is None:
        return m, np.zeros((4 * co,), k.dtype)
    return m, np.tile(np.asarray(bias), 4)


def phase_head_kernel(k) -> np.ndarray:
    """1x1 head kernel [1, 1, C, O] -> block-diagonal packed [1, 1, 4C, 4O]."""
    k = np.asarray(k)
    _, _, c, o = k.shape
    out = np.zeros((1, 1, 4, c, 4, o), k.dtype)
    for phi in range(4):
        out[0, 0, phi, :, phi, :] = k[0, 0]
    return out.reshape(1, 1, 4 * c, 4 * o)


def phase_crop(x: torch.Tensor, margin: int) -> torch.Tensor:
    """Center-crop a packed tensor by `margin` full-resolution pixels per
    side (a strided view). The margin must be even (phase alignment)."""
    if margin % 2:
        raise ValueError(f"phase crop margin must be even, got {margin}")
    m = margin // 2
    if m == 0:
        return x
    return x[:, m:-m, m:-m, :]


def conv2x2_valid(x: torch.Tensor, w: torch.Tensor,
                  preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain 2x2 valid conv (NHWC x, HWIO w), the packed-domain conv atom.
    int8 inputs give int32 sums through the library accumulate
    (`ops.conv_tiles.conv_int8_acc`); float inputs are summed in f32 by
    ``F.conv2d`` and returned as `preferred` (default: x's dtype)."""
    if x.dtype == torch.int8:
        if preferred not in (None, torch.int32):
            raise ValueError(f"int8 inputs accumulate to int32, not {preferred}")
        return conv_int8_acc(x, w)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).to(preferred or x.dtype)
