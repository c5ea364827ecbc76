"""Fused 3x3 valid conv + scale + bias + ReLU (+ requantize) for int8 and
bf16 serving: the Hopper kernel K3, its plain PyTorch version, the int8
library route, the quantizers, and the int4 tier's helpers.

Counterpart of ``tpu_unet/ops/conv_tiles.py``. Layouts
are the JAX package's: x NHWC ``[B, H, W, Cin]``, w HWIO ``[3, 3, Cin,
Cout]``, alpha and beta f32 ``[Cout]`` -> ``[B, H-2, W-2, Cout]``.

Quantization contract (symmetric, per-output-channel weights):
  x_q = round(x / s_x),  w_q[..., c] = round(w[..., c] / s_w[c])
  conv_f32 ~= acc_i32 * (s_x * s_w[c])
  bf16 out : alpha = s_x * s_w,        beta = bias        -> relu(acc*a+b)
  int8 out : alpha = s_x * s_w / s_y,  beta = bias / s_y  -> clamp(round(...),
             0, 127) (post-ReLU activations are non-negative).
Rounding is half to even everywhere, as ``jnp.round``; the epilogue
multiplies and adds in two f32 roundings, as XLA does.

Two routes compute the int8 conv:

* `conv3x3_fused` (K3, ``impl='pallas'`` of the quantized engine): the
  hand-written CUDA kernels of ``tpu_unet_torch/csrc/conv3x3_fused.cu`` (with
  ``csrc/conv_fused.cuh``, shared with the k x k conv), on one of two routes
  that `conv3x3_fused_route` picks by shape: ``"sm90"`` (int8 x with Cin a
  multiple of 16, Cout a multiple of 16 for int8 out or 8 for bf16 out, x
  16-byte aligned: the int8 wgmma loop, in the block `sm90_block` picks)
  and ``"simple"`` (the one-stage kernel: bf16 inputs, the rest). On a CPU
  tensor it runs `conv3x3_fused_plain`; on a CUDA tensor it launches a
  kernel or raises, and counts the launch in ``conv3x3_fused.launches``
  (the sm90 route's also in ``conv3x3_fused.sm90_launches``).
* `conv3x3_int8_xla` (``impl='xla'``): `conv_int8_acc`, an im2col and
  ``torch._int_mm`` (cuBLASLt's int8 GEMM with int32 output on the card),
  the counterpart of XLA's int8 conv, followed by the same epilogue in
  PyTorch. It takes 3x3 and 2x2 kernels, as the JAX function does; K3
  takes 3x3 only.

The int4 convs (`conv3x3_int4_acc`, `conv3x3_int4_xla`) are XLA-level in the
JAX package, with no TPU kernel under them: on the card they take the int8
library route on int4-range values, on the CPU an exact f64 conv.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops import _build

_OUT_KINDS = ("auto", "int8", "bf16")
_EPILOGUE_KINDS = ("int8", "u4s", "bf16")
_VARIANTS = ("nconcat", "taps", "rows3", "im2col")
_INT32_MAX = 2 ** 31 - 1
#: Largest im2col buffer `conv3x3_int8_xla` builds at once, in bytes.
IM2COL_BYTES = 1 << 30


def _scalar(s, device, dtype=torch.float32) -> torch.Tensor:
    """`s` as a 0-dim tensor on `device`. Dividing a CUDA tensor by a Python
    number multiplies by its reciprocal instead, which can differ in the
    last bit from the division JAX does."""
    return torch.as_tensor(s, dtype=dtype).to(device)


# --- quantization helpers ---------------------------------------------------

def quantize_activations(x: torch.Tensor, scale) -> torch.Tensor:
    """f32/bf16 [..., C] -> int8 with the given (scalar) symmetric scale."""
    q = torch.round(x.float() / _scalar(scale, x.device))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def _quantize_weights(w: torch.Tensor, levels: float) -> Tuple[torch.Tensor, torch.Tensor]:
    w = w.float()
    s = w.abs().amax(dim=(0, 1, 2)) / _scalar(levels, w.device)
    s = torch.clamp_min(s, 1e-12)
    q = torch.round(w / s).clamp_(-levels, levels).to(torch.int8)
    return q, s


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[3, 3, Cin, Cout] f32 -> (int8 weights, per-output-channel scales)."""
    return _quantize_weights(w, 127.0)


# --- the int4 tier ------------------------------------------------------------
# int4-range values are stored as int8, as the JAX package stores them. Two
# activation encodings: shifted-u4 ("u4s") for post-ReLU tensors, u in
# [0, 15] stored as u - 8 in [-8, 7], and signed s4 in [-7, 7]. Scalar
# ratios are formed in Python (f64) and rounded to f32 once, as JAX rounds a
# Python float operand of an f32 array.

def quantize_weights_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[3, 3, Cin, Cout] f32 -> (int4-range weights in [-7, 7] stored as
    int8, per-output-channel scales max|w| / 7)."""
    return _quantize_weights(w, 7.0)


def quantize_activations_u4s(x: torch.Tensor, scale) -> torch.Tensor:
    """f32/bf16 post-ReLU [..., C] -> shifted-u4: clip(round(x / scale), 0,
    15) - 8 as int8; `scale` is the tensor's post-ReLU max / 15."""
    u = torch.round(x.float() / _scalar(scale, x.device)).clamp_(0.0, 15.0)
    return (u - 8.0).to(torch.int8)


def quantize_activations_s4(x: torch.Tensor, scale) -> torch.Tensor:
    """f32/bf16 signed [..., C] -> int4-range int8 in [-7, 7]; `scale` is
    abs-max / 7."""
    q = torch.round(x.float() / _scalar(scale, x.device))
    return q.clamp_(-7.0, 7.0).to(torch.int8)


def requantize_i8_to_u4s(v: torch.Tensor, s8: float, s4: float) -> torch.Tensor:
    """int8 post-ReLU values at scale `s8` -> shifted-u4 at scale `s4`:
    round(q * s8/s4), the u4 requantize of the dequantized value."""
    u = torch.round(v.float() * _scalar(s8 / s4, v.device)).clamp_(0.0, 15.0)
    return (u - 8.0).to(torch.int8)


def requantize_u4s_to_i8(v: torch.Tensor, s4: float, s8: float) -> torch.Tensor:
    """Shifted-u4 post-ReLU values at scale `s4` -> int8 at scale `s8` (an
    int4 producer feeding an int8 consumer)."""
    q = torch.round((v.float() + 8.0) * _scalar(s4 / s8, v.device))
    return q.clamp_(0.0, 127.0).to(torch.int8)


def conv3x3_int4_acc(x_q: torch.Tensor, w_q: torch.Tensor, shifted: bool = False
                     ) -> torch.Tensor:
    """The int32 sums of the int4 x int4 3x3 valid conv; `x_q` and `w_q`
    hold int4-range values stored as int8 (NHWC, HWIO).

    `shifted=True` takes shifted-u4 activations (x_q = u - 8): the convs are
    valid, so conv(u) = conv(x_q) + 8 * sum(w_q) over (kh, kw, Cin), a
    per-output-channel int32 constant added here before any float math.

    On a CPU tensor the sums are exact: `_conv_f64` rounded to int32, the
    values of the JAX package's int32 emulation.
    On a CUDA tensor they go through `conv_int8_acc` (im2col +
    ``torch._int_mm``: int4 values are int8 values, and the sums stay far
    below 2^31). Hopper has no int4 MMA, so the JAX function's `emulate`
    backend switch has no counterpart."""
    _check_shapes(x_q, w_q, None, None)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    if x_q.device.type == "cpu":
        acc = _conv_f64(x_q, w_q).to(torch.int32)
    else:
        acc = conv_int8_acc(x_q, w_q)
    if shifted:
        acc = acc + 8 * w_q.sum(dim=(0, 1, 2), dtype=torch.int32)
    return acc


def conv3x3_int4_xla(x_q: torch.Tensor, w_q: torch.Tensor, alpha: torch.Tensor,
                     beta: torch.Tensor, out_kind: str = "bf16", shifted: bool = False
                     ) -> torch.Tensor:
    """The int4 conv with its fused scale + bias + ReLU epilogue:
    `conv3x3_int4_acc` then `int4_epilogue`."""
    acc = conv3x3_int4_acc(x_q, w_q, shifted=shifted)
    return int4_epilogue(acc, alpha, beta, out_kind=out_kind)



@contextlib.contextmanager
def tf32_for_bf16_values(enable: bool = True):
    """Let cuDNN and cuBLAS run f32 convs and matmuls in TF32 inside, when
    `enable`: only for operands that hold bf16 values, which TF32 represents
    exactly. The caller's setting is restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    if enable:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

# --- the epilogue and the plain version -------------------------------------

def _resolve_out_kind(x: torch.Tensor, out_kind: str) -> str:
    if out_kind not in _OUT_KINDS:
        raise ValueError(f"out_kind must be one of {_OUT_KINDS}, got {out_kind!r}")
    if out_kind == "auto":
        return "int8" if x.dtype == torch.int8 else "bf16"
    return out_kind


def epilogue(acc: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
             out_kind: str) -> torch.Tensor:
    """relu(acc * alpha + beta) in f32 (two roundings), then round-clamp to
    int8 in [0, 127] ('int8'), to shifted-u4 in [0, 15] minus 8 ('u4s'), or
    round to bf16 ('bf16')."""
    if out_kind not in _EPILOGUE_KINDS:
        raise ValueError(f"out_kind must be one of {_EPILOGUE_KINDS}, got {out_kind!r}")
    y = torch.relu(acc.float() * alpha.float() + beta.float())
    if out_kind == "int8":
        return torch.round(y).clamp_(0.0, 127.0).to(torch.int8)
    if out_kind == "u4s":
        return (torch.round(y).clamp_(0.0, 15.0) - 8.0).to(torch.int8)
    return y.to(torch.bfloat16)


#: The int4 convs' epilogue (the JAX package's name): 'u4s' is the next int4
#: conv's input, with the output scale baked into alpha and beta by the caller.
int4_epilogue = epilogue


def _check_shapes(x: torch.Tensor, w: torch.Tensor, alpha: Optional[torch.Tensor],
                  beta: Optional[torch.Tensor], sizes: Tuple[int, ...] = (3,)) -> None:
    """x NHWC, w HWIO [k, k, Cin, Cout] with k in `sizes`, alpha and beta
    [Cout] (None: not checked), and an image at least k x k."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, Cin], got shape {tuple(x.shape)}")
    cin = x.shape[3]
    kh = w.shape[0] if w.dim() == 4 else None
    if kh not in sizes or tuple(w.shape[1:3]) != (kh, cin):
        want = (f"{sizes[0]}, {sizes[0]}" if len(sizes) == 1
                else f"k, k (k in {sizes})")
        raise ValueError(f"w must be HWIO [{want}, {cin}, Cout], got shape "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be [{cout}], got shape {tuple(t.shape)}")
    if x.shape[1] < kh or x.shape[2] < kh:
        raise ValueError(f"a {kh}x{kh} valid conv needs H, W >= {kh}, got "
                         f"{x.shape[1]}x{x.shape[2]}")


def _conv_f64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The valid conv of NHWC x with HWIO w in f64, NHWC: exact for integer
    values, since |acc| <= 9 * Cin * 127^2 < 2^53 at any Cin the model has."""
    acc = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1))
    return acc.permute(0, 2, 3, 1)


def conv3x3_fused_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                        beta: torch.Tensor, out_kind: str = "auto") -> torch.Tensor:
    """What K3 computes, in plain PyTorch: the conv in f64 (`_conv_f64`),
    rounded to int32 (int8 inputs) or f32 (float inputs), then `epilogue`."""
    _check_shapes(x, w, alpha, beta)
    out_kind = _resolve_out_kind(x, out_kind)
    acc = _conv_f64(x, w)
    acc = acc.to(torch.int32) if x.dtype == torch.int8 else acc.float()
    return epilogue(acc, alpha, beta, out_kind).contiguous()


# --- the int8 library route ---------------------------------------------------

def _row_blocks(bsz: int, ho: int, row_bytes: int
                ) -> Iterator[Tuple[int, int, int, int]]:
    """(b0, b1, y0, y1) blocks of output rows whose im2col stays within
    IM2COL_BYTES: whole images where one fits, else rows of one image."""
    if ho * row_bytes <= IM2COL_BYTES:
        nb = max(1, IM2COL_BYTES // (ho * row_bytes))
        for b0 in range(0, bsz, nb):
            yield b0, min(b0 + nb, bsz), 0, ho
        return
    nr = max(1, IM2COL_BYTES // row_bytes)
    for b in range(bsz):
        for y0 in range(0, ho, nr):
            yield b, b + 1, y0, min(y0 + nr, ho)


def conv_int8_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 sums of the int8 k x k valid conv (k in 2, 3) through the
    library: im2col (tap-major, the HWIO order) and ``torch._int_mm`` int8 x
    int8 -> int32. The im2col is built in blocks of output rows of at most
    IM2COL_BYTES, and reads `x_q` through its strides (a cropped view is
    fine). On the card ``_int_mm`` needs M > 16 and K, N multiples of 8: K
    and N are padded with zeros and M with rows, which adds nothing to the
    sums."""
    _check_shapes(x_q, w_q, None, None, sizes=(2, 3))
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    bsz, h, wd, cin = x_q.shape
    kh, cout = w_q.shape[0], w_q.shape[3]
    ho, wo = h - kh + 1, wd - kh + 1
    k = kh * kh * cin
    kp, np_ = -(-k // 8) * 8, -(-cout // 8) * 8
    wm = torch.zeros((np_, kp), dtype=torch.int8, device=w_q.device)
    wm[:cout, :k] = w_q.reshape(k, cout).t()
    wm = wm.t()                          # [kp, np_], column-major for cuBLASLt
    acc = torch.empty((bsz, ho, wo, cout), dtype=torch.int32, device=x_q.device)
    for b0, b1, y0, y1 in _row_blocks(bsz, ho, wo * kp):
        rows = y1 - y0
        cols = (torch.zeros if kp > k else torch.empty)(
            (b1 - b0, rows, wo, kp), dtype=torch.int8, device=x_q.device)
        for dy in range(kh):
            for dx in range(kh):
                t = (dy * kh + dx) * cin
                cols[..., t:t + cin] = x_q[b0:b1, y0 + dy:y1 + dy, dx:dx + wo]
        a = cols.view(-1, kp)
        m = a.shape[0]
        if m <= 16:
            a = torch.cat([a, a.new_zeros((17 - m, kp))])
        out = torch._int_mm(a, wm)[:m, :cout]
        acc[b0:b1, y0:y1] = out.view(b1 - b0, rows, wo, cout)
    return acc


def conv3x3_int8_xla(x_q: torch.Tensor, w_q: torch.Tensor, alpha: torch.Tensor,
                     beta: torch.Tensor, out_kind: str = "bf16") -> torch.Tensor:
    """The int8 conv through the library, `conv_int8_acc` then `epilogue`.
    Like the JAX function it takes any kernel size the model has: 3x3, and
    the 2x2 packed kernels of the phase-packed level 0."""
    _check_shapes(x_q, w_q, alpha, beta, sizes=(2, 3))
    return epilogue(conv_int8_acc(x_q, w_q), alpha, beta, _resolve_out_kind(x_q, out_kind))


# --- K3 ---------------------------------------------------------------------

# Per-shape winners among the TPU kernel's variants, (cin, cout) ->
# (variant, block_rows, cout_tile), as the JAX package measured them on a TPU
# v5e. `conv3x3_fused` accepts and validates these arguments as the JAX
# function does; they do not steer the Hopper kernel, which has one design.
BEST_CONFIGS = {
    (64, 128): ("nconcat", 8, 128),
    (128, 128): ("nconcat", 8, 128),
    (128, 256): ("nconcat", 8, 256),
    (256, 256): ("nconcat", 8, 256),
    (256, 512): ("taps", 8, 256),
    (512, 512): ("rows3", 8, 256),
    (512, 1024): ("taps", 8, 256),
    (1024, 1024): ("taps", 8, 256),
    (1024, 512): ("taps", 8, 256),
    (512, 256): ("taps", 8, 256),
    (256, 128): ("nconcat", 16, 128),
}


def best_config(cin: int, cout: int) -> Tuple[str, int, int]:
    """(variant, block_rows, cout_tile) for a 3x3 conv shape: the measured
    winner when probed, else the channel-width heuristic the winners imply."""
    got = BEST_CONFIGS.get((cin, cout))
    if got is not None:
        return got
    variant = "taps" if cin >= 512 else "nconcat"
    ct = cout if cout < 256 else 256
    return (variant, 8, ct)


def _check_tiling(cin: int, cout: int, block_rows: Optional[int],
                  cout_tile: Optional[int], variant: str) -> None:
    """The JAX function's argument checks: 'auto' fills what is None from
    `best_config`; the variant must be known and the Cout tile divide Cout."""
    if variant == "auto":
        variant, auto_br, auto_ct = best_config(cin, cout)
        block_rows = auto_br if block_rows is None else block_rows
        cout_tile = auto_ct if cout_tile is None else cout_tile
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be 'nconcat', 'taps', 'rows3' or 'im2col', "
                         f"got {variant!r}")
    block_rows = 16 if block_rows is None else block_rows
    cout_tile = min(cout, 256) if cout_tile is None else cout_tile
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if cout_tile < 1 or cout % cout_tile:
        raise ValueError(f"cout_tile {cout_tile} does not divide Cout {cout}")


_KERNEL_DTYPES = (torch.int8, torch.bfloat16)
_ROUTES = ("sm90", "simple")

#: The int8 wgmma loop's blocks csrc/conv_fused.cuh builds (BM output
#: pixels x BN output channels): 128 x 64, two per SM, where Cout <= 64;
#: 256 x 128, one per SM (half the weight traffic per output), above.
SM90_BLOCKS = ((128, 64), (256, 128))


def sm90_block(cout: int) -> Tuple[int, int]:
    """(BM, BN) of the int8 wgmma loop for a conv to `cout` channels; the
    ring, grid and shared memory follow from these in the CUDA entry."""
    return SM90_BLOCKS[0] if cout <= 64 else SM90_BLOCKS[1]


def int8_sm90_takes(x: torch.Tensor, cout: int, out_kind: str) -> bool:
    """Whether the int8 wgmma loop takes x to `cout` channels: int8 x with
    Cin a multiple of 16 (16-byte chunks of x and w), Cout a multiple of the
    outputs in one 16-byte store (16 int8, 8 bf16), x 16-byte aligned. w is
    not checked: the loop reads a fresh K-major copy."""
    vec = 16 if out_kind == "int8" else 8
    return (x.dtype == torch.int8 and x.shape[-1] % 16 == 0 and cout % vec == 0
            and x.data_ptr() % 16 == 0)


def k_major_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO [k, k, Cin, Cout] -> [Cout, k*k*Cin], contiguous: each output
    channel's row, tap-major with ascending channels (element (dy*k + dx)*Cin
    + c of row n is w[dy, dx, c, n]), as both kernel routes read it."""
    kh, _, cin, cout = w.shape
    return w.reshape(kh * kh * cin, cout).t().contiguous()


def _check_kernel_args(x, w, alpha, beta) -> None:
    for name, t in (("w", w), ("alpha", alpha), ("beta", beta)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernel takes int8 or bfloat16 x, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}: the kernel takes one "
                        f"input dtype")
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("w", w), ("alpha", alpha), ("beta", beta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[0] < 1 or w.shape[3] < 1:
        raise ValueError(f"empty batch or Cout: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.shape) > _INT32_MAX or 9 * x.shape[3] > _INT32_MAX:
        raise ValueError(f"dimension past int32 in x {tuple(x.shape)}")


def launch_fused(name: str, fn, x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                 beta: torch.Tensor, y: torch.Tensor, *args) -> None:
    """Call the C entry `fn` on checked CUDA tensors (K-major w) through
    `_build.launch`: (x, w, alpha, beta, y, B, H, W, Cin, Cout, *args,
    stream); raise on a refused launch, naming the wrapper `name`."""
    bsz, h, wd, cin = x.shape
    _build.launch(name, fn, x.get_device(), x.data_ptr(), w.data_ptr(), alpha.data_ptr(),
                  beta.data_ptr(), y.data_ptr(), bsz, h, wd, cin, y.shape[3], *args,
                  shapes=(("x", x), ("w", [y.shape[3], w.shape[1]])))


def conv3x3_fused_route(x: torch.Tensor, w: torch.Tensor, out_kind: str = "auto") -> str:
    """The kernel route `conv3x3_fused` takes for x and w on the card:
    ``"sm90"`` where `int8_sm90_takes` (int8 x, Cin a multiple of 16, Cout
    of 16 for int8 out or 8 for bf16 out, x 16-byte aligned), else
    ``"simple"``. It depends on dtype, channel counts, out kind and the
    alignment of x only, not on the device."""
    out_kind = _resolve_out_kind(x, out_kind)
    return "sm90" if int8_sm90_takes(x, w.shape[-1], out_kind) else "simple"


def _k3_forward(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                out_kind: str, route: str) -> torch.Tensor:
    """K3 on checked CUDA tensors through `route`."""
    bsz, h, wd, _ = x.shape
    cout = w.shape[3]
    out_dtype = torch.int8 if out_kind == "int8" else torch.bfloat16
    y = torch.empty((bsz, h - 2, wd - 2, cout), dtype=out_dtype, device=x.device)
    wk = k_major_weights(w)
    lib = _build.load_library()
    out8 = int(out_kind == "int8")
    if route == "sm90":
        launch_fused("conv3x3_fused", lib.conv3x3_fused_sm90, x, wk, alpha, beta, y, out8,
                     *sm90_block(cout))
        conv3x3_fused.sm90_launches += 1
    else:
        fn = lib.conv3x3_fused_s8 if x.dtype == torch.int8 else lib.conv3x3_fused_bf16
        vec = int(x.shape[3] * x.element_size() % 16 == 0
                  and all(t.data_ptr() % 16 == 0 for t in (x, wk)))
        launch_fused("conv3x3_fused", fn, x, wk, alpha, beta, y, out8, vec)
    conv3x3_fused.launches += 1
    return y


def conv3x3_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    *,
    out_kind: str = "auto",
    block_rows: Optional[int] = 16,
    cout_tile: Optional[int] = None,
    interpret: bool = False,
    variant: str = "nconcat",
) -> torch.Tensor:
    """relu(conv_valid(x, w) * alpha + beta), optionally requantized.

    x [B, H, W, Cin] (int8 or bf16), w [3, 3, Cin, Cout] (same dtype),
    alpha/beta [Cout] f32. out_kind: 'int8' stores round-clamped int8, 'bf16'
    stores bf16; 'auto' = int8 for int8 inputs. Returns [B, H-2, W-2, Cout].

    `variant`, `block_rows` and `cout_tile` are the TPU kernel's tiling
    arguments: they are checked as the JAX function checks them and do not
    change what the Hopper kernel does; `interpret` is accepted and ignored.

    On a CPU tensor: `conv3x3_fused_plain`. On a CUDA tensor: a Hopper
    kernel on the route `conv3x3_fused_route` picks, which takes contiguous
    tensors; each launch counts in ``conv3x3_fused.launches``, and the sm90
    route's also in ``conv3x3_fused.sm90_launches``. What the kernels do
    not take raises."""
    del interpret
    _check_shapes(x, w, alpha, beta)
    _check_tiling(x.shape[3], w.shape[3], block_rows, cout_tile, variant)
    out_kind = _resolve_out_kind(x, out_kind)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, alpha, beta, out_kind)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused runs on cpu or cuda, not {x.device}")
    _check_kernel_args(x, w, alpha, beta)
    return _k3_forward(x, w, alpha, beta, out_kind, conv3x3_fused_route(x, w, out_kind))


def check_route(route: str, takes: str, what: str) -> None:
    """Refuse an unknown route, or the sm90 route where its predicate
    (`takes`, the route that shape gets) says "simple"."""
    if route not in _ROUTES:
        raise ValueError(f"no route {route!r}; the routes are {_ROUTES}")
    if route == "sm90" and takes != "sm90":
        raise ValueError(f"the sm90 route does not take {what}")


def _conv3x3_fused_route_forward(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor,
                                 beta: torch.Tensor, route: str,
                                 out_kind: str = "auto") -> torch.Tensor:
    """K3 on CUDA tensors through the named route, whatever
    `conv3x3_fused_route` would pick: the one-stage kernel at a shape the
    sm90 loop takes. For comparing and timing the two on the card; no path
    of the model calls it. Refuses the sm90 route at a shape it does not
    take, on any device."""
    _check_shapes(x, w, alpha, beta)
    out_kind = _resolve_out_kind(x, out_kind)
    check_route(route, conv3x3_fused_route(x, w, out_kind),
                f"{x.dtype} x {tuple(x.shape)} -> {w.shape[3]} ({out_kind} out)")
    if x.device.type != "cuda":
        raise ValueError(f"the routes run on cuda, not {x.device}")
    _check_kernel_args(x, w, alpha, beta)
    return _k3_forward(x, w, alpha, beta, out_kind, route)


#: Kernel launches since the count was last set to 0 (CPU calls don't
#: count): all routes, and the sm90 route's alone.
conv3x3_fused.launches = 0
conv3x3_fused.sm90_launches = 0
