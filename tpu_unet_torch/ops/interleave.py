"""Batch<->channel pairing copies of the research int8 forward's
``pair_level0`` (infer/quant_research.py): K6a-c, the Hopper kernels in
``tpu_unet_torch/csrc/interleave.cu``, and their plain PyTorch versions.

Counterpart of ``tpu_unet/ops/interleave.py``. Layouts are NHWC:

* `pair_batch_channels`: [B, H, W, C] -> [B/2, H, W, 2C], image i beside
  image i + B/2 (``out[i] = x[i] || x[i + B/2]``);
* `unpair_batch_channels`: its inverse;
* `interleave_pairs`: a = [a0|a1], b = [b0|b1], each [B/2, H, W, 2C] ->
  [B/2, H, W, 4C] with channels [a0, b0, a1, b1], the paired form of each
  image's concat([a_img, b_img], -1).

Each wrapper runs its plain version (slices and ``torch.cat``) on a CPU
tensor; on a CUDA tensor it launches its kernel or raises, and counts the
launch in ``<wrapper>.launches``. The kernels copy bytes and take any
dtype. An input needs only its (W, C) dims packed (``stride(2) == C``,
``stride(3) == 1``): the batch and row strides go to the kernel, so a
center-cropped view is read in place; any other input is made contiguous
first.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.ops import _build

# The kernel's source selection, as csrc/interleave.cu numbers it.
_PAIR, _UNPAIR, _INTERLEAVE = 0, 1, 2


def _check_4d(name: str, t: torch.Tensor) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC [B, H, W, C], got shape {tuple(t.shape)}")


def pair_batch_channels_plain(x: torch.Tensor) -> torch.Tensor:
    hb = x.shape[0] // 2
    return torch.cat([x[:hb], x[hb:]], dim=-1)


def unpair_batch_channels_plain(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1] // 2
    return torch.cat([x[..., :c], x[..., c:]], dim=0)


def interleave_pairs_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = a.shape[-1] // 2
    return torch.cat([a[..., :c], b[..., :c], a[..., c:], b[..., c:]], dim=-1)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a contiguous copy unless its (W, C) dims are packed."""
    if t.stride(3) == 1 and t.stride(2) == t.shape[3]:
        return t
    return t.contiguous()


def _launch(fn_name: str, mode: int, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, c: int) -> None:
    """Run the copy kernel: `c` channels per source segment; batch and row
    strides of `a` and `b` in bytes. 16-byte copies where every segment,
    stride and pointer allows them."""
    es = a.element_size()
    seg = c * es
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    strides = (a.stride(0) * es, a.stride(1) * es, b.stride(0) * es, b.stride(1) * es)
    vec = int(seg % 16 == 0 and all(p % 16 == 0 for p in ptrs)
              and all(s % 16 == 0 for s in strides))
    nb, h, w = out.shape[:3]
    _build.launch(fn_name, _build.load_library().interleave_copy, out.get_device(),
                  mode, *ptrs, *strides, nb, h, w, seg, vec, shapes=(("out", out),))


def _on_cuda(fn_name: str, *ts: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA ones;
    raises for a mix or another device. Reads each tensor's flags and
    device index, without building `torch.device` objects."""
    cuda, index = ts[0].is_cuda, ts[0].get_device()
    if any(t.is_cuda != cuda or t.get_device() != index for t in ts[1:]):
        raise ValueError(f"{fn_name}: inputs on {[str(t.device) for t in ts]}")
    if not cuda and not all(t.is_cpu for t in ts):
        raise ValueError(f"{fn_name} runs on cpu or cuda, not on {[str(t.device) for t in ts]}")
    return cuda


def pair_batch_channels(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B/2, H, W, 2C]: out[i, ..., :C] = x[i],
    out[i, ..., C:] = x[i + B/2]. B must be even."""
    _check_4d("x", x)
    bsz, h, w, c = x.shape
    if bsz % 2:
        raise ValueError(f"pair_batch_channels needs an even batch, got {bsz}")
    if not _on_cuda("pair_batch_channels", x):
        return pair_batch_channels_plain(x)
    x = _packed(x)
    out = torch.empty((bsz // 2, h, w, 2 * c), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("pair_batch_channels", _PAIR, x, x, out, c)
        pair_batch_channels.launches += 1
    return out


def unpair_batch_channels(x: torch.Tensor) -> torch.Tensor:
    """[B/2, H, W, 2C] -> [B, H, W, C], the inverse of `pair_batch_channels`.
    The channel count must be even."""
    _check_4d("x", x)
    hb, h, w, c2 = x.shape
    if c2 % 2:
        raise ValueError(f"unpair_batch_channels needs an even channel count, got {c2}")
    if not _on_cuda("unpair_batch_channels", x):
        return unpair_batch_channels_plain(x)
    x = _packed(x)
    out = torch.empty((2 * hb, h, w, c2 // 2), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch("unpair_batch_channels", _UNPAIR, x, x, out, c2 // 2)
        unpair_batch_channels.launches += 1
    return out


def interleave_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a = [a0|a1], b = [b0|b1] (each [B/2, H, W, 2C]) -> [B/2, H, W, 4C]
    with channels [a0, b0, a1, b1]. Equal shapes and dtypes, even 2C."""
    _check_4d("a", a)
    if a.shape != b.shape or a.shape[3] % 2:
        raise ValueError(f"interleave_pairs needs equal shapes with an even channel "
                         f"count, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"interleave_pairs: a is {a.dtype}, b is {b.dtype}")
    if not _on_cuda("interleave_pairs", a, b):
        return interleave_pairs_plain(a, b)
    a, b = _packed(a), _packed(b)
    hb, h, w, c2 = a.shape
    out = torch.empty((hb, h, w, 2 * c2), dtype=a.dtype, device=a.device)
    if out.numel():
        _launch("interleave_pairs", _INTERLEAVE, a, b, out, c2 // 2)
        interleave_pairs.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls don't count).
pair_batch_channels.launches = 0
unpair_batch_channels.launches = 0
interleave_pairs.launches = 0
