"""Row gather: the Hopper kernel in ``tpu_unet_torch/csrc/row_gather.cu``,
its plain PyTorch version, and the three wrapper names of the TPU probe it
replaces.

The TPU kernels are ``k_take``, ``k_vecidx`` and ``k_rowloop`` inside
``scripts/tpu_gather_probe.py::main``. All three compute

    out[n, :] = src[idx[n], :]

with ``jnp.take(src, idx, axis=0)``'s default semantics: an index in
[-N, 0) counts from the end, and an index outside [-N, N) reads NaN. src is
f32 ``[N, C]`` (C >= 1), idx int32 or int64 ``[M]``; out is f32 ``[M, C]``.

`row_gather` runs `row_gather_plain` on a CPU tensor; on a CUDA tensor it
launches the kernel or raises, and counts the launch in
``row_gather.launches``. The wrapper names check their arguments as the
script uses them and call `row_gather`.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_unet_torch.ops import _build
from tpu_unet_torch.ops.interleave import _on_cuda

_INDEX_TYPES = (torch.int32, torch.int64)


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 2 or src.shape[1] < 1 or src.dtype != torch.float32:
        raise ValueError(f"src must be f32 [N, C] with C >= 1, got {src.dtype} "
                         f"{tuple(src.shape)}")
    if idx.dim() != 1 or idx.dtype not in _INDEX_TYPES:
        raise ValueError(f"idx must be int32 or int64 [M], got {idx.dtype} {tuple(idx.shape)}")


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch."""
    _check(src, idx)
    n = src.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    if n == 0:
        return src.new_full((idx.shape[0], src.shape[1]), float("nan"))
    rows = src.index_select(0, torch.where(ok, idx, 0))
    return torch.where(ok[:, None], rows, float("nan"))


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[n, :] = src[idx[n], :] (see the module docstring).

    On a CPU tensor: `row_gather_plain`. On a CUDA tensor: the Hopper
    kernel, counted in ``row_gather.launches``. src may be any view with a
    unit column stride (it is read through its row stride); otherwise it
    is made contiguous first."""
    _check(src, idx)
    if not _on_cuda("row_gather", src, idx):
        return row_gather_plain(src, idx)
    n, c = src.shape
    if src.stride(1) != 1 or src.stride(0) < c:
        src = src.contiguous()
    idx = idx.contiguous()
    m = idx.shape[0]
    out = src.new_empty((m, c))                     # f32 on src's device
    if n == 0:
        return out.fill_(float("nan"))
    if m == 0:
        return out
    stride, src_ptr, out_ptr = src.stride(0), src.data_ptr(), out.data_ptr()
    vec = int(c % 4 == 0 and stride % 4 == 0 and src_ptr % 16 == 0 and out_ptr % 16 == 0)
    _build.launch("row_gather", _build.load_library().row_gather_f32, src.get_device(),
                  src_ptr, idx.data_ptr(), int(idx.dtype == torch.int64), out_ptr, n, m, c,
                  stride, vec, shapes=(("src", src), ("idx", idx)))
    row_gather.launches += 1
    return out


#: Kernel launches since the count was last set to 0 (CPU calls don't count).
row_gather.launches = 0


def _index_row(idx: torch.Tensor) -> torch.Tensor:
    """The script's index block `[1, M]` (one index row, `i_ref[0]`)."""
    if idx.dim() != 2 or idx.shape[0] != 1:
        raise ValueError(f"idx must be the script's one index row [1, M], got "
                         f"{tuple(idx.shape)}")
    return idx[0]


def take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``k_take`` (``tpu_gather_probe.py:111``): ``jnp.take(src, idx[0],
    axis=0)`` with src ``[N, C]`` and idx ``[1, M]`` -> ``[M, C]``."""
    return row_gather(src, _index_row(idx))


def vecidx_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``k_vecidx`` (``tpu_gather_probe.py:126``): ``src[idx[0], :]`` with
    src ``[N, C]`` and idx ``[1, M]`` -> ``[M, C]``."""
    return row_gather(src, _index_row(idx))


def rowloop_rows(idx: torch.Tensor, src: torch.Tensor, nrows: int) -> torch.Tensor:
    """``k_rowloop`` (``tpu_gather_probe.py:143``): row n of the
    ``[nrows, C]`` output is ``src[idx[n]]`` for n < `nrows`. The script's
    loop reads `nrows` scalar-prefetched indices, so idx must hold at least
    `nrows` (its ``run_rowloop(1024)`` passes 128 and reads past them: here
    that raises ValueError)."""
    if isinstance(nrows, bool) or not isinstance(nrows, int) or nrows < 1:
        raise ValueError(f"nrows must be an int >= 1, got {nrows!r}")
    if idx.dim() != 1 or idx.shape[0] < nrows:
        raise ValueError(f"idx must be [>= nrows] = [>= {nrows}], got {tuple(idx.shape)}")
    return row_gather(src, idx[:nrows])
