"""The EDT column pass: the Hopper kernel and its plain PyTorch version.

Counterpart of ``tpu_unet/ops/edt_pallas.py::column_pass_pallas``:
D2[..., i, j] = min_r g2[..., r, j] + (i - r)^2 over f32 planes [..., N, H, W]
of squared row distances. The kernel is CUDA C++ in
``tpu_unet_torch/csrc/edt_column_pass.cu``, built on first use
(``ops/_build.py``). Its plain version is the JAX package's pair of scan
twins (``tpu_unet/ops/edt.py::_column_pass_from_g2`` and
``_column_pass_banded_from_g2``), `_column_pass_from_g2` and
`_column_pass_banded_from_g2` here.

`column_pass` dispatches on the device of `g2`: a CPU tensor goes to
`column_pass_plain`, a CUDA tensor launches the kernel or raises. The
kernel has two routes: "sm90", an offset-major sweep that takes the minimum
over the f32 sums' bit patterns (what `column_pass` runs; g2 holds
squares), and "simple", the first kernel, reached only through
`_column_pass_route_forward` for comparisons.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from tpu_unet_torch.ops import _build

NumValid = Union[None, int, torch.Tensor]


def _column_pass_from_g2(g2: torch.Tensor) -> torch.Tensor:
    """Exact (min, +) over source rows: [..., H, W] f32 -> [..., H, W] f32,
    D2[i, j] = min_r g2[r, j] + (i - r)^2 (one step per source row, as the
    JAX package's `lax.scan`)."""
    h = g2.shape[-2]
    rows = torch.arange(h, dtype=torch.float32, device=g2.device)
    acc = torch.full_like(g2, float("inf"))
    for r in range(h):
        di = rows - r
        acc = torch.minimum(acc, (di * di)[:, None] + g2[..., r:r + 1, :])
    return acc


def _column_pass_banded_from_g2(g2: torch.Tensor, band: int) -> torch.Tensor:
    """Banded (min, +): D2[i, j] = min_{|d| <= band} g2[i + d, j] + d^2,
    scanning the offsets of a source padded with +inf rows."""
    h = g2.shape[-2]
    g2p = F.pad(g2, (0, 0, band, band), value=float("inf"))
    acc = torch.full_like(g2, float("inf"))
    for d in range(2 * band + 1):
        off = float(d - band)
        acc = torch.minimum(acc, g2p[..., d:d + h, :] + off * off)
    return acc


def _live_mask(g2: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
    """[..., N, 1, 1] bool: plane k of batch entry b is live iff
    k < num_valid[b]."""
    k = torch.arange(g2.shape[-3], device=g2.device)
    return (k < num_valid.to(g2.device)[..., None])[..., None, None]


def _check(g2: torch.Tensor, num_valid: NumValid, band: Optional[int]
           ) -> NumValid:
    if g2.dim() < 3:
        raise ValueError(f"g2 must be [..., N, H, W], got shape {tuple(g2.shape)}")
    if g2.dtype != torch.float32:
        raise TypeError(f"g2 must be float32, got {g2.dtype}")
    if band is not None and (not isinstance(band, int) or band < 0):
        raise ValueError(f"band must be None or an int >= 0, got {band!r}")
    if isinstance(num_valid, bool):
        raise TypeError("num_valid must be None, an int or an int tensor")
    if isinstance(num_valid, int):
        num_valid = torch.tensor(num_valid, dtype=torch.int32)
    if isinstance(num_valid, torch.Tensor):
        if num_valid.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"num_valid must be an integer tensor, got {num_valid.dtype}")
        if tuple(num_valid.shape) != tuple(g2.shape[:-3]):
            raise ValueError(f"num_valid shape {tuple(num_valid.shape)} must be g2's "
                             f"leading shape {tuple(g2.shape[:-3])}")
    elif num_valid is not None:
        raise TypeError("num_valid must be None, an int or an int tensor")
    return num_valid


def column_pass_plain(g2: torch.Tensor, num_valid: NumValid = None,
                      band: Optional[int] = None) -> torch.Tensor:
    """The plain version of `column_pass`: the exact scan (band None) or the
    banded scan, with the planes past `num_valid` set to +inf."""
    num_valid = _check(g2, num_valid, band)
    d2 = (_column_pass_from_g2(g2) if band is None
          else _column_pass_banded_from_g2(g2, band))
    if num_valid is not None:
        d2 = torch.where(_live_mask(g2, num_valid), d2, float("inf"))
    return d2


def _launch(g2: torch.Tensor, num_valid: NumValid, band: Optional[int], route: str
            ) -> torch.Tensor:
    """K2 on a CUDA g2 through `route`: "sm90" (the offset-major sweep) or
    "simple" (the first kernel)."""
    if g2.device.type != "cuda":
        raise ValueError(f"column_pass runs on cpu or cuda, not {g2.device}")
    num_valid = _check(g2, num_valid, band)
    if not g2.is_contiguous():
        raise ValueError("g2 must be contiguous")
    *_, n, h, w = g2.shape
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"empty planes: g2 {tuple(g2.shape)}")
    ptr = None
    if num_valid is not None:
        if num_valid.device.type == "cpu" and num_valid.dim() == 0:
            num_valid = num_valid.to(g2.device)    # a host int: no sync
        if num_valid.device != g2.device:
            raise ValueError(f"num_valid is on {num_valid.device}, g2 on {g2.device}")
        num_valid = num_valid.to(torch.int32).contiguous()
        ptr = num_valid.data_ptr()
    planes = g2.numel() // (h * w)
    out = torch.empty_like(g2)
    lib = _build.load_library()
    b = -1 if band is None else band
    if route == "sm90":
        _build.launch("edt_column_pass (sm90 route)", lib.edt_column_pass_sm90, g2.get_device(),
                      g2.data_ptr(), ptr, out.data_ptr(), planes, n, h, w, b,
                      shapes=(("g2", g2),))
        column_pass.sm90_launches += 1
    else:
        _build.launch("edt_column_pass (simple route)", lib.edt_column_pass_f32, g2.get_device(),
                      g2.data_ptr(), ptr, out.data_ptr(), planes, n, h, w, b,
                      shapes=(("g2", g2),))
    column_pass.launches += 1
    return out


def column_pass(g2: torch.Tensor, num_valid: NumValid = None,
                band: Optional[int] = None) -> torch.Tensor:
    """g2 [..., N, H, W] f32 squared per-row distances -> [..., N, H, W] f32
    D2, the column pass of the exact EDT.

    g2 holds squares: every value +0, positive or +inf, never negative or
    NaN (`edt_batch`'s squared row distances). `num_valid` (None: every
    plane; an int; or an integer tensor of g2's leading shape ``[...]``):
    plane k of entry b is live iff k < num_valid[b]; the others are +inf.
    `band` (None: exact) limits the pass to vertical offsets |i - r| <=
    band; any D2 above band^2 may come back larger, up to +inf.

    On a CPU tensor: `column_pass_plain`. On a CUDA tensor: the Hopper
    kernel's route "sm90", which takes a contiguous f32 `g2` and reads
    `num_valid` on the device (no host sync); it takes the minimum over the
    f32 sums' bit patterns, which order as the sums do because the sums are
    non-negative, so it equals `column_pass_plain` bit for bit. A g2 that
    breaks the contract gives a wrong result, not an error: nothing reads g2
    on the host. Each launch counts in ``column_pass.launches`` and
    ``column_pass.sm90_launches``."""
    if g2.device.type == "cpu":
        return column_pass_plain(g2, num_valid, band)
    return _launch(g2, num_valid, band, "sm90")


def _column_pass_route_forward(g2: torch.Tensor, num_valid: NumValid, band: Optional[int],
                               route: str) -> torch.Tensor:
    """K2 through the named route, "sm90" (what `column_pass` runs) or
    "simple" (the first kernel, one candidate row at a time), for comparing and timing
    the two on the card; no path of the model calls it. On a CPU tensor
    every route runs `column_pass_plain`."""
    if route not in ("sm90", "simple"):
        raise ValueError(f"no route {route!r}")
    if g2.device.type == "cpu":
        return column_pass_plain(g2, num_valid, band)
    return _launch(g2, num_valid, band, route)


#: Kernel launches since the count was last set to 0 (CPU calls don't
#: count): all routes, and the sm90 route's alone.
column_pass.launches = 0
column_pass.sm90_launches = 0
