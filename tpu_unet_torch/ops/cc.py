"""Connected components, 4-connectivity (counterpart of ``tpu_unet/ops/cc.py``).

Min-label propagation: each foreground pixel starts with its linear index,
and labels take minima over foreground neighbours until nothing changes.
Labels are therefore the component minima, the same values the JAX package
gives, not only the same partition. The JAX `lax.while_loop` (one
4-neighbour step per iteration) is a Python loop whose sweep takes the
minimum over each pixel's whole run of foreground along its row, then along
its column: at the fixed point every pixel is at most each 4-neighbour, as
in JAX, but a sweep crosses a whole run, so a blob takes a few sweeps where
4-neighbour steps take one per pixel of its longest geodesic. The loop
tests for the fixed point only every `_CHECK_EVERY` sweeps: sweeps past it
change nothing, and each test is a host sync on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

_SENTINEL = 2 ** 30
_CHECK_EVERY = 2


def _run_ids(fg: torch.Tensor, dim: int) -> Tuple[torch.Tensor, int]:
    """(ids [N] int64 over fg's flattened pixels, their bound): one id per
    maximal run of foreground along `dim` (-1 rows, -2 columns), distinct
    across lines and masks. A background pixel shares the id of the run
    after it; its label is the sentinel, so it never lowers that run's
    minimum."""
    n = fg.shape[dim]
    lines = fg.numel() // n
    line = torch.arange(lines, device=fg.device)
    line = line.reshape(*fg.shape[:-2], *((-1, 1) if dim == -1 else (1, -1)))
    ids = line * (n + 1) + torch.cumsum(~fg, dim=dim)
    return ids.reshape(-1), lines * (n + 1)


def _run_min(lab: torch.Tensor, runs: Tuple[torch.Tensor, int]) -> torch.Tensor:
    """Each pixel's label replaced by the minimum over its run."""
    ids, bound = runs
    mins = torch.full((bound,), _SENTINEL, dtype=lab.dtype, device=lab.device)
    mins.scatter_reduce_(0, ids, lab.reshape(-1), reduce="amin")
    return mins[ids].reshape(lab.shape)


def _sweep(lab: torch.Tensor, fg: torch.Tensor, rows, cols) -> torch.Tensor:
    """One sweep: the minimum over each pixel's row run, then over its
    column run; background reset to the sentinel."""
    lab = torch.where(fg, _run_min(lab, rows), _SENTINEL)
    return torch.where(fg, _run_min(lab, cols), _SENTINEL)


def connected_components(fg: torch.Tensor) -> torch.Tensor:
    """Label the 4-connected components of a boolean mask.

    fg: [..., H, W] bool (leading dims are independent masks). Returns
    [..., H, W] int32: background holds the sentinel 2^30, and each
    component's pixels hold the component's minimum linear index."""
    h, w = fg.shape[-2:]
    idx = torch.arange(h * w, dtype=torch.int32, device=fg.device).reshape(h, w)
    lab = torch.where(fg, idx, _SENTINEL)
    rows, cols = _run_ids(fg, -1), _run_ids(fg, -2)
    while True:
        prev = lab
        for _ in range(_CHECK_EVERY):
            lab = _sweep(lab, fg, rows, cols)
        if torch.equal(lab, prev):
            return lab


def component_planes(fg: torch.Tensor, max_objects: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split masks into per-component binary planes with a static bound.

    fg: [..., H, W] bool. Returns (planes [..., max_objects, H, W] bool,
    num [...] int32 on fg's device). Components are ordered by label (their
    minimum linear index); those past `max_objects` are dropped; unused
    planes are all False. The JAX package finds the K smallest labels with
    K masked minima; here each component's root (the pixel whose label is
    its own index) gets its rank in index order from one cumulative sum,
    and every pixel takes its root's rank: the same planes, in a few
    launches and with no host sync."""
    lab = connected_components(fg)
    h, w = fg.shape[-2:]
    flat = lab.flatten(-2)
    idx = torch.arange(h * w, dtype=torch.int32, device=fg.device)
    roots = fg.flatten(-2) & (flat == idx)
    rank_at = torch.cumsum(roots, dim=-1) - 1                 # rank of a root
    rank = torch.gather(rank_at, -1, torch.where(fg.flatten(-2), flat, 0).long())
    rank = torch.where(fg.flatten(-2), rank, max_objects).reshape(fg.shape)
    k = torch.arange(max_objects, device=fg.device)[:, None, None]
    planes = rank[..., None, :, :] == k
    num = torch.clamp(roots.sum(-1), max=max_objects).to(torch.int32)
    return planes, num
