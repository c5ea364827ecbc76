"""Device mesh and data parallelism (counterpart of ``tpu_unet/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over the slice, shards the
batch on its ``data`` axis and lets XLA place the gradient all-reduce. Here
every process is one rank of the ``torch.distributed`` world
(``parallel/distributed.py::initialize_multihost``), the mesh is a
``DeviceMesh`` over that world with one sub-group per named axis, and the
collectives are written out: the gradient all-reduce, the gathers of
per-sample results.

Axes, as in the JAX package: ``data`` (batch parallelism for training, tile
batches for inference) and ``spatial`` (strips of one image's rows with a
halo exchange, parallel/halo.py). Rank r sits at mesh coordinates
``unravel(r, shape)``, as device r of the JAX mesh does, so a rank's block
of ``P(axis)`` is the block of its coordinate on `axis` and gathered
results come back in global order.

Deliberate differences: the mesh spans the whole world (a `num_devices`
other than the world size raises), and what JAX returns as a sharded array
is gathered to every rank.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_unet_torch.losses.bce import binary_cross_entropy, weighted_bce_with_logits
from tpu_unet_torch.losses.metrics import batch_evaluation_metrics
from tpu_unet_torch.models.unet import center_crop_or_pad


def make_mesh(num_devices: Optional[int] = None, axes: Tuple[str, ...] = ("data",),
              shape: Optional[Sequence[int]] = None, device: str = "cuda") -> DeviceMesh:
    """A mesh over the initialized world, `axes` named, of `shape` (default
    (world, 1, ...)). `device` is where the ranks' tensors live: 'cuda'
    (default; raises without a card) or 'cpu'."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to build a mesh of CPU ranks")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost() in every rank first")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"the mesh spans the whole world of {world} ranks; "
                         f"num_devices={num_devices} would leave ranks out")
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} does not "
                         f"cover the world of {world} ranks")
    mesh = init_device_mesh(device, shape, mesh_dim_names=tuple(axes))
    for axis in axes:
        # gathers list the group's ranks in group order: it must be the
        # coordinate order, or gathered results come back permuted
        if dist.get_rank(mesh.get_group(axis)) != mesh.get_local_rank(axis):
            raise RuntimeError(f"axis {axis!r}: group rank is not the mesh coordinate")
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def all_gather_list(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """Every rank's `t` along `axis`, in coordinate order (same shape on
    every rank)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(out, t, group=mesh.get_group(axis))
    return out


def all_gather_cat(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The blocks of `axis` joined along dim 0: the global array."""
    return torch.cat(all_gather_list(t, mesh, axis))


def all_reduce_grads(params, group=None, divide_by: int = 1) -> None:
    """Sum the gradients of `params` over `group` (default: the whole mesh,
    which is the world) in one collective, then divide by `divide_by`."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divide_by != 1:
        flat.div_(divide_by)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def replicate(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Give every rank the mesh's first rank's parameters and buffers."""
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src=src)
    return module


def shard_batch(x, mesh: DeviceMesh, axis: str = "data"):
    """This rank's contiguous block of the leading axis of `x`, as
    ``P(axis)`` shards it."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over the "
                         f"{n} ranks of axis {axis!r}")
    b = x.shape[0] // n
    i = mesh.get_local_rank(axis)
    return x[i * b:(i + 1) * b]


def _parity_loss(logits, gt, weights, mesh, axis):
    """The 'parity' broadcast over a sharded batch: sample b, channel c takes
    global sample c's weight map, so the maps are gathered first."""
    full = all_gather_cat(weights, mesh, axis)                      # [B, h, w]
    if full.shape[0] != logits.shape[-1]:
        raise ValueError("parity broadcast requires the global batch == num_classes "
                         f"(got batch={full.shape[0]}, classes={logits.shape[-1]})")
    return (torch.movedim(full, 0, -1)[None] * binary_cross_entropy(logits, gt)).mean()


def make_dp_train_step(model, weight_fn, broadcast: str, opt: torch.optim.Optimizer,
                       mesh: DeviceMesh, axis: str = "data"):
    """Data-parallel train step, the math of ``train/trainer.py::make_train_step``.

    step(inp [b, S, S, 1], gt [b, c, c]) with this rank's block of the
    global batch -> (loss, metrics [B_global, 2]): the loss is the
    global-batch mean, equal on every rank, the per-sample metrics are
    gathered in global order. The gradients are averaged over `axis` (the
    local means are over equal blocks), so `model` and `opt` stay equal
    across ranks."""
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)

    def step(inp: torch.Tensor, gt: torch.Tensor):
        with torch.no_grad():
            weights = weight_fn(gt)
        opt.zero_grad(set_to_none=True)
        logits = center_crop_or_pad(model(inp), gt.shape[1:3])
        if broadcast == "parity":
            loss = _parity_loss(logits, gt, weights, mesh, axis)
        else:
            loss = weighted_bce_with_logits(logits, gt, weights, broadcast)
        loss.backward()
        all_reduce_grads(model.parameters(), group, divide_by=n)
        opt.step()
        with torch.no_grad():
            total = loss.detach().clone()
            dist.all_reduce(total, group=group)
            metrics = batch_evaluation_metrics(logits.argmax(-1), gt)
            return total / n, all_gather_cat(metrics, mesh, axis)

    return step


def make_dp_tile_forward(model, mesh: DeviceMesh, axis: str = "data"):
    """fwd(tiles [b, S, S, 1], this rank's block) -> the argmax class ids of
    the global tile batch, [B_global, s, s], on every rank."""

    @torch.inference_mode()
    def fwd(tiles: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(torch.argmax(model(tiles), dim=-1), mesh, axis)

    return fwd
