"""Process-group start-up (counterpart of ``tpu_unet/parallel/distributed.py``).

The JAX package boots ``jax.distributed`` from a coordinator address and
a process count and id (or the ``JAX_*`` variables). Here each process is
one rank of a ``torch.distributed`` group: the arguments, or torchrun's
environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), name the rendezvous, the world size and the rank.

The backend is the caller's: ``'nccl'`` by default on the card (one rank
per card), ``'gloo'`` named explicitly for CPU ranks and for ranks that
share one card (NCCL refuses two ranks on one device). Nothing here
switches backend or device on an error.

Importing this module starts nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: str = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join this process to the group. Returns True once the group is up
    (also when it already was), False for a single process (no address
    given or found in the environment).

    `coordinator_address` is ``"host:port"`` (a TCP rendezvous) or an init
    URL such as ``"file:///path"``. `device` 'cuda' pins the rank to
    ``cuda:{LOCAL_RANK % device_count()}`` and defaults `backend` to
    'nccl'; 'cpu' defaults it to 'gloo'."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None:
        return False                                   # single process
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and process_id "
                         "(or WORLD_SIZE and RANK)")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" (and backend "
                               "\"gloo\") to run the ranks on the CPU")
        local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = process_id
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend or ("nccl" if device == "cuda" else "gloo"),
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return True
