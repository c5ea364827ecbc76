"""Probes that time one kernel family on the card at fixed shapes; each runs
as ``python -m tpu_unet_torch.probes.<name>``."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from tpu_unet_torch.utils.profiling import timeit_readback


def log(*args) -> None:
    print(f"[{time.strftime('%H:%M:%S')}]", *args, flush=True)


def time_ms(fn: Callable, device: str, reps: int) -> Optional[float]:
    """ms per call of `fn` with CUDA events around `reps` back-to-back calls
    after a warm-up (`utils.profiling.timeit_readback`); None on the CPU,
    where nothing is timed."""
    if device != "cuda":
        return None
    return timeit_readback(lambda _: fn(), torch.empty(0, device=device), n=1, reps=reps) * 1e3
