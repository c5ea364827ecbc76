"""Probes that time one kernel family on the card at fixed shapes; each runs
as ``python -m tpu_unet_torch.probes.<name>``."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def log(*args) -> None:
    print(f"[{time.strftime('%H:%M:%S')}]", *args, flush=True)


def time_ms(fn: Callable, device: str, reps: int) -> Optional[float]:
    """ms per call of `fn` with CUDA events after a warm-up; None on the
    CPU, where nothing is timed."""
    if device != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
