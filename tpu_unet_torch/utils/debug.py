"""Debug switches (counterpart of ``tpu_unet/utils/debug.py``): NaN checks
through autograd's anomaly mode."""

from __future__ import annotations

import contextlib

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off: a backward op that returns
    NaN then raises, naming the forward op that made it."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def debug_flags(nan_checks: bool = False):
    """Turn the NaN checks on around a suspect region; the anomaly flag is
    restored afterwards. (The JAX package's `disable_jit` has no
    counterpart: eager PyTorch traces nothing to disable.)"""
    prev = torch.is_anomaly_enabled()
    try:
        if nan_checks:
            torch.autograd.set_detect_anomaly(True)
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
