"""Tracing and timing helpers (counterpart of ``tpu_unet/utils/profiling.py``).

* `trace_capture`: `torch.profiler` around the enclosed steps, yielded for
  its event sums and, given a directory, written as a Chrome trace, the
  program's own spans included.
* `span`: a named range of the program (`tiles.*`, `quant.*`, `train.*`)
  in the profiler's timeline, opened only while a profiler session that
  records host activity runs.
* `StepTimer`: per-step wall-clock statistics that wait for the tensors'
  CUDA device.
* `measure_roundtrip`: the host <-> device latency of a scalar readback.
* `timeit_readback`: seconds per call, from CUDA events around back-to-back
  calls.

Each waits for or times the device its tensors lie on: on a CUDA device
through CUDA, on the CPU with the host clock. The default device is
'cuda', which raises without a card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()

#: Whether the running profiler session records host activity, noted as each
#: session starts (`_noting_host_activity`): torch has no call that says so.
_records_host = True


def _noting_host_activity(start_trace):
    """`torch.autograd.profiler.profile._start_trace`, through which every
    profiler session starts, wrapped to note whether the session records
    host activity (`use_cpu`). A profile of the card alone records no
    range, so a span there would only spend the host's time."""

    @functools.wraps(start_trace)
    def wrapped(self, *args, **kwargs):
        global _records_host
        _records_host = bool(getattr(self, "use_cpu", True))
        return start_trace(self, *args, **kwargs)

    return wrapped


if hasattr(_autograd_profiler.profile, "_start_trace"):
    _autograd_profiler.profile._start_trace = _noting_host_activity(
        _autograd_profiler.profile._start_trace)


class _Range:
    """The profiler's user-annotation range that `record_function(name)`
    opens, entered through `torch.autograd`'s binding instead of the op
    dispatcher: 3.8 us an entry and exit on an H100's host against 9.1 us
    through the dispatcher (torch 2.11, in a tight loop; more between a
    model's launches). `torch._C._profiler._RecordFunctionFast` (0.7 us)
    records a function event, not a user annotation, which the trace does
    not tie to the device operations launched inside it."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


def span(name: str):
    """A named range in the profiler's timeline while a profiler session
    that records host activity runs, else one shared no-op context: outside
    such a session, a profile of the card alone included, a span costs two
    flag checks."""
    if _autograd_profiler._is_profiler_enabled and _records_host:
        return _Range(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace_capture(log_dir: Optional[str] = None):
    """Profile the enclosed steps (host, and the card's kernels when there
    is one) and yield the profiler, whose `key_averages()` sum its events;
    with a `log_dir`, write ``{log_dir}/trace.json`` for chrome://tracing
    or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing that waits for the step's tensors."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *tensors: torch.Tensor):
        """Record the time since `start`, after the CUDA devices that hold
        `tensors` have finished their work."""
        for dev in {t.device for t in tensors if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")

    def best(self) -> float:
        return float(np.min(self.times)) if self.times else float("nan")


def measure_roundtrip(n: int = 6, device="cuda") -> float:
    """Median seconds of one host <-> device scalar readback: an add on a
    one-element tensor on `device` and its `.item()`."""
    x = torch.zeros(1, device=device)
    x.add_(1).item()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        x.add_(1).item()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def timeit_readback(fn, *args, n: int = 3, reps: int = 6) -> float:
    """Median seconds per `fn(*args)` call over `n` measurements, each of
    `reps` back-to-back calls after one warm-up call has finished. The device is that of
    the first tensor argument: CUDA events time a card, the host clock the
    CPU. The events are recorded on the current device's current stream,
    which must hold the tensors and receive every call's work; nothing is
    subtracted."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        raise ValueError("timeit_readback needs a tensor argument to know the device")
    device = tensors[0].device
    if device.type == "cuda" and device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"timeit_readback times the current device, "
                         f"cuda:{torch.cuda.current_device()}; the tensors are on {device}")
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times = []
    for _ in range(n):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            times.append((time.perf_counter() - t0) / reps)
    return float(np.median(times))
