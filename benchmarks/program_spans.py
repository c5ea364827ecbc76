"""What the readers of the program's own spans share. The program opens
`torch.profiler.record_function` ranges of its own (`tiles.*`, `quant.*`,
`train.*`; `tpu_unet_torch/utils/profiling.py::span`), which land in the
host profile beside the benchmark's spans: `Trace` gives each device
operation to the innermost span that launched it. A program without those
spans reads None."""

from typing import Optional, Sequence


def device_ms(t, spans: Sequence[str], per: str) -> Optional[float]:
    """Device milliseconds of the operations launched inside `spans`, per
    unit of the counter `per` (requests, steps)."""
    n, device_s = t.counters.get(per), sum(t.span_device_s(s) for s in spans)
    if not n or device_s <= 0:
        return None
    return 1e3 * device_s / n
