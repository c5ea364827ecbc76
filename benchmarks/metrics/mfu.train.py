"""mfu.train: the training step's model operations over the traced window,
as a share of the card's bf16 peak: crops x 3 x the forward's operations
per crop input (forward, and a backward of twice its work; recomputation
is not counted) / (window x peak)."""

from benchmarks import costs
from benchmarks.reference.unet import widths


def read(t):
    if "crops" not in t.counters or t.busy_s <= 0:
        return None
    m = t.context["model"]
    flops = 3 * costs.forward_flops(widths(m), t.context["tile_in"], m["in_channels"],
                                    m["num_classes"])
    return 100.0 * t.counters["crops"] * flops / (t.window_s * costs.PEAK_OPS_PER_S["bf16"])
