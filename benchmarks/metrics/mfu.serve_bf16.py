"""mfu.serve_bf16: the model operations of a configuration served in bfloat16
(its `precision`), over the traced window, as a share of the cards' bf16
peak: real tiles x the forward's operations per tile
(costs.forward_flops) / (window x peak x cards)."""

from benchmarks import costs
from benchmarks.reference.unet import widths


def read(t):
    if t.context.get("precision") != "bfloat16" or "tiles" not in t.counters or t.busy_s <= 0:
        return None
    m = t.context["model"]
    flops = costs.forward_flops(widths(m), t.context["tile_in"], m["in_channels"],
                                m["num_classes"])
    peak = costs.PEAK_OPS_PER_S["bf16"] * t.counters["chips"]
    return 100.0 * t.counters["tiles"] * flops / (t.window_s * peak)
