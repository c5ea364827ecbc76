"""mfu.serve_transunet: the model operations of TransUNet served in
bfloat16, over the traced window, as a share of the card's bf16 peak:
slices x the forward's operations per slice (costs_transunet.forward_flops)
/ (window x peak x cards)."""

from benchmarks import costs, costs_transunet


def read(t):
    m = t.context.get("model", {})
    if t.context.get("precision") != "bfloat16" or "resnet_units" not in m \
            or "tiles" not in t.counters or t.busy_s <= 0:
        return None
    flops = costs_transunet.forward_flops(m)["total"]
    peak = costs.PEAK_OPS_PER_S["bf16"] * t.counters["chips"]
    return 100.0 * t.counters["tiles"] * flops / (t.window_s * peak)
