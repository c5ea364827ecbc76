"""k3_roofline: the calls into K3 (infer/quant.py's conv3x3_fused, the span
'k3') as a share of their roofline: the sum of each call's bound
(costs.conv_cost: int8 x and kernel, f32 alpha and beta per output
channel, int8 out) over the device time of the operations launched inside
the calls."""

from benchmarks import costs


def read(t):
    calls = t.calls.get("k3")
    device_s = t.span_device_s("k3")
    if not calls or device_s <= 0:
        return None
    bound = 0.0
    for (x, _), (w, _), *_ in calls:
        nbytes, ops = costs.conv_cost(x[0], x[1], x[2], x[3], w[3], 1, 1, 8)
        bound += costs.bound_s(nbytes, ops, "int8")
    return 100.0 * bound / device_s
