"""k1_roofline: the calls into K1 (models/unet.py's conv3x3_bias_relu, the
span 'k1') as a share of their roofline: the sum of each call's bound
(costs.conv_cost from its shapes: x, the HWIO kernel, the bias) over the
device time of the operations launched inside the calls."""

from benchmarks import costs

SIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def read(t):
    calls = t.calls.get("k1")
    device_s = t.span_device_s("k1")
    if not calls or device_s <= 0:
        return None
    bound = 0.0
    for (x, xd), (w, _), (_, bd) in calls:
        nbytes, ops = costs.conv_cost(x[0], x[1], x[2], x[3], w[3], SIZE[xd], SIZE[xd], SIZE[bd])
        bound += costs.bound_s(nbytes, ops, "bf16" if xd == "bfloat16" else "f32")
    return 100.0 * bound / device_s
