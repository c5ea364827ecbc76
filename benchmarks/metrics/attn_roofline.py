"""attn_roofline: the calls into models/transunet.py's `attention` (the
span 'attn') as a share of their roofline: the sum of each call's bound
(costs_transunet.attention_cost from q's shape: q, k, v read and the output
written once, 4 B H N^2 d operations) over the device time of the
operations launched inside the calls."""

from benchmarks import costs_transunet


def read(t):
    calls = t.calls.get("attn")
    device_s = t.span_device_s("attn")
    if not calls or device_s <= 0:
        return None
    bound = sum(costs_transunet.attention_bound_s(q, qd) for (q, qd), *_ in calls)
    return 100.0 * bound / device_s
