"""train.weights_ms: device milliseconds per training step of the weight
maps (losses/weights.py's distance map: connected components and K2's
EDT, the span 'weights')."""


def read(t):
    steps, device_s = t.counters.get("steps"), t.span_device_s("weights")
    if not steps or device_s <= 0:
        return None
    return 1e3 * device_s / steps
