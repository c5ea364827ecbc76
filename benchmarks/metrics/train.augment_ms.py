"""train.augment_ms: device milliseconds per training step of the
augmentation pipeline (data/augment.py's AugmentPipeline, the span
'augment')."""


def read(t):
    steps, device_s = t.counters.get("steps"), t.span_device_s("augment")
    if not steps or device_s <= 0:
        return None
    return 1e3 * device_s / steps
