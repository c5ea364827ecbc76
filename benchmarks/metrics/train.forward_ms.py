"""train.forward_ms: device milliseconds per training step of the forward
and its crop (train/trainer.py's span 'train.forward')."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("train.forward",), "steps")
