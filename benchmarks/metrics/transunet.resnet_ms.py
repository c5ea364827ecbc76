"""transunet.resnet_ms: device milliseconds per request of TransUNet's
ResNet-50 trunk (models/transunet.py's span 'transunet.resnet': the input's
cast, the weight-standardised convs, GroupNorms, ReLUs, the max-pool and
the residual adds)."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("transunet.resnet",), "requests")
