"""quant.float_ms: device milliseconds per request of the int8 tier's float
layers (infer/quant.py's span 'quant.float': the 3x3 convs left in float
with their permutes, bias and cast, the upconvs and the head)."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("quant.float",), "requests")
