"""quant.convert_ms: device milliseconds per request of the int8 tier's
changes of encoding (infer/quant.py's span 'quant.convert': quantize,
dequantize, requantize, the copy before K3, the skips captured quantized
and the int8 concats)."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("quant.convert",), "requests")
