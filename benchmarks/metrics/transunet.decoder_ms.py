"""transunet.decoder_ms: device milliseconds per request of TransUNet's
decoder (models/transunet.py's span 'transunet.decoder': the bilinear
upsamples, the bordered concats, the head), with the 3x3 conv + BN + ReLU
layers inside it added back: the benchmark's span 'k1' owns their
operations."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("transunet.decoder", "k1"), "requests")
