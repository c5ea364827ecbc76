"""transunet.vit_ms: device milliseconds per request of TransUNet's ViT
(models/transunet.py's span 'transunet.vit': the patch linear and position
table, the 12 blocks' LayerNorms, linears, GELU and residual adds, the
final LayerNorm), with the attention calls inside it added back: the
benchmark's span 'attn' owns their operations."""

from benchmarks.program_spans import device_ms


def read(t):
    return device_ms(t, ("transunet.vit", "attn"), "requests")
